"""Port parity, nearest-code search: ``imagefolder_tpu_torch.ops.cuda.codebook``
(its plain version, which a CPU tensor takes) against the JAX
``codebook_argmin`` run through Pallas's interpreter and against the JAX
quantizer's ``_codebook_lookup``, on the same numpy-seeded inputs.

Indices must be equal, ties included: both sides take the first occurrence
(Pallas within a tile by argmin and across tiles by a strict <). The JAX
tiles are cut small here so that N and V fall off their edges.

Also a numpy model of the card kernel's split-and-merge (``split_argmin``):
the codebook cut into S code ranges of whole 256-code tiles, each scanned in
increasing code order with a strict <, and the ranges' (best, index) pairs
merged in rank order by value, then index. It is held against the Pallas
kernel at the 256 px scales, with codebook rows planted twice across the
range boundaries, with a +0.0 / -0.0 tie, off the tile and at every width
the kernel is built for.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagefolder_tpu.ops import quantize as jax_quantize
from imagefolder_tpu.ops.pallas.codebook import codebook_argmin as jax_codebook_argmin
from imagefolder_tpu_torch.ops import quantize as pt_quantize
from imagefolder_tpu_torch.ops.cuda import codebook as pt_codebook
from tests._torch_parity import one_torch_thread  # noqa: F401


def _data(n, v, c, seed=0, normed=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    cb = rng.normal(size=(v, c)).astype(np.float32)
    if normed:
        x /= np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12
        cb /= np.linalg.norm(cb, axis=-1, keepdims=True) + 1e-12
    return x, cb


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("n,v,c", [(300, 100, 32), (37, 517, 8), (64, 4096, 32),
                                   (9, 33, 64), (70, 300, 192)])
def test_matches_pallas_interpret(n, v, c, maximize):
    x, cb = _data(n, v, c, seed=n + v, normed=maximize)
    want = jax_codebook_argmin(jnp.asarray(x), jnp.asarray(cb), maximize=maximize,
                               tile_n=64, tile_v=128, interpret=True)
    got = pt_codebook.codebook_argmin(torch.from_numpy(x), torch.from_numpy(cb),
                                      maximize=maximize)
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("maximize", [False, True])
def test_first_occurrence_on_duplicated_codes(maximize):
    """A codebook holding every code twice: each row's winner is the first
    copy, as in the Pallas kernel (whose tiles here split the copies)."""
    x, cb = _data(50, 48, 16, seed=5, normed=maximize)
    cb = np.concatenate([cb, cb, cb[:7]])
    want = jax_codebook_argmin(jnp.asarray(x), jnp.asarray(cb), maximize=maximize,
                               tile_n=16, tile_v=32, interpret=True)
    got = pt_codebook.codebook_argmin(torch.from_numpy(x), torch.from_numpy(cb),
                                      maximize=maximize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < 48


@pytest.mark.parametrize("znorm", [False, True])
def test_codebook_lookup_matches_jax(znorm):
    """The quantizer's lookup: the cosine argmax over L2-normalised rows
    (znorm) or the squared-L2 argmin, on un-normalised inputs."""
    x, cb = _data(121, 257, 32, seed=11)
    x *= 3.0
    want = jax_quantize._codebook_lookup(jnp.asarray(x), jnp.asarray(cb), znorm)
    got = pt_quantize._codebook_lookup(torch.from_numpy(x), torch.from_numpy(cb), znorm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_dispatch_counts_nothing():
    x, cb = (torch.from_numpy(t) for t in _data(10, 20, 8))
    before = pt_codebook.LAUNCHES
    got = pt_codebook.codebook_argmin(x, cb)
    torch.testing.assert_close(got, pt_codebook.codebook_argmin_reference(x, cb))
    assert pt_codebook.LAUNCHES == before


def test_ready_copies_only_what_the_kernel_cannot_read():
    """The kernel copies rows in 16-byte chunks: ``_ready`` hands it a
    contiguous fp32 tensor on a 16-byte boundary, copying a view whose base
    is off one (or a bf16 or strided one), and passing an aligned one on."""
    x = torch.from_numpy(_data(10, 20, 8)[0])
    off = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(10, 8)
    assert off.data_ptr() % 16 != 0
    for t in (off, x.bfloat16(), x.t()):
        got = pt_codebook._ready(t)
        assert got.is_contiguous() and got.dtype == torch.float32 and got.data_ptr() % 16 == 0
        assert torch.equal(got, t.float())
    assert pt_codebook._ready(x) is x


def test_rejects_bad_shapes_and_devices():
    x, cb = (torch.from_numpy(t) for t in _data(10, 20, 8))
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x, cb[:, :4])
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x, cb[:0])
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x.to("meta"), cb.to("meta"))


CODES = 256  # codes per tile of the card kernel's scan; a range is whole tiles
PNS = (1, 1, 2, 3, 3, 4, 5, 6, 8, 11)  # the 256 px scales


def kernel_scores(x: np.ndarray, cb: np.ndarray, maximize: bool) -> np.ndarray:
    """The kernel's fp32 scores: |e|^2 - 2 x.e, or -2 x.e when maximizing."""
    dots = (x.astype(np.float32) @ cb.astype(np.float32).T).astype(np.float32)
    base = np.float32(0) if maximize else np.square(cb).sum(-1, dtype=np.float32)
    return (base - np.float32(2) * dots).astype(np.float32)


def split_argmin(scores: np.ndarray, split: int) -> np.ndarray:
    """The card kernel's search over an (N, V) fp32 score matrix: S = split
    code ranges of v_per = ceil(V / S) codes rounded up to whole tiles (the
    last ones may be short or empty), each scanned in increasing code order
    with a strict <; then rank 0 takes each rank that holds codes, in rank
    order, where its (value, index) is smaller."""
    n, v = scores.shape
    v_per = -(-(-(-v // split)) // CODES) * CODES
    ranks = []
    for r in range(split):
        lo, hi = r * v_per, min(v, (r + 1) * v_per)
        if lo >= hi:
            ranks.append((np.full(n, np.inf, np.float32), np.zeros(n, np.int64)))
            continue
        # a strict < over codes in increasing order keeps the first of equal
        # scores: argmin's first occurrence (no NaN here)
        arg = lo + np.argmin(scores[:, lo:hi], axis=1)
        ranks.append((scores[np.arange(n), arg], arg))
    best, arg = ranks[0]
    for r in range(1, split):
        if r * v_per >= v:  # an empty range
            continue
        ob, oa = ranks[r]
        take = (ob < best) | ((ob == best) & (oa < arg))
        best, arg = np.where(take, ob, best), np.where(take, oa, arg)
    return arg


def _pallas(x, cb, maximize):
    return np.asarray(jax_codebook_argmin(jnp.asarray(x), jnp.asarray(cb), maximize=maximize,
                                          tile_n=64, tile_v=512, interpret=True))


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("pn", sorted(set(PNS)))
def test_split_model_matches_pallas_at_256px_scales(pn, maximize):
    """Each 256 px scale at B=2 (N = 2 pn^2) against a 4096 x 32 book: the
    model at every split the kernel takes (1, 2, 4, 8 code ranges) gives the
    Pallas kernel's indices."""
    x, cb = _data(2 * pn * pn, 4096, 32, seed=pn, normed=maximize)
    want = _pallas(x, cb, maximize)
    scores = kernel_scores(x, cb, maximize)
    for split in (1, 2, 4, 8):
        np.testing.assert_array_equal(split_argmin(scores, split), want, err_msg=f"S={split}")


@pytest.mark.parametrize("maximize", [True, False])
def test_split_model_first_copy_across_range_boundaries(maximize):
    """Codebook rows planted twice, the copies straddling the boundary of
    two code ranges at S = 8 (512 codes a range), 4 (1024) and 2 (2048),
    and one pair far apart: rows sitting on a planted pair take its first
    copy at every split, as the Pallas kernel and the plain version do."""
    pairs = ((511, 512), (1023, 1024), (2047, 2048), (100, 3000))
    x, cb = _data(40, 4096, 32, seed=21)
    for i, (a, b) in enumerate(pairs):
        cb[b] = cb[a]
        x[i] = cb[a] + 1e-3 * x[i]
    if maximize:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    want = _pallas(x, cb, maximize)
    plain = pt_codebook.codebook_argmin_reference(torch.from_numpy(x), torch.from_numpy(cb),
                                                  maximize).numpy()
    np.testing.assert_array_equal(want[:len(pairs)], [a for a, _ in pairs])
    np.testing.assert_array_equal(plain, want)
    scores = kernel_scores(x, cb, maximize)
    for split in (1, 2, 4, 8):
        np.testing.assert_array_equal(split_argmin(scores, split), want, err_msg=f"S={split}")


@pytest.mark.parametrize("low,high", [(-0.0, 0.0), (0.0, -0.0)])
def test_split_model_plus_minus_zero_tie(low, high):
    """A row whose best score is 0, held as -0.0 by one code and +0.0 by
    another in a later range (the plain version writes -2 x.e, which is
    -0.0 where the kernel's base - 2 acc is +0.0): the two compare equal,
    so the lower index wins at every split, as torch.argmin picks it."""
    scores = np.abs(np.random.default_rng(3).normal(size=(3, 4096))).astype(np.float32) + 1
    scores[:, 700] = low
    scores[:, 3000] = high
    want = torch.argmin(torch.from_numpy(scores), dim=-1).numpy()
    assert (want == 700).all()
    for split in (1, 2, 4, 8):
        np.testing.assert_array_equal(split_argmin(scores, split), want, err_msg=f"S={split}")


@pytest.mark.parametrize("v,c", [(4000, 32), (1000, 8), (520, 16), (33, 64), (4096, 64)])
def test_split_model_off_the_tile_and_widths(v, c):
    """V off the 256-code tile (4000, 1000), a split that leaves the last
    range empty (V = 520 at S = 4 and 8: ranges of 256 codes), a book
    shorter than a tile, and each width the kernel is built for: the model
    gives the Pallas kernel's indices."""
    x, cb = _data(70, v, c, seed=v + c, normed=True)
    want = _pallas(x, cb, True)
    scores = kernel_scores(x, cb, True)
    for split in (1, 2, 4, 8):
        np.testing.assert_array_equal(split_argmin(scores, split), want, err_msg=f"S={split}")
