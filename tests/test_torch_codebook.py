"""Port parity, nearest-code search: ``imagefolder_tpu_torch.ops.cuda.codebook``
(its plain version, which a CPU tensor takes) against the JAX
``codebook_argmin`` run through Pallas's interpreter and against the JAX
quantizer's ``_codebook_lookup``, on the same numpy-seeded inputs.

Indices must be equal, ties included: both sides take the first occurrence
(Pallas within a tile by argmin and across tiles by a strict <). The JAX
tiles are cut small here so that N and V fall off their edges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagefolder_tpu.ops import quantize as jax_quantize
from imagefolder_tpu.ops.pallas.codebook import codebook_argmin as jax_codebook_argmin
from imagefolder_tpu_torch.ops import quantize as pt_quantize
from imagefolder_tpu_torch.ops.cuda import codebook as pt_codebook


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
                                   (9, 33, 64)])
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


def test_rejects_bad_shapes_and_devices():
    x, cb = (torch.from_numpy(t) for t in _data(10, 20, 8))
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x, cb[:, :4])
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x, cb[:0])
    with pytest.raises(ValueError):
        pt_codebook.codebook_argmin(x.to("meta"), cb.to("meta"))
