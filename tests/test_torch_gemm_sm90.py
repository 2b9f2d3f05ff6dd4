"""The fused sublayers' GEMM on Hopper (``csrc/gemm_epilogue.cuh``:
``gemm_sm90_kernel``, under #7 ``attn_sublayer_fused``, #8
``mlp_sublayer_fused`` and #10 ``fused_mlp``), modelled on the CPU and held
against the JAX package.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain versions. Here plain models of its algorithm stand in:
- the numerics: the persistent schedule's 128 x BN output tiles (BN = 256
  where N % 256 == 0, else 128), each summed over 64-wide k-tiles in fp32,
  then the epilogue's roundings (``round(round(acc) + round(b))`` for the
  Dense layers, GELU with erf in fp32, fp32 ``res + ls * y``; #10's fp32
  biases on the fp32 sums), with #7's attention step as #1's one-pass tile
  model. They run the same numpy-seeded inputs as ``_attn_sublayer_fused``
  and ``_mlp_sublayer_fused`` in Pallas's interpreter and as scripts/perf.py's
  ``fused_mlp`` (transcribed into a ``pallas_call`` in the interpreter), at
  widths that are multiples of 64 with a ragged M, under ``chip_smoke.py``'s
  bounds (``_sublayer_check`` for #7 and #8; 2^-7 |plain| + 2^-5 RMS(row)
  for #10);
- the schedule: every (m-tile, n-tile) visited exactly once at the main
  paths' shapes with grid = min(tiles, 132);
- the ring: the producer's and the two consumers' full/empty mbarrier
  protocol (stage index and phase parity) across tiles, under random
  interleavings;
- planted faults that must fail: a stage released before its products have
  read it (so that it is refilled one round early and read as k-tile kt +
  stages), a full barrier waited for with the wrong parity, the last
  k-tile dropped, and the last column tile left unstored at N = 384.
A check that the model's constants are the kernel's reads them from the
header.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import chip_smoke as cs
from imagefolder_tpu.ops.activations import gelu_exact as jax_gelu_exact
from imagefolder_tpu.ops.pallas.block import _attn_sublayer_fused, _mlp_sublayer_fused
from imagefolder_tpu_torch.ops.activations import gelu_exact
from test_torch_fwd_sm90_onepass import onepass_model
from tests._torch_parity import one_torch_thread  # noqa: F401


HEADER = Path(__file__).resolve().parents[1] / "imagefolder_tpu_torch/csrc/gemm_epilogue.cuh"
BM, BK = 128, 64       # the block's output rows; the k-tile
# the ring, stages of (BM + BN) x BK bf16: for the fp32 output of
# kDenseLsRes, and beside the staging of the bf16 outputs' TMA stores
RING_BYTES = {"fp32 out": 196608, "bf16 out": 147456}
SMS = 132              # an H100's SMs: the grid is min(tiles, SMS)
DENSE, DENSE_GELU, DENSE_LS_RES, BIAS32_GELU, BIAS32 = range(5)


def tile_n(n: int) -> int:
    return 256 if n % 256 == 0 else 128


def stages(bn: int, out: str) -> int:
    return RING_BYTES[out] // ((BM + bn) * BK * 2)


def schedule(m: int, n: int, sms: int = SMS) -> list[list[tuple[int, int]]]:
    """Each block's (m-tile, n-tile) in the order it walks them: tile t =
    block + i * grid, m-tile t // nN, n-tile t % nN."""
    nn = -(-n // tile_n(n))
    tiles = -(-m // BM) * nn
    grid = min(tiles, sms)
    return [[(t // nn, t % nn) for t in range(b, tiles, grid)] for b in range(grid)]


# --------------------------------- numerics -------------------------------- #

def epilogue(kind, acc, b, s=None, r=None):
    """``epi_value`` on a tile's fp32 sums: bias, GELU (erf in fp32),
    LayerScale and residual with the kernel's roundings."""
    bf = torch.bfloat16
    if kind in (BIAS32_GELU, BIAS32):
        t = acc + b.float()
        return (gelu_exact(t) if kind == BIAS32_GELU else t).to(bf)
    y = (acc.to(bf).float() + b.to(bf).float()).to(bf)
    if kind == DENSE:
        return y
    if kind == DENSE_GELU:
        return gelu_exact(y.float()).to(bf)
    return r.float() + s * y.float()


def gemm_model(x, w, kind, b, s=None, res=None, fault=None):
    """y = x W^T (x (M, K) and W (N, K) bf16) with epilogue ``kind``, tile
    by tile in the persistent schedule's order; an element never stored
    stays NaN."""
    m, k = x.shape
    n = w.shape[0]
    bn = tile_n(n)
    out = torch.full((m, n), float("nan"),
                     dtype=torch.float32 if kind == DENSE_LS_RES else torch.bfloat16)
    nk = k // BK
    for block in schedule(m, n):
        for mt, nt in block:
            rows = slice(mt * BM, min(m, mt * BM + BM))
            cols = slice(nt * bn, min(n, nt * bn + bn))
            acc = torch.zeros((rows.stop - rows.start, cols.stop - cols.start))
            for kt in range(nk - (fault == "last k-tile dropped")):
                ks = slice(kt * BK, kt * BK + BK)
                acc += x[rows, ks].float() @ w[cols, ks].float().T
            if fault == "last column tile unstored" and nt == -(-n // bn) - 1:
                continue
            out[rows, cols] = epilogue(kind, acc, b[cols], None if s is None else s[cols],
                                       None if res is None else res[rows, cols])
    return out


def attn_model(xn, res, wq, bq, wp, bp, ls, heads, fault=None):
    """#7: the qkv GEMM (kDense), #1's one-pass attention tiles, the proj
    GEMM (kDenseLsRes); xn (B, N, C) bf16, weights (out, in)."""
    b, n, c = xn.shape
    bf = torch.bfloat16
    qkv = gemm_model(xn.reshape(b * n, c), wq.to(bf), DENSE, bq)
    qkv = qkv.view(b, n, 3, heads, c // heads)
    o, _ = onepass_model(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, (c // heads) ** -0.5)
    y = gemm_model(o.reshape(b * n, c), wp.to(bf), DENSE_LS_RES, bp, ls,
                   res.reshape(b * n, c), fault)
    return y.view(b, n, c)


def mlp_model(xn, res, w1, b1, w2, b2, ls, fault=None):
    """#8: fc1 (kDenseGelu) and fc2 (kDenseLsRes)."""
    b, n, c = xn.shape
    bf = torch.bfloat16
    h = gemm_model(xn.reshape(b * n, c), w1.to(bf), DENSE_GELU, b1)
    y = gemm_model(h, w2.to(bf), DENSE_LS_RES, b2, ls, res.reshape(b * n, c), fault)
    return y.view(b, n, c)


def fused_mlp_model(x, w1, b1, w2, b2, fault=None):
    """#10: kBias32Gelu, then kBias32."""
    h = gemm_model(x, w1, BIAS32_GELU, b1)
    return gemm_model(h, w2, BIAS32, b2, fault=fault)


def _sublayer_params(seed, b, n, c, hidden):
    """xn, res and one sublayer's parameters in the flax (in, out) layout as
    numpy fp32, LayerScale of order 1 so that the sublayer moves the
    output."""
    rng = np.random.default_rng(seed)
    c2 = c if hidden == 3 * c else hidden
    f32 = np.float32
    return {"xn": rng.normal(size=(b, n, c)).astype(f32),
            "res": rng.normal(size=(b, n, c)).astype(f32),
            "w1": rng.uniform(-c ** -0.5, c ** -0.5, (c, hidden)).astype(f32),
            "b1": rng.normal(0, 0.1, hidden).astype(f32),
            "w2": rng.uniform(-c2 ** -0.5, c2 ** -0.5, (c2, c)).astype(f32),
            "b2": rng.normal(0, 0.1, c).astype(f32),
            "ls": rng.uniform(0.5, 1.0, c).astype(f32)}


def _torch_args(p):
    """The same parameters for the port: xn bf16, weights (out, in)."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return (t["xn"].bfloat16(), t["res"], t["w1"].T.contiguous(), t["b1"],
            t["w2"].T.contiguous(), t["b2"], t["ls"])


# (B, N, C, heads): C = 128 puts qkv (N = 384) and proj on BN = 128; C = 256
# puts them on BN = 256; C = 384 is ViT-S's width with three column tiles
ATTN_CASES = {"C=128": (2, 37, 128, 2), "C=256": (2, 37, 256, 4), "C=384": (1, 21, 384, 6)}


def _jax_attn(p, heads):
    bf = jnp.bfloat16
    return np.asarray(_attn_sublayer_fused(
        jnp.asarray(p["xn"], bf), jnp.asarray(p["res"]), jnp.asarray(p["w1"], bf),
        jnp.asarray(p["b1"]), jnp.asarray(p["w2"], bf), jnp.asarray(p["b2"]),
        jnp.asarray(p["ls"]), heads=heads, interpret=True))


_JAX_CACHE = {}


def _attn_case(name):
    if name not in _JAX_CACHE:
        b, n, c, h = ATTN_CASES[name]
        p = _sublayer_params(10, b, n, c, 3 * c)
        _JAX_CACHE[name] = (p, np.array(_jax_attn(p, h)))
    return _JAX_CACHE[name]


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attn_sublayer_gemm_model_matches_pallas(name):
    p, want = _attn_case(name)
    args = _torch_args(p)
    got = attn_model(*args, ATTN_CASES[name][3])
    assert not torch.isnan(got).any()
    cs._sublayer_check(f"#7 {name}", got, torch.from_numpy(want), args[1], args[-1],
                       torch.bfloat16)


# (B, N, C, hidden): fc1 on BN = 256 (hidden 512) and fc2 on BN = 128 (C =
# 128); ViT-S's C = 384 (fc2's three column tiles)
MLP_CASES = {"C=128": (2, 37, 128, 512), "C=384": (1, 21, 384, 256)}


def _mlp_case(name):
    key = "mlp " + name
    if key not in _JAX_CACHE:
        b, n, c, hid = MLP_CASES[name]
        p = _sublayer_params(11, b, n, c, hid)
        bf = jnp.bfloat16
        want = np.array(_mlp_sublayer_fused(
            jnp.asarray(p["xn"], bf), jnp.asarray(p["res"]), jnp.asarray(p["w1"], bf),
            jnp.asarray(p["b1"]), jnp.asarray(p["w2"], bf), jnp.asarray(p["b2"]),
            jnp.asarray(p["ls"]), blk=8, interpret=True))
        _JAX_CACHE[key] = (p, want)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_mlp_sublayer_gemm_model_matches_pallas(name):
    p, want = _mlp_case(name)
    args = _torch_args(p)
    got = mlp_model(*args)
    assert not torch.isnan(got).any()
    cs._sublayer_check(f"#8 {name}", got, torch.from_numpy(want), args[1], args[-1],
                       torch.bfloat16)


def perf_fused_mlp(x, w1, b1, w2, b2, blk):
    """scripts/perf.py's ``fused_mlp`` (its kernel body ``_mlp_kernel``,
    perf.py:241-249, and its ``pallas_call``, perf.py:252-274) transcribed
    and run in Pallas's interpreter: it is nested in ``probe_mlp`` and cannot
    be imported. ``gelu_exact`` on fp32 is perf.py's ``_gelu_exact`` (the
    same A&S erf); the TPU memory spaces are dropped."""
    def kernel(x_ref, w1_ref, b1_ref, w2_ref, b2_ref, o_ref):
        xb = x_ref[...]
        h = jax.lax.dot_general(xb, w1_ref[...], (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        h = jax_gelu_exact(h + b1_ref[...]).astype(xb.dtype)
        o = jax.lax.dot_general(h, w2_ref[...], (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        o_ref[...] = (o + b2_ref[...]).astype(o_ref.dtype)

    bn, d = x.shape
    hid = w1.shape[1]
    return pl.pallas_call(
        kernel, grid=(-(-bn // blk),),
        in_specs=[pl.BlockSpec((blk, d), lambda i: (i, 0)),
                  pl.BlockSpec((d, hid), lambda i: (0, 0)),
                  pl.BlockSpec((hid,), lambda i: (0,)),
                  pl.BlockSpec((hid, d), lambda i: (0, 0)),
                  pl.BlockSpec((d,), lambda i: (0,))],
        out_specs=pl.BlockSpec((blk, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((bn, d), x.dtype), interpret=True)(x, w1, b1, w2, b2)


# (M, D, hidden): ragged M; fc1 on BN = 256, fc2 on BN = 128 (D = 128) or
# three column tiles (D = 384)
FUSED_MLP_CASES = {"D=128": (77, 128, 256), "D=384": (45, 384, 256)}


def _fused_mlp_case(name):
    key = "fused " + name
    if key not in _JAX_CACHE:
        m, d, hid = FUSED_MLP_CASES[name]
        rng = np.random.default_rng(12)
        p = {"x": rng.normal(size=(m, d)).astype(np.float32),
             "w1": (rng.normal(size=(d, hid)) * 0.1).astype(np.float32),
             "b1": rng.normal(0, 0.1, hid).astype(np.float32),
             "w2": (rng.normal(size=(hid, d)) * 0.1).astype(np.float32),
             "b2": rng.normal(0, 0.1, d).astype(np.float32)}
        bf = jnp.bfloat16
        want = np.array(perf_fused_mlp(
            jnp.asarray(p["x"], bf), jnp.asarray(p["w1"], bf), jnp.asarray(p["b1"]),
            jnp.asarray(p["w2"], bf), jnp.asarray(p["b2"]), blk=32).astype(jnp.float32))
        _JAX_CACHE[key] = (p, want)
    return _JAX_CACHE[key]


def _fused_mlp_args(p):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return (t["x"].bfloat16(), t["w1"].T.contiguous().bfloat16(), t["b1"],
            t["w2"].T.contiguous().bfloat16(), t["b2"])


def check_fused_mlp(got: torch.Tensor, want: np.ndarray):
    """``chip_smoke.py``'s bf16 bound of #10: per element 2^-7 |plain| +
    2^-5 RMS(plain's row), one rounding of o and rounding flips of h."""
    got = got.float().numpy()
    assert np.isfinite(got).all(), "non-finite or unstored elements"
    rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
    worst = float(np.max(np.abs(got - want) / (cs.BF16_REL * np.abs(want) + cs.ROW_SHARE * rms)))
    assert worst <= 1.0, f"an element's error is {worst:.3f} of its bound"
    return worst


@pytest.mark.parametrize("name", list(FUSED_MLP_CASES))
def test_fused_mlp_gemm_model_matches_pallas(name):
    p, want = _fused_mlp_case(name)
    worst = check_fused_mlp(fused_mlp_model(*_fused_mlp_args(p)), want)
    assert worst <= 0.75  # a margin under the bound


@pytest.mark.parametrize("fault", ["last k-tile dropped", "last column tile unstored"])
@pytest.mark.parametrize("kind", ["#7", "#8", "#10"])
def test_planted_gemm_fault_fails_the_check(kind, fault):
    """The check has teeth: the last 64-wide k-tile dropped, or the last
    column tile (columns 256-383 at N = 384, ViT-S's width) unstored, in
    the GEMM that writes the sublayer's output."""
    if kind == "#10":
        p, want = _fused_mlp_case("D=384")
        with pytest.raises(AssertionError):
            check_fused_mlp(fused_mlp_model(*_fused_mlp_args(p), fault=fault), want)
        return
    if kind == "#7":
        p, want = _attn_case("C=384")
        args = _torch_args(p)
        got = attn_model(*args, ATTN_CASES["C=384"][3], fault=fault)
    else:
        p, want = _mlp_case("C=384")
        args = _torch_args(p)
        got = mlp_model(*args, fault=fault)
    got = torch.nan_to_num(got, nan=0.0)  # an unstored element holds what was there
    with pytest.raises(AssertionError, match="of its bound"):
        cs._sublayer_check(kind, got, torch.from_numpy(want), args[1], args[-1],
                           torch.bfloat16)


# --------------------------------- schedule -------------------------------- #

@pytest.mark.parametrize("n", [384, 768, 1152, 1536, 2304, 3072])
@pytest.mark.parametrize("m", [32896, 32832, 24256, 111, 77])
def test_persistent_schedule_visits_every_tile_once(m, n):
    blocks = schedule(m, n)
    nn = -(-n // tile_n(n))
    tiles = -(-m // BM) * nn
    assert len(blocks) == min(tiles, SMS)
    visited = [tile for block in blocks for tile in block]
    assert len(visited) == len(set(visited)) == tiles
    assert set(visited) == {(mt, nt) for mt in range(-(-m // BM)) for nt in range(nn)}
    # the blocks in flight at once work on neighbouring row blocks
    first = [block[0] for block in blocks]
    assert max(mt for mt, _ in first) - min(mt for mt, _ in first) <= -(-len(blocks) // nn)


def test_model_constants_are_the_kernels():
    """The constants and formulas the models use, read from the header."""
    src = HEADER.read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kBM"], const["kBK"], const["kConsumers"]) == (BM, BK, 2)
    ring = re.search(r"ring_bytes\(\) \{ return store_tma<kEpi>\(\) \? (\d+) : (\d+); \}", src)
    assert tuple(map(int, ring.groups())) == (RING_BYTES["bf16 out"], RING_BYTES["fp32 out"])
    assert "constexpr bool store_tma() { return kEpi != kDenseLsRes; }" in src
    assert [stages(bn, "fp32 out") for bn in (256, 128)] == [4, 6]
    assert [stages(bn, "bf16 out") for bn in (256, 128)] == [3, 4]
    assert "n % 256 ? launch_gemm_sm90<kId, kEpi, 128>" in src  # tile_n
    assert "blockIdx.x + i * gridDim.x" in src and "t / nn * kBM, n0 = t % nn * kBN" in src
    assert "tiles < sms ? tiles : sms" in src  # the grid
    # the parities of ring_model's waits
    assert "mbar_wait(empty + 8 * s, (round & 1) ^ 1)" in src
    assert src.count("mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1)") == 2
    assert "int it = i * nk;" in src


# ----------------------------------- ring ---------------------------------- #

class MBarrier:
    """An mbarrier: ``count`` arrivals and the expected bytes complete a
    phase; ``phase`` counts the completed phases. try_wait.parity(p)
    passes once the phase of parity p has completed, i.e. while the current
    (incomplete) phase's parity is not p."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _settle(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, n=1):
        self.pending -= n
        assert self.pending >= 0, "more arrivals than the barrier's count"
        self._settle()

    def expect_tx(self, nbytes):
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._settle()

    def passes(self, parity):
        return (self.phase & 1) != parity


def ring_model(tiles: int, nk: int, n_stages: int, seed: int, fault=None):
    """The kernel's producer and two consumers on one block's ``tiles``
    tiles of ``nk`` k-tiles, as generators stepped in a random order (with
    the TMA copies landing at random later times). Asserts that every
    wait's parity matches the phase it waits for, that each product reads
    the k-tile it expects, that no stage is refilled while a consumer's
    products may still read it, and that the run ends. ``fault``: "early
    release" releases a stage as soon as its products are issued; "full
    parity flipped" waits on a full barrier with the other parity."""
    rng = random.Random(seed)
    full = [MBarrier(1) for _ in range(n_stages)]
    empty = [MBarrier(2 * 128) for _ in range(n_stages)]  # every consumer thread
    stage = [None] * n_stages      # the (tile, k-tile) a stage holds
    inflight = [set() for _ in range(n_stages)]  # consumers whose products may read it
    landing = []                   # copies in flight: (stage, (tile, k-tile))

    def wait(bar, parity, completed):
        while not bar.passes(parity):
            yield
        assert bar.phase == completed, "a wait passed on another round's phase"

    def producer():
        it = 0
        for i in range(tiles):
            for kt in range(nk):
                s, rnd = it % n_stages, it // n_stages
                yield from wait(empty[s], (rnd & 1) ^ 1, rnd)
                full[s].expect_tx(1)
                landing.append((s, (i, kt)))
                it += 1

    def consumer(c):
        early, flip = fault == "early release", fault == "full parity flipped"
        for i in range(tiles):
            it = i * nk
            prev = None
            for kt in range(nk):
                s, rnd = it % n_stages, it // n_stages
                if flip:
                    while not full[s].passes((rnd & 1) ^ 1):
                        yield
                else:
                    yield from wait(full[s], rnd & 1, rnd + 1)
                assert stage[s] == (i, kt), f"read k-tile {stage[s]}, want {(i, kt)}"
                inflight[s].add(c)
                if early:
                    empty[s].arrive(128)
                yield  # the products run
                if prev is not None:  # wgmma.wait_group 1: the previous k-tile's are done
                    assert stage[prev] == (i, kt - 1), "a stage changed under its products"
                    inflight[prev].discard(c)
                    if not early:
                        empty[prev].arrive(128)
                prev = s
                it += 1
            assert stage[prev] == (i, nk - 1), "a stage changed under its products"
            inflight[prev].discard(c)  # wgmma.wait_group 0
            if not early:
                empty[prev].arrive(128)
            yield  # the epilogue

    def copies():
        while True:
            if landing and rng.random() < 0.5:
                s, what = landing.pop(rng.randrange(len(landing)))
                assert not inflight[s], f"stage {s} refilled while its products read it"
                stage[s] = what
                full[s].complete_tx(1)
            yield

    actors = {"producer": producer(), "consumer 0": consumer(0), "consumer 1": consumer(1)}
    tma = copies()
    for _ in range(200000):
        if not actors:
            assert not landing
            return
        next(tma)
        name = rng.choice(sorted(actors))
        try:
            next(actors[name])
        except StopIteration:
            del actors[name]
    raise AssertionError("the ring deadlocked")


# (tiles, k-tiles, stages): the kernel's stage counts (3, 4 and 6) at K =
# 768 (12 k-tiles) and 3072 (48), and fewer k-tiles than stages
RING_CASES = [(5, 12, 4), (4, 12, 3), (3, 12, 6), (3, 48, 4), (3, 1, 4), (4, 3, 6), (3, 2, 3)]


@pytest.mark.parametrize("tiles,nk,n_stages", RING_CASES)
def test_ring_protocol_holds(tiles, nk, n_stages):
    for seed in range(40):
        ring_model(tiles, nk, n_stages, seed)


@pytest.mark.parametrize("fault", ["early release", "full parity flipped"])
def test_ring_model_catches_a_planted_fault(fault):
    """A stage released as soon as its products are issued is refilled with
    the k-tile one round later (kt + stages) while they may still read it; a
    full barrier waited for with the other parity lets a product read a
    stage before (or a round after) its copy lands."""
    failed = 0
    for seed in range(40):
        try:
            ring_model(4, 12, 4, seed, fault=fault)
        except AssertionError:
            failed += 1
    assert failed > 0


# --------------------------------- profile --------------------------------- #

GEMM_NAMES = [(f"void (anonymous namespace)::gemm_sm90_kernel<{num}, {epi}, {bn}>"
               "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int, int, int, "
               "(anonymous namespace)::EpiArgs)",
               num)
              for num, epis in ((7, (0, 2)), (8, (1, 2)), (10, (3, 4)))
              for epi in epis for bn in (128, 256)]
GEMM_NAMES += [("void (anonymous namespace)::gemm_f32_kernel<8, 2>(const float *, const float *,"
                " int, int, int, (anonymous namespace)::EpiArgs)", 8)]


@pytest.mark.parametrize("name,num", GEMM_NAMES)
def test_profile_attributes_each_gemm_instantiation(name, num):
    """``chip_profile.py`` counts each instantiation under its kernel number;
    its cuBLAS pattern (``gemm``) swallows none of them."""
    import chip_profile
    assert chip_profile.kind(name).startswith(f"#{num} ")


@pytest.mark.parametrize("name", [
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1_"
    "execute_segment_k_off_kernel__5x_cublas", "nvjet_tst_256x128_64x4_2x1_v_bz_coopA_TNT"])
def test_profile_keeps_cublas_apart(name):
    import chip_profile
    assert chip_profile.kind(name) == "GEMMs (cuBLAS)"
