"""The one-pass attention forward on wgmma (``csrc/attention_fwd_sm90.cuh``:
#1 packed qkv, #4 q-blocked, #7's attention step), modelled on the CPU and
held against the JAX package.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain versions. Here a plain tile-by-tile model of its
algorithm, in fp32 with its bf16 rounding point, runs the same inputs as
the JAX package's ``_attention_qkv_fwd_impl`` (#1, with and without the
encoder's mask) and ``_fused_attention_qblk_fwd`` (#4, at a block-causal
pyramid with a blank tile, at a ragged length, and under an encoder mask
whose first key tile is blank for the last rows) in Pallas's interpreter:
per 64 q rows, over the 64-key tiles the blank-tile map leaves, a running
max m, o and l scaled by exp(m_old - m_new), bf16(exp(s - m)) v summed in
fp32, o / l at the end and one cast; lse = m + log(l). The output is held
to ``chip_smoke.py``'s bf16 forward check (``_fwd_check``: 2e-2 max abs,
and per element 2^-7 |plain| + 2^-5 RMS of the head's row), the lse to
``attention_lse_reference`` within 1e-5 of the plain lse's max abs (fp32
sums in another order).

Also here: the model that skips the map's blank tiles is bit-equal to the
model that computes them; a model that skips a tile the map keeps fails the
check (its teeth); the block rule (a block of two warpgroups copies a key
tile unless it is blank for both) against a brute-force scan of VAR's 512
px bias; the bf16 dispatch of #1 and #4 through ``_copy_ready`` (a view off
16 bytes reaches the kernel as an aligned copy) with the map's scratch
passed exactly for a square bias; and ``chip_profile.py``'s attribution of
the new instantiations. #4 also runs at head dims 48 (RAR-B's 768 / 16),
32 and 40 (the BNHD kernels take every multiple of 8 up to 64), zero-padded
to the 64-wide tiles as the kernel pads it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_profile
import chip_smoke as cs
from imagefolder_tpu.ops.pallas import attention as jax_attn
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from test_torch_attention_bwd_sm90 import pad_head
from tests._torch_parity import one_torch_thread  # noqa: F401


HD = 64
TILE = 64
LSE_TOL = 1e-5  # of the plain lse's max abs: both fp32, sums in another order
PYRAMID = (1, 3, 5, 7, 9)  # block-causal, L = 165: three tiles a side, one blank


@pytest.fixture(autouse=True)
def q_blocks(monkeypatch):
    """The JAX q-blocked kernel's score budget at 96 x 24 elements, so that
    these lengths run several q blocks, as the JAX tests shrink it."""
    monkeypatch.setattr(jax_attn, "_SCORE_TILE_BUDGET", 96 * 24)


def onepass_model(q, k, v, bias, scale, blank=None, skip=()):
    """The card kernel's algorithm on bf16 q (B, Lq, H, hd) and k, v
    (B, Lk, H, hd), hd 48 or 64 zero-padded to the kernel's 64-wide tiles,
    bias None or (1, 1, Lq, Lk): per 64-row q tile, over the
    64-key tiles in order, except those the map ``blank`` ((Tq, Tk) uint8 or
    None) blanks and the (q tile, key tile) pairs in ``skip`` (a planted
    fault): s = q k^T * scale + bias; m_new = max(m, rowmax(s)); mu = m_new,
    or 0 while the row is all -inf; alpha = exp(m - mu); p = exp(s - mu);
    l = l alpha + rowsum(p); o = o alpha + bf16(p) v. At the end o / l,
    cast once, and lse = mu + log(l). Returns (o bf16 (B, Lq, H, hd), lse
    fp32 (B, H, Lq))."""
    hd = q.shape[-1]
    qf, kf, vf = (pad_head(x.float()).transpose(1, 2) for x in (q, k, v))  # (B, H, L, 64)
    lq, lk = qf.shape[2], kf.shape[2]
    o = torch.empty(qf.shape)
    lse = torch.empty(qf.shape[:3])
    for qt in range(-(-lq // TILE)):
        qs = slice(qt * TILE, min(lq, qt * TILE + TILE))
        m = torch.full(qf[:, :, qs].shape[:3], float("-inf"))
        l = torch.zeros(m.shape)
        acc = torch.zeros(qf[:, :, qs].shape)
        for kt in range(-(-lk // TILE)):
            if (blank is not None and blank[qt, kt]) or (qt, kt) in skip:
                continue
            ks = slice(kt * TILE, min(lk, kt * TILE + TILE))
            s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2) * scale
            if bias is not None:
                s = s + bias[..., qs, ks].float()
            m_new = torch.maximum(m, s.amax(-1))
            mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
            alpha = torch.exp(m - mu)
            p = torch.exp(s - mu[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, ks]
            m = m_new
        mu = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        o[:, :, qs] = acc / l[..., None]
        lse[:, :, qs] = mu + torch.log(l)
    return o[..., :hd].to(q.dtype).transpose(1, 2).contiguous(), lse


def _rng_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _qkv_case(name):
    """(qkv (B, N, 3C) numpy, heads, bias numpy or None): the encoder's
    shape cut to N = 130 over two heads, with no mask, or with its mask
    (the last 40 rows' first key tile blank)."""
    (qkv,) = _rng_inputs([(2, 130, 3 * 2 * HD)], 1)
    if name == "no mask":
        return qkv, 2, None
    if name == "encoder mask":
        return qkv, 2, cs.encoder_mask(130, 40, torch.device("cpu"), 64).numpy()
    raise KeyError(name)


def _qblk_case(name, hd=HD):
    """(q, k, v, bias) as numpy: teacher forcing at L = 165 under the
    block-causal bias (key tile 2 blank for q tile 0), a ragged L = 130
    (the last tile two keys) with no bias, and L = 150 under an encoder
    mask whose first key tile is blank for q tile 2."""
    if name == "block-causal L=165":
        bias = build_attn_bias(PYRAMID).numpy()
        assert bias.shape == (1, 1, 165, 165)
        return (*_rng_inputs([(2, 165, 2, hd)] * 3, 2), bias)
    if name == "ragged L=130":
        return (*_rng_inputs([(2, 130, 2, hd)] * 3, 3), None)
    if name == "encoder mask L=150":
        return (*_rng_inputs([(2, 150, 2, hd)] * 3, 4),
                cs.encoder_mask(150, 50, torch.device("cpu"), 64).numpy())
    raise KeyError(name)


def _bf(x):
    return None if x is None else torch.from_numpy(x).bfloat16()


def _bias(x):
    return None if x is None else torch.from_numpy(x)


def _jax_qkv(qkv, heads, bias, scale):
    out = jax_attn._attention_qkv_fwd_impl(
        jnp.asarray(qkv, jnp.bfloat16), None if bias is None else jnp.asarray(bias),
        heads=heads, scale=scale, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).bfloat16()


def _jax_qblk(q, k, v, bias, scale):
    out = jax_attn._fused_attention_qblk_fwd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), scale=scale, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).bfloat16()


def _qkv_views(qkv, heads):
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, heads, c3 // 3 // heads).unbind(2)


def _check_lse(lse, q, k, bias, scale):
    want = pt_attn.attention_lse_reference(q, k, bias, scale)
    assert lse.shape == want.shape and bool(torch.isfinite(want).all())
    assert (lse - want).abs().max().item() <= LSE_TOL * want.abs().max().item()


@pytest.mark.parametrize("name", ["no mask", "encoder mask"])
def test_model_matches_pallas_qkv(name):
    """#1: the one-pass algorithm on the packed views against
    ``_attention_qkv_fwd_impl`` in interpret mode, within chip_smoke.py's
    bf16 forward check; its lse against the plain lse. The kernel computes
    every tile of #1's mask (no map)."""
    qkv, heads, bias = _qkv_case(name)
    scale = 1.0 / np.sqrt(HD)
    tq, tk, tv = _qkv_views(_bf(qkv), heads)
    got, lse = onepass_model(tq, tk, tv, _bias(bias), scale)
    b, n, c3 = qkv.shape
    cs._fwd_check(f"#1 model {name}", got.reshape(b, n, c3 // 3),
                  _jax_qkv(qkv, heads, bias, scale))
    _check_lse(lse, tq, tk, _bias(bias), scale)


@pytest.mark.parametrize("name", ["block-causal L=165", "ragged L=130", "encoder mask L=150"])
def test_model_matches_pallas_qblk(name):
    """#4: the one-pass algorithm, skipping the tiles the map blanks,
    against ``_fused_attention_qblk_fwd`` in interpret mode (several q
    blocks), within chip_smoke.py's bf16 forward check; its lse against the
    plain lse."""
    q, k, v, bias = _qblk_case(name)
    tb = _bias(bias)
    blank = None if tb is None else pt_attn.blank_tile_map_reference(tb)
    got, lse = onepass_model(_bf(q), _bf(k), _bf(v), tb, 1.0, blank)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    cs._fwd_check(f"#4 model {name}", got, _jax_qblk(q, k, v, bias, 1.0))
    _check_lse(lse, _bf(q), _bf(k), tb, 1.0)


@pytest.mark.parametrize("name", ["block-causal L=165", "ragged L=130", "encoder mask L=150"])
def test_model_matches_pallas_qblk_at_head_dim_48(name):
    """#4 at head dim 48: the one-pass model on zero-padded tiles, skipping
    the tiles the map blanks, against ``_fused_attention_qblk_fwd`` in
    interpret mode on the 48-wide inputs, within chip_smoke.py's bf16
    forward check; its lse against the plain lse."""
    q, k, v, bias = _qblk_case(name, hd=48)
    tb = _bias(bias)
    blank = None if tb is None else pt_attn.blank_tile_map_reference(tb)
    got, lse = onepass_model(_bf(q), _bf(k), _bf(v), tb, 1.0, blank)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    cs._fwd_check(f"#4 model {name}, hd 48", got, _jax_qblk(q, k, v, bias, 1.0), hd=48)
    _check_lse(lse, _bf(q), _bf(k), tb, 1.0)


@pytest.mark.parametrize("hd", [32, 40])
@pytest.mark.parametrize("name", ["block-causal L=165", "ragged L=130"])
def test_model_matches_pallas_qblk_at_head_dims_32_and_40(name, hd):
    """#4 at head dims 32 and 40 (the head-dim-48 code at run time): the
    one-pass model on tiles zero-padded to 64, skipping the tiles the map
    blanks, against ``_fused_attention_qblk_fwd`` in interpret mode on the
    narrow inputs, within chip_smoke.py's bf16 forward check; its lse
    against the plain lse."""
    q, k, v, bias = _qblk_case(name, hd=hd)
    tb = _bias(bias)
    blank = None if tb is None else pt_attn.blank_tile_map_reference(tb)
    got, lse = onepass_model(_bf(q), _bf(k), _bf(v), tb, 1.0, blank)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    cs._fwd_check(f"#4 model {name}, hd {hd}", got, _jax_qblk(q, k, v, bias, 1.0), hd=hd)
    _check_lse(lse, _bf(q), _bf(k), tb, 1.0)


@pytest.mark.parametrize("name", ["block-causal L=165", "encoder mask L=150", "#1 encoder mask"])
def test_skipping_blank_tiles_is_bit_equal(name):
    """A tile whose every bias entry is -inf adds exactly 0 to l and o and
    leaves m: the model that skips the map's blank tiles gives the same
    output and lse, bit for bit, as the model that computes every tile
    (what chip_smoke.py holds the kernel to on the card)."""
    if name == "#1 encoder mask":
        qkv, heads, bias = _qkv_case("encoder mask")
        q, k, v = _qkv_views(_bf(qkv), heads)
    else:
        *qkv, bias = _qblk_case(name)
        q, k, v = (_bf(x) for x in qkv)
    tb = _bias(bias)
    blank = pt_attn.blank_tile_map_reference(tb)
    assert int(blank.sum()) >= 1
    skipped = onepass_model(q, k, v, tb, 0.125, blank)
    computed = onepass_model(q, k, v, tb, 0.125)
    for a, b in zip(skipped, computed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,tile", [("block-causal L=165", (1, 1)),
                                       ("encoder mask L=150", (2, 2))])
def test_skipping_a_live_tile_fails(name, tile):
    """The check has teeth: the model that also skips a tile the map keeps
    (a diagonal tile of the pyramid; the ragged last tile of the masked
    rows) fails chip_smoke.py's forward check against the Pallas kernel."""
    q, k, v, bias = _qblk_case(name)
    tb = _bias(bias)
    blank = pt_attn.blank_tile_map_reference(tb)
    assert not blank[tile]
    got, _ = onepass_model(_bf(q), _bf(k), _bf(v), tb, 1.0, blank, skip=(tile,))
    with pytest.raises(AssertionError):
        cs._fwd_check(f"#4 model {name}, tile {tile} skipped", got,
                      _jax_qblk(q, k, v, bias, 1.0))


def test_skipping_a_live_tile_fails_at_head_dim_48():
    """The check keeps its teeth at head dim 48: the pyramid's diagonal
    tile (1, 1) skipped fails it."""
    q, k, v, bias = _qblk_case("block-causal L=165", hd=48)
    tb = _bias(bias)
    got, _ = onepass_model(_bf(q), _bf(k), _bf(v), tb, 1.0,
                           pt_attn.blank_tile_map_reference(tb), skip=((1, 1),))
    with pytest.raises(AssertionError):
        cs._fwd_check("#4 model, hd 48, tile (1, 1) skipped", got,
                      _jax_qblk(q, k, v, bias, 1.0), hd=48)


def test_block_rule_matches_brute_force_on_var512_bias():
    """``block_key_tiles_reference`` (a block of two warpgroups, 128 q rows,
    copies a key tile unless the map blanks it for both) against a scan of
    VAR's 512 px bias: a block copies key tile kt exactly when one of its
    rows has a finite entry there. Also the count the design rests on: a
    third of the 64 x 64 tiles blank."""
    bias = build_attn_bias(cs.PNS512)
    n = bias.shape[-1]
    got = pt_attn.block_key_tiles_reference(bias)
    finite = torch.isfinite(bias[0, 0])
    nb, t = -(-n // 128), -(-n // TILE)
    want = torch.zeros((nb, t), dtype=torch.bool)
    for bi in range(nb):
        for kt in range(t):
            want[bi, kt] = bool(finite[bi * 128:(bi + 1) * 128, kt * TILE:(kt + 1) * TILE].any())
    assert got.shape == (18, 35) and torch.equal(got, want)
    blank = pt_attn.blank_tile_map_reference(bias)
    assert int(blank.sum()) == 419 and int((~got).sum()) == 201


class _Spy:
    """Stands in for ``_launch`` and wraps ``_copy_ready``: records the
    entry's arguments and each view that went through the copy rule."""

    def __init__(self, monkeypatch):
        self.args, self.ready = None, []
        copy_ready = pt_attn._copy_ready

        def ready(t):
            out = copy_ready(t)
            self.ready.append((t, out))
            return out

        def launch(what, entry, device, *args):
            self.args = args

        monkeypatch.setattr(pt_attn, "_copy_ready", ready)
        monkeypatch.setattr(pt_attn, "_launch", launch)


def test_qblk_bf16_dispatch_copies_unaligned_views_and_passes_the_map(monkeypatch):
    """#4 in bf16 takes each of q, k and v through ``_copy_ready``: a view
    whose row stride is off 16 bytes reaches the kernel as an aligned copy,
    an aligned one as itself; with a square bias the entry gets the map's
    scratch (none with ``skip_blank=False``, none in fp32, none without a
    bias), and one launch is counted."""
    spy = _Spy(monkeypatch)
    wide = torch.randn((3, 2, 130, 2, HD + 1)).bfloat16()
    q, k, v = wide[0, ..., :HD], wide[1, ..., 1:], torch.randn((2, 130, 2, HD)).bfloat16()
    bias = cs.encoder_mask(130, 40, torch.device("cpu"), 64)
    before = pt_attn.QBLK_LAUNCHES
    pt_attn._fused_attention_qblk_cuda(q, k, v, bias, 1.0)
    assert pt_attn.QBLK_LAUNCHES == before + 1
    assert [t is src for src, t in spy.ready] == [False, False, True]
    ptrs, blank = spy.args[:3], spy.args[4]
    assert ptrs[0] != q.data_ptr() and ptrs[1] != k.data_ptr() and ptrs[2] == v.data_ptr()
    assert all(p % 16 == 0 for p in ptrs) and blank is not None
    assert all(s % 8 == 0 for st in spy.args[11:14] for s in st)
    for kw, args in (({"skip_blank": False}, (q, k, v, bias)), ({}, (q, k, v, None)),
                     ({}, tuple(t.float() for t in (q, k, v)) + (bias,))):
        spy.ready.clear()
        pt_attn._fused_attention_qblk_cuda(*args, 1.0, **kw)
        assert spy.args[4] is None
        assert len(spy.ready) == (3 if args[0].dtype == torch.bfloat16 else 0)


def test_qkv_bf16_dispatch_copies_an_unaligned_base(monkeypatch):
    """#1 in bf16 takes the packed qkv through ``_copy_ready`` as (B, N,
    3 heads, 64): a contiguous qkv whose base is off 16 bytes reaches the
    kernel as an aligned copy, equal to it; an aligned one as itself."""
    spy = _Spy(monkeypatch)
    base = torch.randn(2 * 37 * 3 * 2 * HD + 1).bfloat16()
    qkv = base[1:].view(2, 37, 3 * 2 * HD)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 != 0
    pt_attn._attention_qkv_cuda(qkv, 2, None, 0.125)
    (src, got), = spy.ready
    assert spy.args[0] == got.data_ptr() != qkv.data_ptr() and spy.args[0] % 16 == 0
    assert torch.equal(got.reshape(qkv.shape), qkv)
    spy.ready.clear()
    aligned = torch.randn((2, 37, 3 * 2 * HD)).bfloat16()
    pt_attn._attention_qkv_cuda(aligned, 2, None, 0.125)
    assert spy.args[0] == aligned.data_ptr() and spy.ready[0][1] is spy.ready[0][0]


@pytest.mark.parametrize("name,num", [
    ("void (anonymous namespace)::sm90::attn_fwd_onepass_kernel<1, false, true>(...)", 1),
    ("void (anonymous namespace)::sm90::attn_fwd_onepass_kernel<4, true, false>(...)", 4),
    ("void (anonymous namespace)::sm90::attn_bwd_prep_kernel<4>(...)", 4),
    ("void (anonymous namespace)::sm90::attn_fwd_onepass_kernel<7, false, false>(...)", 7),
    ("void (anonymous namespace)::attn_fwd_f32_kernel<4, true, true>(...)", 4),
    ("void (anonymous namespace)::sm90::attn_fwd_sm90_kernel<3, true, false, true>(...)", 3),
    ("void (anonymous namespace)::sm90::attn_bwd_prep_kernel<5>(...)", 5)])
def test_profile_attributes_each_instantiation(name, num):
    """``chip_profile.py`` counts the one-pass instantiations and #4's map
    pre-pass under their own kernel numbers; the <3 pattern of #3 catches
    none of them."""
    assert chip_profile.kind(name).startswith(f"#{num} ")
