"""The BNHD attention pair on wgmma (#3 forward, ``csrc/attention_fwd_sm90.cuh``;
#6 on the bf16 backward of ``csrc/attention_bwd_sm90.cuh``), modelled on
the CPU and held against the JAX package.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions. Here a plain tile-by-tile model of the new
forward, in fp32 with its bf16 rounding point, runs the same inputs as the
JAX package's ``fused_attention`` in Pallas's interpreter: two passes over
64-key tiles, a running max m and row sum l in the first, bf16(exp(s - m) /
l) v summed in fp32 in the second, one cast of o, and lse = m + log(l). It
is held to ``chip_smoke.py``'s bf16 forward check (``_fwd_check``: 2e-2 max
abs, and per element 2^-7 |plain| + 2^-5 RMS of the head's row), and its lse
to ``attention_lse_reference`` within 1e-5 of the plain lse's max abs (fp32
sums in another order). The backward's model (``sm90_model`` of
``test_torch_attention_bwd_sm90.py``), fed this forward's o and lse, is held
against ``_fused_attention_bwd_impl`` within the card's bound, 2e-2 of each
JAX gradient's max abs.

Also here: the check's teeth (the forward model with one key tile dropped
must fail it), and the CPU dispatch of ``fused_attention_lse`` and of the
autograd forward, which on the CPU launch nothing and save no o and lse.
The pair also runs at head dim 48 (RAR-B's 768 / 16) and at 32 and 40
(which the card runs on the head-dim-48 code), zero-padded to the 64-wide
tiles as the kernel pads it; the checks the BNHD kernels make before any
launch (``_kernel_operands``) take every width up to 128 (zero-padding
one that is not a multiple of 8) and refuse wider heads.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from imagefolder_tpu.ops.pallas import attention as jax_attn
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from test_torch_attention_bwd_sm90 import pad_head, sm90_model
from tests._torch_parity import one_torch_thread  # noqa: F401


HD = 64
TILE = 64
TOL = 2e-2  # chip_smoke.py's bf16 bound: of the plain result's max abs
LSE_TOL = 1e-5  # of the plain lse's max abs: both fp32, sums in another order
PYRAMID = (1, 3, 5, 7, 9)  # block-causal, L = 165: three tiles a side, one blank


def fwd_sm90_model(q, k, v, bias, scale, drop=None):
    """The card kernel's algorithm on bf16 q (B, Lq, H, hd) and k, v
    (B, Lk, H, hd), hd up to 128 zero-padded to the kernel's tiles (``pad_head``),
    bias None or (1|B, 1|H, Lq, Lk): pass 1 keeps a running
    max m and row sum l over 64-key tiles (a row whose tiles so far are all
    -inf exponentiates against 0); pass 2 sums bf16(exp(s - m) / l) v in
    fp32. Returns (o, lse): o bf16 (B, Lq, H, hd), lse fp32 (B, H, Lq) =
    m + log(l). ``drop`` names a key tile both passes leave out (a planted
    fault)."""
    hd = q.shape[-1]
    qf, kf, vf = (pad_head(x.float()).transpose(1, 2) for x in (q, k, v))  # (B, H, L, w)
    starts = [k0 for k0 in range(0, kf.shape[2], TILE) if k0 // TILE != drop]

    def scores(k0):
        s = qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2) * scale
        return s if bias is None else s + bias[..., k0:k0 + TILE].float()

    m = torch.full(qf.shape[:3], float("-inf"))
    l = torch.zeros(qf.shape[:3])
    for k0 in starts:
        s = scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        l = l * torch.exp(m - mu) + torch.exp(s - mu[..., None]).sum(-1)
        m = m_new
    mu = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    o = torch.zeros(qf.shape)
    for k0 in starts:
        p = torch.exp(scores(k0) - mu[..., None]) / l[..., None]
        o = o + p.bfloat16().float() @ vf[:, :, k0:k0 + TILE]
    return o[..., :hd].to(q.dtype).transpose(1, 2).contiguous(), mu + torch.log(l)


def _inputs(b, lq, lk, h, seed, n=3, hd=HD):
    rng = np.random.default_rng(seed)
    shapes = [(b, lq, h, hd)] + [(b, lk, h, hd)] * (n - 1)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _fwd_case(name, hd=HD):
    """(q, k, v, bias) as numpy, from a seed: the 512 px decode's stage 5
    (81 new rows against 147 cached, three key tiles, the last ragged), one
    new row against two key tiles, teacher forcing at L = 165 under the
    block-causal bias, and a per-(B, H) bias whose first key tile is all
    -inf for the early rows."""
    if name == "decode 81 x 147":
        return (*_inputs(2, 81, 147, 2, 1, hd=hd), None)
    if name == "Lq=1":
        return (*_inputs(2, 1, 70, 2, 2, hd=hd), None)
    if name == "block-causal L=165":
        bias = build_attn_bias(PYRAMID).numpy()
        assert bias.shape == (1, 1, 165, 165)
        return (*_inputs(2, 165, 165, 2, 3, hd=hd), bias)
    if name == "per-(B,H) bias":
        bias = np.random.default_rng(4).normal(size=(2, 2, 37, 100)).astype(np.float32)
        bias[:, :, :11, :TILE] = -np.inf
        bias[1, 0, :, 70:75] = -np.inf
        return (*_inputs(2, 37, 100, 2, 4, hd=hd), bias)
    raise KeyError(name)


FWD_CASES = ["decode 81 x 147", "Lq=1", "block-causal L=165", "per-(B,H) bias"]


def _torch(q, k, v, bias):
    return (*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
            None if bias is None else torch.from_numpy(bias))


def _jax_fwd(q, k, v, bias, scale):
    out = jax_attn.fused_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                   None if bias is None else jnp.asarray(bias), scale=scale,
                                   interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("name", FWD_CASES)
def test_fwd_model_matches_pallas(name):
    """#3's two-pass wgmma algorithm against the Pallas ``fused_attention``
    in interpret mode, within chip_smoke.py's bf16 forward check; its lse
    against the plain lse."""
    q, k, v, bias = _fwd_case(name)
    scale = 1.0 / np.sqrt(HD)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    got, lse = fwd_sm90_model(tq, tk, tv, tb, scale)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    cs._fwd_check(f"#3 model {name}", got, _jax_fwd(q, k, v, bias, scale))
    want = pt_attn.attention_lse_reference(tq, tk, tb, scale)
    assert lse.shape == want.shape and bool(torch.isfinite(want).all())
    assert (lse - want).abs().max().item() <= LSE_TOL * want.abs().max().item()


@pytest.mark.parametrize("name", FWD_CASES)
def test_fwd_model_matches_pallas_at_head_dim_48(name):
    """#3 at head dim 48: the model on zero-padded tiles against the Pallas
    ``fused_attention`` in interpret mode on the 48-wide inputs, within
    chip_smoke.py's bf16 forward check (per element against the RMS of the
    head's 48 outputs); its lse against the plain lse."""
    q, k, v, bias = _fwd_case(name, hd=48)
    scale = 1.0 / np.sqrt(48)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    got, lse = fwd_sm90_model(tq, tk, tv, tb, scale)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    cs._fwd_check(f"#3 model {name}, hd 48", got, _jax_fwd(q, k, v, bias, scale), hd=48)
    want = pt_attn.attention_lse_reference(tq, tk, tb, scale)
    assert (lse - want).abs().max().item() <= LSE_TOL * want.abs().max().item()


@pytest.mark.parametrize("hd", [32, 40])
@pytest.mark.parametrize("name", ["decode 81 x 147", "block-causal L=165"])
def test_fwd_model_matches_pallas_at_head_dims_32_and_40(name, hd):
    """#3 at head dims 32 and 40, which the card runs on the head-dim-48
    code (the width read at run time): the model on tiles zero-padded to 64
    against the Pallas ``fused_attention`` in interpret mode on the narrow
    inputs, within chip_smoke.py's bf16 forward check; its lse against the
    plain lse."""
    q, k, v, bias = _fwd_case(name, hd=hd)
    scale = 1.0 / np.sqrt(hd)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    got, lse = fwd_sm90_model(tq, tk, tv, tb, scale)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    cs._fwd_check(f"#3 model {name}, hd {hd}", got, _jax_fwd(q, k, v, bias, scale), hd=hd)
    want = pt_attn.attention_lse_reference(tq, tk, tb, scale)
    assert (lse - want).abs().max().item() <= LSE_TOL * want.abs().max().item()


@pytest.mark.parametrize("name,drop", [("decode 81 x 147", 2), ("decode 81 x 147", 0),
                                       ("block-causal L=165", 1), ("Lq=1", 1)])
def test_fwd_model_with_a_dropped_tile_fails(name, drop):
    """The check has teeth: the model with one key tile left out of both
    passes (the ragged last tile, a full first one) fails chip_smoke.py's
    forward check against the Pallas kernel."""
    q, k, v, bias = _fwd_case(name)
    scale = 1.0 / np.sqrt(HD)
    got, _ = fwd_sm90_model(*_torch(q, k, v, bias), scale, drop=drop)
    with pytest.raises(AssertionError):
        cs._fwd_check(f"#3 model {name}, tile {drop} dropped", got,
                      _jax_fwd(q, k, v, bias, scale))


@pytest.mark.parametrize("name,drop", [("decode 81 x 147", 2), ("block-causal L=165", 1)])
def test_fwd_model_with_a_dropped_tile_fails_at_head_dim_48(name, drop):
    """The check keeps its teeth at head dim 48: a key tile left out of both
    passes fails it."""
    q, k, v, bias = _fwd_case(name, hd=48)
    scale = 1.0 / np.sqrt(48)
    got, _ = fwd_sm90_model(*_torch(q, k, v, bias), scale, drop=drop)
    with pytest.raises(AssertionError):
        cs._fwd_check(f"#3 model {name}, hd 48, tile {drop} dropped", got,
                      _jax_fwd(q, k, v, bias, scale), hd=48)


def test_fwd_model_lse_of_a_blank_row_is_minus_inf():
    """A row whose every score is -inf: lse -inf in the model and in the
    plain version; the other rows finite."""
    q, k, v = _inputs(1, 5, 70, 1, 5)
    bias = np.zeros((1, 1, 5, 70), np.float32)
    bias[..., 2, :] = -np.inf
    tq, tk, tv, tb = _torch(q, k, v, bias)
    _, lse = fwd_sm90_model(tq, tk, tv, tb, 0.125)
    want = pt_attn.attention_lse_reference(tq, tk, tb, 0.125)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
    assert bool(torch.isneginf(lse[0, 0, 2])) and int(torch.isfinite(lse).sum()) == 4


@pytest.mark.parametrize("bias_kind", ["none", "block_causal"])
def test_bwd_model_on_the_new_forward_matches_pallas(bias_kind):
    """#6 on the wgmma backward: ``sm90_model`` fed #3's o and lse (the
    forward model's) against ``_fused_attention_bwd_impl`` in interpret
    mode at L = 165, bf16, within 2e-2 of each JAX gradient's max abs."""
    _check_bwd_on_fwd_model(bias_kind, HD)


@pytest.mark.parametrize("bias_kind", ["none", "block_causal"])
def test_bwd_model_on_the_new_forward_matches_pallas_at_head_dim_48(bias_kind):
    """#6 at head dim 48 (RAR-B's training backward, here under the
    block-causal pyramid and with no bias): the models on zero-padded tiles
    against ``_fused_attention_bwd_impl`` on the 48-wide inputs."""
    _check_bwd_on_fwd_model(bias_kind, 48)


@pytest.mark.parametrize("hd", [32, 40])
@pytest.mark.parametrize("bias_kind", ["none", "block_causal"])
def test_bwd_model_on_the_new_forward_matches_pallas_at_head_dims_32_and_40(bias_kind, hd):
    """#6 at head dims 32 and 40 (the head-dim-48 code at run time): the
    models on zero-padded tiles against ``_fused_attention_bwd_impl`` on
    the narrow inputs."""
    _check_bwd_on_fwd_model(bias_kind, hd)


def _check_bwd_on_fwd_model(bias_kind, hd):
    q, k, v, g = _inputs(2, 165, 165, 2, 6, n=4, hd=hd)
    bias = build_attn_bias(PYRAMID).numpy() if bias_kind == "block_causal" else None
    scale = 1.0 / np.sqrt(hd)
    tq, tk, tv, tb = _torch(q, k, v, bias)
    tg = torch.from_numpy(g).bfloat16()
    o, lse = fwd_sm90_model(tq, tk, tv, tb, scale)
    got = sm90_model(tq, tk, tv, tg, tb, scale, o, lse)
    want = jax_attn._fused_attention_bwd_impl(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), jnp.asarray(g, jnp.bfloat16),
        interpret=True)[:3]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert a.dtype == torch.bfloat16 and a.shape == w.shape and np.isfinite(w).all()
        err = np.abs(a.float().numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, f"{name}: {err}"


def test_fused_attention_lse_on_cpu_launches_nothing():
    """On a CPU tensor ``fused_attention_lse`` is the plain versions: the
    output of ``fused_attention_reference`` and ``attention_lse_reference``,
    bit for bit, and no kernel launch counted."""
    tq, tk, tv, tb = _torch(*_fwd_case("block-causal L=165"))
    before = pt_attn.FUSED_LAUNCHES
    out, lse = pt_attn.fused_attention_lse(tq, tk, tv, tb, 1.0)
    assert pt_attn.FUSED_LAUNCHES == before
    assert torch.equal(out, pt_attn.fused_attention_reference(tq, tk, tv, tb, 1.0))
    assert torch.equal(lse, pt_attn.attention_lse_reference(tq, tk, tb, 1.0))
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (2, 2, 165)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_on_cpu_saves_no_lse(dtype):
    """The autograd forward on the CPU saves no o and lse (they are the
    card's), launches nothing, and its gradients are the plain backward's,
    unchanged."""
    q, k, v, g = _inputs(2, 165, 165, 2, 7, n=4)
    tb = torch.from_numpy(build_attn_bias(PYRAMID).numpy())
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tg = torch.from_numpy(g).to(dtype)
    before = (pt_attn.FUSED_LAUNCHES, pt_attn.FUSED_BWD_LAUNCHES)
    out = pt_attn.fused_attention(*leaves, tb, 1.0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[4] is None and saved[5] is None
    got = torch.autograd.grad(out, leaves, tg)
    assert (pt_attn.FUSED_LAUNCHES, pt_attn.FUSED_BWD_LAUNCHES) == before
    want = pt_attn.fused_attention_bwd_reference(*(x.detach() for x in leaves), tb, tg, 1.0,
                                                 need_dbias=False)
    for a, w in zip(got, want[:3]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("view", ["Lq=1 odd row stride", "H=1 odd head stride",
                                  "odd row stride"])
def test_copy_ready_agrees_with_the_kernel_alignment(view):
    """``_copy_ready`` copies a bf16 view exactly when the wgmma forward
    would refuse it: the stride of an axis longer than 1 off a 16-byte
    boundary. The stride of a size-1 axis is never read, and ``_strides``
    hands the kernel 0 for it, so such a view goes in uncopied."""
    size, stride, copied = {
        "Lq=1 odd row stride": ((2, 1, 4, HD), (4 * HD, 3, HD, 1), False),
        "H=1 odd head stride": ((2, 3, 1, HD), (3 * HD, HD, 5, 1), False),
        "odd row stride": ((2, 3, 4, HD), (12 * HD + 4, 4 * HD + 1, HD, 1), True),
    }[view]
    base = torch.zeros(2 * (12 * HD + 4) + 8, dtype=torch.bfloat16)
    t = base.as_strided(size, stride)
    got = pt_attn._copy_ready(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    assert all(s % 8 == 0 for s in pt_attn._strides(got, (0, 1, 2)))


@pytest.mark.parametrize("hd", [48, 64, 40, 80, 16, 32, 56, 44, 128, 36, 100, 136, 256, 250,
                                264, 1032])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_operands_take_head_dims_48_and_64(hd, dtype):
    """The checks every BNHD kernel (#3-#6) makes before it launches: every
    head dim passes (48 and 64 among them, and past 1024 too, for the
    segmented kernels; the bias cast to fp32), a multiple of 8 as it is and
    any other zero-padded to the next multiple of 8. They come before any
    launch, so CPU tensors reach them."""
    q, k, v = (torch.randn((2, 5, 3, hd)).to(dtype) for _ in range(3))
    bias = torch.zeros((1, 1, 5, 5), dtype=torch.bfloat16)
    *qkv, b = pt_attn._kernel_operands(q, k, v, bias, "fused_attention")
    assert b.dtype == torch.float32
    if hd % 8 == 0:
        assert all(x is y for x, y in zip(qkv, (q, k, v)))
        return
    for x, y in zip(qkv, (q, k, v)):
        assert x.shape[-1] == -(-hd // 8) * 8
        assert torch.equal(x[..., :hd], y) and not x[..., hd:].any()
