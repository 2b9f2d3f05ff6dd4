"""Port parity, q-blocked attention: ``imagefolder_tpu_torch.ops.cuda.attention.
fused_attention_qblk`` (kernel #4's plain version) against the JAX
``_fused_attention_qblk_fwd`` run through Pallas's interpreter on the CPU,
``fused_attention_qblk_bwd_reference`` (#5's) against
``_fused_attention_qblk_bwd`` in interpret mode, and the port's router
(``dot_product_attention``, and ``attention_qkv``'s long branch) with its
autograd, on the same numpy-seeded inputs.

The JAX module's ``_SCORE_TILE_BUDGET`` is shrunk so that an unaligned L = 89
runs four q blocks, and the port's ``_SINGLE_MAX_ELEMS`` so that a small L
takes the q-blocked route. Tolerances: fp32 2e-5 max abs forward (only the
summation order differs), 1e-4 of the largest magnitude of each gradient
(dq, dk, dv, dbias); bf16 1e-2 max abs forward and 1e-2 of the largest
magnitude of each gradient (one rounding of p, of ds and of the outputs,
placed alike on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.ops.pallas import attention as jax_attn
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from tests._torch_parity import one_torch_thread  # noqa: F401


HD = 64
L = 89
PNS89 = (1, 2, 3, 4, 5, 5, 3)  # a block-causal pyramid of 89 positions
FWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def four_q_blocks(monkeypatch):
    """The JAX kernels' score budget at 96 rows x 24: four q blocks at L = 89."""
    monkeypatch.setattr(jax_attn, "_SCORE_TILE_BUDGET", 96 * 24)


def _inputs(b, l, h, bias_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, l, h, HD)).astype(np.float32) for _ in range(4))
    bias = None
    if bias_kind == "block_causal":
        bias = build_attn_bias(PNS89).numpy()
        assert bias.shape == (1, 1, l, l)
    elif bias_kind == "dense":
        bias = rng.normal(size=(1, 1, l, l)).astype(np.float32)
        bias[..., 70:] = -np.inf
    return q, k, v, g, bias


def _torch(x, dtype):
    return None if x is None else torch.from_numpy(x).to(TDT[dtype])


def _jax(x, dtype):
    return None if x is None else jnp.asarray(x, JDT[dtype])


def _rel_close(got, want, tol, name):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(want).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "block_causal", "dense"])
def test_forward_matches_pallas_interpret(dtype, bias_kind):
    q, k, v, _, bias = _inputs(2, L, 3, bias_kind, seed=1)
    want = jax_attn._fused_attention_qblk_fwd(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
        None if bias is None else jnp.asarray(bias), interpret=True)
    got = pt_attn.fused_attention_qblk(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                                       None if bias is None else torch.from_numpy(bias))
    assert got.shape == q.shape and got.dtype == TDT[dtype] and got.is_contiguous()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=FWD_TOL[dtype])


def test_cross_length_forward_matches_pallas_interpret():
    """Lq != Lk (the forward takes it, as the JAX kernel does), on strided
    views of a (B, L, 3, H, hd) tensor, at scale 1."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 41, 2, HD)).astype(np.float32)
    kv = rng.normal(size=(2, 77, 2, 2, HD)).astype(np.float32)
    want = jax_attn._fused_attention_qblk_fwd(jnp.asarray(q), jnp.asarray(kv[:, :, 0]),
                                              jnp.asarray(kv[:, :, 1]), None, scale=1.0,
                                              interpret=True)
    k, v = torch.from_numpy(kv).unbind(2)
    assert not k.is_contiguous()
    got = pt_attn.fused_attention_qblk(torch.from_numpy(q), k, v, scale=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "block_causal", "dense"])
def test_bwd_reference_matches_pallas_interpret(dtype, bias_kind):
    """dq, dk, dv (and dbias) of #5's plain version against the Pallas
    backward in interpret mode, whose dk and dv are summed in fp32 over the
    four q blocks and cast at the end."""
    q, k, v, g, bias = _inputs(2, L, 3, bias_kind, seed=3)
    want = jax_attn._fused_attention_qblk_bwd(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
        None if bias is None else jnp.asarray(bias), _jax(g, dtype), interpret=True)
    got = pt_attn.fused_attention_qblk_bwd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        None if bias is None else torch.from_numpy(bias), _torch(g, dtype))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (a is None) == (w is None), name
        if w is None:
            continue
        want_dtype = torch.float32 if name == "dbias" else TDT[dtype]
        assert a.dtype == want_dtype and a.is_contiguous(), name
        _rel_close(a, np.asarray(w.astype(jnp.float32)), BWD_TOL[dtype], name)


@pytest.mark.parametrize("bias_kind", ["none", "block_causal"])
@pytest.mark.parametrize("entry", ["dot_product_attention", "attention_qkv"])
def test_router_past_the_budget_takes_the_qblk_contract(monkeypatch, entry, bias_kind):
    """With the port's budget shrunk below L * L, both entry points compute
    #4's function (o / l after p v) and their autograd gradients are the
    interpreted #5's, the packed dqkv included; dbias comes back when the
    bias requires a gradient. The CPU launches no kernel."""
    monkeypatch.setattr(pt_attn, "_SINGLE_MAX_ELEMS", L * L - 1)
    q, k, v, g, bias = _inputs(2, L, 2, bias_kind, seed=4)
    want = jax_attn._fused_attention_qblk_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              None if bias is None else jnp.asarray(bias),
                                              interpret=True)
    want_grads = jax_attn._fused_attention_qblk_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), jnp.asarray(g), interpret=True)
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    counts = (pt_attn.QBLK_LAUNCHES, pt_attn.QBLK_BWD_LAUNCHES)
    if entry == "attention_qkv":
        qkv = torch.from_numpy(np.stack([q, k, v], axis=2).reshape(2, L, -1)).requires_grad_()
        out = pt_attn.attention_qkv(qkv, 2, bt)
        assert out.shape == (2, L, 2 * HD)
        out = out.view(2, L, 2, HD)
        grads = torch.autograd.grad(out, [qkv] + ([bt] if bt is not None else []),
                                    torch.from_numpy(g))
        dq, dk, dv = grads[0].view(2, L, 3, 2, HD).unbind(2)
    else:
        qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        out = pt_attn.dot_product_attention(qt, kt, vt, bt)
        grads = torch.autograd.grad(out, [qt, kt, vt] + ([bt] if bt is not None else []),
                                    torch.from_numpy(g))
        dq, dk, dv = grads[:3]
    assert (pt_attn.QBLK_LAUNCHES, pt_attn.QBLK_BWD_LAUNCHES) == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL["float32"])
    got = [dq, dk, dv] + ([grads[-1]] if bt is not None else [])
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want_grads):
        _rel_close(a, np.asarray(w), BWD_TOL["float32"], name)


def _spy(monkeypatch):
    """Record which plain version each call reaches."""
    seen = []
    for name in ("fused_attention_reference", "fused_attention_qblk_reference"):
        orig = getattr(pt_attn, name)

        def wrap(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(pt_attn, name, wrap)
    return seen


@pytest.mark.parametrize("budget,lq,lk,bias_shape,route", [
    (None, 30, 30, (1, 1), "fused_attention_reference"),  # under the budget: #3
    (None, 21, 30, None, "fused_attention_reference"),
    (100, 30, 30, (1, 1), "fused_attention_qblk_reference"),  # past it: #4
    (100, 30, 30, None, "fused_attention_qblk_reference"),
    (100, 21, 30, None, "fused_attention_reference"),  # cross-length past it
    (100, 30, 30, (2, 3), "fused_attention_reference"),  # per-(batch, head) bias
])
def test_router_picks_the_kernel_the_jax_package_picks(monkeypatch, budget, lq, lk,
                                                       bias_shape, route):
    """dot_product_attention's routes; under the budget it gives exactly
    fused_attention's result, as before the router existed."""
    if budget is not None:
        monkeypatch.setattr(pt_attn, "_SINGLE_MAX_ELEMS", budget)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, lq, 3, HD)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, lk, 3, HD)).astype(np.float32))
            for _ in range(2))
    bias = None
    if bias_shape is not None:
        bias = torch.from_numpy(rng.normal(size=bias_shape + (lq, lk)).astype(np.float32))
    seen = _spy(monkeypatch)
    got = pt_attn.dot_product_attention(q, k, v, bias)
    assert seen == [route]
    if route == "fused_attention_reference":
        torch.testing.assert_close(got, pt_attn.fused_attention(q, k, v, bias), rtol=0, atol=0)


@pytest.mark.parametrize("n,route", [(30, "_AttentionQKV"), (65, "fused_attention_qblk")])
def test_attention_qkv_keeps_the_packed_kernel_under_the_budget(monkeypatch, n, route):
    """attention_qkv at N * N <= 4096 stays on #1/#2 (the packed autograd
    Function), past it takes the q-blocked pair; both give the packed plain
    version's result and its gradient."""
    monkeypatch.setattr(pt_attn, "_SINGLE_MAX_ELEMS", 4096)
    calls = []
    for name in ("_AttentionQKV", "_FusedAttentionQblk"):
        cls = getattr(pt_attn, name)
        monkeypatch.setattr(cls, "apply", (lambda orig, nm: lambda *a: (
            calls.append(nm), orig(*a))[1])(cls.apply, name))
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.normal(size=(2, n, 3 * 2 * HD)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, n, 2 * HD)).astype(np.float32))
    bias = torch.from_numpy(build_attn_bias((1, 2, 5)).numpy()[..., :n, :n]) if n == 30 \
        else None
    x = qkv.clone().requires_grad_()
    out = pt_attn.attention_qkv(x, 2, bias)
    (dqkv,) = torch.autograd.grad(out, x, g)
    assert calls == [{"_AttentionQKV": "_AttentionQKV",
                      "fused_attention_qblk": "_FusedAttentionQblk"}[route]]
    torch.testing.assert_close(out, pt_attn.attention_qkv_reference(qkv, 2, bias),
                               rtol=0, atol=1e-6)
    want, _ = pt_attn.attention_qkv_bwd_reference(qkv, 2, bias, g)
    torch.testing.assert_close(dqkv, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("length,with_bias", [(2305, True), (2817, False)])
def test_past_the_jax_caps_the_port_keeps_the_qblk_kernel(monkeypatch, length, with_bias):
    """Past ``_QBLK_MAX_L_BIASED`` (2304) with a bias and ``_QBLK_MAX_L``
    (2816) without one the JAX package gives way to XLA; the port keeps the
    q-blocked route, which computes the same function (fp32 here; at bf16
    the two differ by the rounding of p before p v)."""
    assert length > (jax_attn._QBLK_MAX_L_BIASED if with_bias else jax_attn._QBLK_MAX_L)
    rng = np.random.default_rng(length)
    q, k, v = (rng.normal(size=(1, length, 1, HD)).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        bias = np.where(np.tril(np.ones((length, length), bool)), 0.0,
                        -np.inf).astype(np.float32)[None, None]
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        bias=None if bias is None else jnp.asarray(bias))
    seen = _spy(monkeypatch)
    got = pt_attn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v),
                                        None if bias is None else torch.from_numpy(bias))
    assert seen == ["fused_attention_qblk_reference"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL["float32"])


@pytest.mark.parametrize("bias_shape", [(2, 1, 9, 9), (1, 3, 9, 9), (1, 1, 9, 8)])
def test_rejects_an_unshared_or_malformed_bias(bias_shape):
    q = torch.zeros(2, 9, 3, HD)
    with pytest.raises(ValueError):
        pt_attn.fused_attention_qblk(q, q, q, torch.zeros(bias_shape))


def test_rejects_other_devices_and_cross_length_gradients():
    q = torch.empty(1, 3, 2, HD, device="meta")
    with pytest.raises(ValueError):
        pt_attn.fused_attention_qblk(q, q, q)
    qq = torch.zeros(1, 3, 2, HD, requires_grad=True)
    kk = torch.zeros(1, 5, 2, HD, requires_grad=True)
    out = pt_attn.fused_attention_qblk(qq, kk, kk)
    with pytest.raises(ValueError):
        out.sum().backward()
