"""Port parity, BNHD attention: ``imagefolder_tpu_torch.ops.cuda.attention.
fused_attention`` against the JAX ``fused_attention`` run through Pallas's
interpreter on the CPU, on the same numpy-seeded inputs; its backward
``fused_attention_bwd_reference`` against ``_fused_attention_bwd_impl`` in
interpret mode; and the port's autograd against ``jax.vjp`` of the
dispatcher VAR calls (``dot_product_attention``, XLA on the CPU).

On a CPU tensor the port runs its plain PyTorch version, whose numerics are
the Pallas kernel's: fp32 scores and softmax, p divided by its row sum and
rounded to the input type before p v. Tolerances: fp32 1e-5 max abs (only the
summation order differs); bf16 2e-2 (one bf16 rounding of O(1) outputs, and
of p, placed alike on both sides). Gradients: fp32 1e-5 and bf16 2e-2 of the
largest magnitude of each gradient (dq, dk, dv, dbias).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from imagefolder_tpu.models.var import build_attn_bias as jax_build_attn_bias
from imagefolder_tpu.ops.pallas.attention import _fused_attention_bwd_impl
from imagefolder_tpu.ops.pallas.attention import dot_product_attention as jax_dpa
from imagefolder_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
HD = 64


def _qkv(b, lq, lk, h, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, HD)).astype(np.float32)
    k = rng.normal(size=(b, lk, h, HD)).astype(np.float32)
    v = rng.normal(size=(b, lk, h, HD)).astype(np.float32)
    return q, k, v


def _compare(q, k, v, bias, dtype, scale=None):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jax_fused_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        None if bias is None else jnp.asarray(bias), scale=scale, interpret=True)
    got = pt_attn.fused_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), None if bias is None else torch.from_numpy(bias),
        scale=scale)
    assert got.shape == q.shape and got.dtype == tdt and got.is_contiguous()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_causal_self_attention(dtype):
    """Lq == Lk = 30 (patch_nums 1..4, not a multiple of 8) under VAR's
    shared block-causal bias: the first row sees one key only."""
    pns = (1, 2, 3, 4)
    bias = build_attn_bias(pns).numpy()
    np.testing.assert_array_equal(bias, jax_build_attn_bias(pns))
    q, k, v = _qkv(2, 30, 30, 3)
    _compare(q, k, v, bias, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(9, 14), (1, 5), (13, 13), (4, 77)])
def test_cached_decode_shapes_without_bias(dtype, lq, lk):
    """The KV-cached decode: Lq new rows against Lk >= Lq cached keys, Lq = 1
    at the first stage, ragged lengths."""
    q, k, v = _qkv(2, lq, lk, 2, seed=lq * 100 + lk)
    _compare(q, k, v, None, dtype, scale=0.25 / np.sqrt(HD))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3), (1, 3), (2, 1)])
def test_per_batch_and_head_bias(dtype, shape):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(2, 11, 19, 3, seed=3)
    bias = rng.normal(size=shape + (11, 19)).astype(np.float32)
    bias[..., 2:5] = -np.inf  # masked columns in every row
    _compare(q, k, v, bias, dtype)


def test_strided_views_are_read_in_place():
    """q, k, v as the (B, L, 3, H, hd) views of a fused projection give the
    same result as contiguous copies, and are not copied by the wrapper's
    checks."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 14, 3, 2, HD)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    bias = build_attn_bias((1, 2, 3))
    got = pt_attn.fused_attention(q, k, v, bias)
    want = pt_attn.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 3, 5, 2))
    before = pt_attn.FUSED_LAUNCHES
    got = pt_attn.fused_attention(q, k, v)
    torch.testing.assert_close(got, pt_attn.fused_attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert pt_attn.FUSED_LAUNCHES == before


@pytest.mark.parametrize("bias_shape", [(1, 1, 3, 4), (3, 1, 3, 5), (1, 2, 5, 5)])
def test_rejects_malformed_bias(bias_shape):
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 3, 5, 2))
    with pytest.raises(ValueError):
        pt_attn.fused_attention(q, k, v, torch.zeros(bias_shape))


def test_rejects_other_devices():
    q = torch.empty(1, 3, 2, HD, device="meta")
    with pytest.raises(ValueError):
        pt_attn.fused_attention(q, q, q)


# ------------------------------- backward ------------------------------- #

def _rel_close(got, want, tol, name):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(want).all(), name
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "block_causal", "dense"])
def test_bwd_reference_matches_pallas_interpret(dtype, bias_kind):
    """dq, dk, dv (and dbias) of the plain backward against the Pallas
    backward kernel in interpret mode, L = 37 (ragged), 3 heads."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    b, l, h = 2, 37, 3
    q, k, v = _qkv(b, l, l, h, seed=21)
    g = np.random.default_rng(22).normal(size=q.shape).astype(np.float32)
    bias = None
    if bias_kind == "block_causal":
        bias = build_attn_bias((1, 2, 3, 4) + (1,) * 7).numpy()  # L = 37
    elif bias_kind == "dense":
        bias = np.random.default_rng(23).normal(size=(1, 1, l, l)).astype(np.float32)
        bias[..., 30:] = -np.inf
    want = _fused_attention_bwd_impl(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), None if bias is None else jnp.asarray(bias),
        jnp.asarray(g, jdt), scale=0.3, interpret=True)
    got = pt_attn.fused_attention_bwd_reference(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), torch.from_numpy(g).to(tdt), 0.3)
    for a, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        if w is None:
            assert a is None
            continue
        assert a.dtype == (torch.float32 if name == "dbias" else tdt)
        _rel_close(a, np.asarray(jnp.asarray(w, jnp.float32)), TOL[dtype], name)


def _vjp_case(b, lq, lk, h, bias_shape, seed):
    q, k, v = _qkv(b, lq, lk, h, seed=seed)
    rng = np.random.default_rng(seed + 1)
    g = rng.normal(size=q.shape).astype(np.float32)
    bias = None
    if bias_shape is not None:
        bias = rng.normal(size=bias_shape).astype(np.float32)
        bias[..., :, -2:] = -np.inf  # masked keys, every row keeps the rest
    return q, k, v, bias, g


@pytest.mark.parametrize("case", [
    ("self, no bias", (2, 19, 19, 2), None),
    ("self, shared bias", (2, 19, 19, 2), (1, 1, 19, 19)),
    ("cross-length, no bias", (2, 7, 19, 2), None),
    ("cross-length, shared bias", (2, 7, 19, 2), (1, 1, 7, 19)),
    ("per-(B,H) bias", (2, 19, 19, 2), (2, 2, 19, 19)),
], ids=lambda c: c[0])
def test_autograd_matches_jax_vjp(case):
    """The port's gradients of fused_attention, dbias included, against
    jax.vjp of the JAX dispatcher: the backward kernel's path (self-attention
    with no bias or a shared bias) and the plain-forward recompute (cross
    length, per-(batch, head) bias)."""
    _, shape, bias_shape = case
    q, k, v, bias, g = _vjp_case(*shape, bias_shape, seed=sum(shape))
    args = [jnp.asarray(t) for t in (q, k, v)] + ([jnp.asarray(bias)] if bias is not None else [])
    _, vjp = jax.vjp(lambda *a: jax_dpa(*a[:3], bias=a[3] if len(a) > 3 else None, scale=0.4),
                     *args)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    before = pt_attn.FUSED_BWD_LAUNCHES
    out = pt_attn.fused_attention(*ts, tb, scale=0.4)
    out.backward(torch.from_numpy(g))
    assert pt_attn.FUSED_BWD_LAUNCHES == before  # the CPU never launches a kernel
    got = [t.grad for t in ts] + ([tb.grad] if tb is not None else [])
    for a, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        _rel_close(a, w, TOL["float32"], name)


def test_dbias_only_when_the_bias_needs_it():
    """VAR's bias is a constant buffer: its backward computes no dbias, and
    the bias keeps no gradient; the other gradients are unchanged by it."""
    q, k, v, bias, g = _vjp_case(1, 11, 11, 2, (1, 1, 11, 11), seed=5)
    grads = []
    for needs in (False, True):
        ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
        tb = torch.from_numpy(bias).requires_grad_(needs)
        pt_attn.fused_attention(*ts, tb).backward(torch.from_numpy(g))
        assert (tb.grad is not None) == needs
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dq, dk, dv, dbias = pt_attn.fused_attention_bwd(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(bias), torch.from_numpy(g),
        need_dbias=False)
    assert dbias is None and dq.is_contiguous() and dq.shape == q.shape


@pytest.mark.parametrize("shapes", [((1, 3, 2, 64), (1, 5, 2, 64), None),
                                    ((2, 5, 2, 64), (2, 5, 2, 64), (2, 1, 5, 5))])
def test_bwd_rejects_what_the_kernel_does_not_take(shapes):
    """The backward kernel covers Lq == Lk with no bias or a shared bias;
    the dispatcher recomputes the rest, and the kernel's wrapper refuses it."""
    qs, ks, bs = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    bias = None if bs is None else torch.zeros(bs)
    with pytest.raises(ValueError):
        pt_attn.fused_attention_bwd(q, k, k, bias, torch.zeros(qs))
