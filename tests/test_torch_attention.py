"""Port parity, kernel modules: ``imagefolder_tpu_torch/ops`` against the JAX
package on the CPU.

On a CPU tensor the port's ``attention_qkv`` runs its plain PyTorch version,
forward and backward; they are held against the JAX Pallas kernels
(``_attention_qkv_fwd_impl``, ``_attention_qkv_bwd_impl``) run in interpret
mode, and the port's autograd against ``jax.vjp`` of the JAX
``attention_qkv``. The CUDA kernels themselves are checked against the plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.ops import activations as jax_act
from imagefolder_tpu.ops.pallas import block as jax_block
from imagefolder_tpu.ops.pallas.attention import (
    _attention_qkv_bwd_impl,
    _attention_qkv_fwd_impl,
)
from imagefolder_tpu.ops.pallas.attention import attention_qkv as jax_attention_qkv
from imagefolder_tpu_torch.ops import activations as pt_act
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.ops.cuda import block as pt_block


def _shared_mask(n, nl):
    """The encoder's use_attn_mask bias: the first n - nl rows cannot attend
    to the last nl columns; plus finite noise so the bias add is exercised."""
    rng = np.random.default_rng(7)
    bias = rng.normal(size=(n, n)).astype(np.float32)
    bias[: n - nl, n - nl:] = -np.inf
    return bias[None, None]


def _qkv(b, n, c, seed=0):
    return np.random.default_rng(seed).normal(size=(b, n, 3 * c)).astype(np.float32)


# N not a multiple of 8 (and one more than 64, so two k/v tiles of the kernel)
@pytest.mark.parametrize("n", [37, 66])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_qkv_matches_pallas_interpret_fp32(n, masked):
    heads, c = 2, 32
    qkv = _qkv(2, n, c)
    bias = _shared_mask(n, 5) if masked else None
    want = _attention_qkv_fwd_impl(
        jnp.asarray(qkv), None if bias is None else jnp.asarray(bias),
        heads=heads, scale=None, interpret=True)
    got = pt_attn.attention_qkv(
        torch.from_numpy(qkv), heads, None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == (2, n, c)
    # fp32 on both sides; only summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_attention_qkv_matches_pallas_interpret_bf16():
    heads, c, n = 2, 32, 37
    qkv = _qkv(2, n, c, seed=1)
    want = _attention_qkv_fwd_impl(jnp.asarray(qkv, jnp.bfloat16), None,
                                   heads=heads, scale=None, interpret=True)
    got = pt_attn.attention_qkv(torch.from_numpy(qkv).bfloat16(), heads)
    assert got.dtype == torch.bfloat16
    # bf16 rounding of p and of the output (8 mantissa bits) at |o| <~ 2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    qkv = torch.from_numpy(_qkv(1, 9, 32))
    before = pt_attn.LAUNCHES
    got = pt_attn.attention_qkv(qkv, 2, scale=0.3)
    assert pt_attn.LAUNCHES == before
    torch.testing.assert_close(
        got, pt_attn.attention_qkv_reference(qkv, 2, scale=0.3), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 1, 9, 9), (1, 2, 9, 9), (1, 1, 9, 8)])
def test_attention_qkv_rejects_unshared_bias(shape):
    qkv = torch.from_numpy(_qkv(2, 9, 32))
    with pytest.raises(ValueError, match="shared bias"):
        pt_attn.attention_qkv(qkv, 2, bias=torch.zeros(shape))


def test_attention_qkv_rejects_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_attn.attention_qkv(torch.empty(1, 9, 96, device="meta"), 2)


def test_gelu_exact_matches_jax():
    x = np.random.default_rng(3).normal(scale=3.0, size=(4096,)).astype(np.float32)
    want = np.asarray(jax_act.gelu_exact(jnp.asarray(x)))
    got = pt_act.gelu_exact(torch.from_numpy(x)).numpy()
    # the JAX package's A&S erf is within 1.5e-7 of the exact erf; |x| <~ 12
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sublayers_match_jax(dtype):
    rng = np.random.default_rng(4)
    b, n, c, heads = 2, 21, 32, 2
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    xn, res = f32(b, n, c), f32(b, n, c)
    wq, bq, wp, bp = f32(c, 3 * c, scale=0.2), f32(3 * c), f32(c, c, scale=0.2), f32(c)
    w1, b1, w2, b2 = f32(c, 4 * c, scale=0.2), f32(4 * c), f32(4 * c, c, scale=0.1), f32(c)
    ls = f32(c)
    mask = _shared_mask(n, 4)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    # the residual enters in the activation dtype, as into block 0
    want_a = jax_block.attn_sublayer(J(xn).astype(jd), J(res).astype(jd), J(wq).astype(jd),
                                     J(bq), J(wp).astype(jd), J(bp), J(ls), heads,
                                     mask=J(mask))
    got_a = pt_block.attn_sublayer(T(xn).to(td), T(res).to(td), T(wq.T), T(bq), T(wp.T),
                                   T(bp), T(ls), heads, mask=T(mask))
    want_m = jax_block.mlp_sublayer(J(xn).astype(jd), J(res).astype(jd), J(w1).astype(jd),
                                    J(b1), J(w2).astype(jd), J(b2), J(ls))
    got_m = pt_block.mlp_sublayer(T(xn).to(td), T(res).to(td), T(w1.T), T(b1), T(w2.T),
                                  T(b2), T(ls))
    # fp32: summation order only. bf16: one bf16 rounding of |y| <~ 4 times
    # |ls| <~ 3, and the XLA path normalizes p before rounding it
    tol = 1e-5 if dtype == "float32" else 6e-2
    for got, want in ((got_a, want_a), (got_m, want_m)):
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


# ------------------------- backward (kernel #2) ------------------------- #

@pytest.mark.parametrize("n", [37, 66])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_qkv_bwd_matches_pallas_interpret_fp32(n, masked):
    heads, c = 2, 128  # head dim 64, as the kernel
    qkv = _qkv(2, n, c, seed=2)
    g = np.random.default_rng(3).normal(size=(2, n, c)).astype(np.float32)
    bias = _shared_mask(n, 5) if masked else None
    want_dqkv, want_db = _attention_qkv_bwd_impl(
        jnp.asarray(qkv), None if bias is None else jnp.asarray(bias), jnp.asarray(g),
        heads=heads, scale=None, interpret=True)
    dqkv, dbias = pt_attn.attention_qkv_bwd_reference(
        torch.from_numpy(qkv), heads, None if bias is None else torch.from_numpy(bias),
        torch.from_numpy(g))
    assert dqkv.shape == (2, n, 3 * c) and dqkv.dtype == torch.float32
    # fp32 on both sides; only summation order differs
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), rtol=0, atol=1e-5)
    assert (dbias is None) == (want_db is None)
    if masked:
        assert dbias.shape == (1, 1, n, n)
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_db), rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_qkv_bwd_matches_pallas_interpret_bf16(masked):
    heads, c, n = 2, 128, 37
    qkv = _qkv(2, n, c, seed=4)
    g = np.random.default_rng(5).normal(size=(2, n, c)).astype(np.float32)
    bias = _shared_mask(n, 5) if masked else None
    want, want_db = _attention_qkv_bwd_impl(
        jnp.asarray(qkv, jnp.bfloat16), None if bias is None else jnp.asarray(bias),
        jnp.asarray(g, jnp.bfloat16), heads=heads, scale=None, interpret=True)
    got, dbias = pt_attn.attention_qkv_bwd_reference(
        torch.from_numpy(qkv).bfloat16(), heads,
        None if bias is None else torch.from_numpy(bias), torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # bf16 inputs, bf16(p) and bf16(ds) on both sides, bf16 outputs: within
    # 2e-2 of the largest gradient
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    if masked:  # ds is fp32 on both sides
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_db), rtol=0,
                                   atol=2e-2 * np.abs(np.asarray(want_db)).max())


@pytest.mark.parametrize("bias_grad", [None, False, True])
def test_attention_qkv_autograd_matches_jax_vjp(bias_grad):
    """The port's gradient of attention_qkv (its plain backward on the CPU)
    against jax.vjp of the JAX attention_qkv (XLA's attention off the TPU),
    dbias included when the bias requires a gradient."""
    heads, c, n = 2, 128, 21
    qkv = _qkv(3, n, c, seed=6)
    g = np.random.default_rng(7).normal(size=(3, n, c)).astype(np.float32)
    bias = None if bias_grad is None else _shared_mask(n, 4)
    out, vjp = jax.vjp(lambda q, b: jax_attention_qkv(q, heads, bias=b), jnp.asarray(qkv),
                       None if bias is None else jnp.asarray(bias))
    want_dqkv, want_db = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(bias_grad)
    got = pt_attn.attention_qkv(tq, heads, tb)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_dqkv), rtol=0, atol=1e-5)
    if bias_grad:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_db), rtol=0, atol=1e-5)
    elif tb is not None:
        assert tb.grad is None


def test_cpu_backward_counts_nothing():
    qkv = torch.from_numpy(_qkv(2, 9, 128)).requires_grad_()
    before = (pt_attn.LAUNCHES, pt_attn.BWD_LAUNCHES)
    pt_attn.attention_qkv(qkv, 2).sum().backward()
    assert (pt_attn.LAUNCHES, pt_attn.BWD_LAUNCHES) == before
    assert qkv.grad.shape == qkv.shape
