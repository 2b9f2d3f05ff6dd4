"""Port parity, BNHD attention: ``imagefolder_tpu_torch.ops.cuda.attention.
fused_attention`` against the JAX ``fused_attention`` run through Pallas's
interpreter on the CPU, on the same numpy-seeded inputs.

On a CPU tensor the port runs its plain PyTorch version, whose numerics are
the Pallas kernel's: fp32 scores and softmax, p divided by its row sum and
rounded to the input type before p v. Tolerances: fp32 1e-5 max abs (only the
summation order differs); bf16 2e-2 (one bf16 rounding of O(1) outputs, and
of p, placed alike on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagefolder_tpu.models.var import build_attn_bias as jax_build_attn_bias
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
