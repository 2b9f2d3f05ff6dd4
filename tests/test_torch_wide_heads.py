"""Port parity, the BNHD attention kernels (#3-#6) at heads wider than 64 or
not a multiple of 8: ``imagefolder_tpu_torch/ops/cuda/attention.py`` on the
CPU against the JAX package's Pallas kernels in interpret mode, and the
padding the wrapper does before a launch on the card.

- the plain versions of #3 and #6 at RAR-XL's head dim 80, RAR-XXL's 88,
  128 and the unaligned 36 and 100 (a small block-causal shape), against
  ``fused_attention`` and ``_fused_attention_bwd_impl(..., interpret=True)``,
  and the q-blocked pair's (#4, #5) at 100 against
  ``_fused_attention_qblk_fwd`` / ``_bwd``;
- the padding: q, k and v zero-padded to the next multiple of 8 by
  ``_kernel_operands``, the plain attention of the padded inputs at the
  true width's scale, cut back by ``_cut_head``, equals the plain attention
  of the unpadded inputs, forward and backward (the gradient's padded
  columns are exact zeros, dbias unchanged), as do both autograd paths;
- ``_kernel_operands`` takes every width from 1 to 256 (the multiples of 8
  as they are) and raises NotImplementedError above 256, before any launch.

Tolerances: fp32 within 1e-5 of the JAX kernels; the padded plain versions
within 1e-6 of the unpadded ones (zero columns add exact zeros; only the
matmul's blocking may differ).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagefolder_tpu.ops.pallas.attention import (
    _fused_attention_bwd_impl,
    _fused_attention_qblk_bwd,
    _fused_attention_qblk_fwd,
    fused_attention as jax_fused_attention,
)
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from tests._torch_parity import one_torch_thread  # noqa: F401


WIDE = [80, 88, 128, 36, 100]
TOL, PAD_TOL = 1e-5, 1e-6


def _inputs(b, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, h, hd)).astype(np.float32) for _ in range(4)]


def _bias(l: int, seed: int) -> np.ndarray:
    bias = np.random.default_rng(seed).normal(size=(1, 1, l, l)).astype(np.float32)
    bias[..., -3:] = -np.inf  # the last keys masked for every row
    return bias


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


@pytest.mark.parametrize("hd", WIDE)
def test_bnhd_plain_versions_match_pallas_at_wide_heads(hd):
    """#3 and #6 under VAR's block-causal bias at L = 14, at head dim hd."""
    q, k, v, g = _inputs(2, 14, 3, hd, hd)
    bias = build_attn_bias((1, 2, 3)).numpy()
    scale = 1.0 / math.sqrt(hd)
    want = jax_fused_attention(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(bias),
                               scale=scale, interpret=True)
    got = pt_attn.fused_attention_reference(*(torch.from_numpy(t) for t in (q, k, v)),
                                            torch.from_numpy(bias), scale)
    _close(got, want, TOL, "#3")
    want = _fused_attention_bwd_impl(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(bias),
                                     jnp.asarray(g), scale=scale, interpret=True)
    got = pt_attn.fused_attention_bwd_reference(*(torch.from_numpy(t) for t in (q, k, v)),
                                                torch.from_numpy(bias), torch.from_numpy(g),
                                                scale)
    for a, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        _close(a, w, TOL, f"#6 {name}")


def test_qblk_plain_versions_match_pallas_at_head_dim_100():
    hd, l = 100, 20
    q, k, v, g = _inputs(1, l, 2, hd, 7)
    bias = _bias(l, 8)
    scale = 1.0 / math.sqrt(hd)
    jq = [jnp.asarray(t) for t in (q, k, v)]
    want = _fused_attention_qblk_fwd(*jq, jnp.asarray(bias), scale=scale, interpret=True)
    got = pt_attn.fused_attention_qblk_reference(*(torch.from_numpy(t) for t in (q, k, v)),
                                                 torch.from_numpy(bias), scale)
    _close(got, want, TOL, "#4")
    want = _fused_attention_qblk_bwd(*jq, jnp.asarray(bias), jnp.asarray(g), scale=scale,
                                     interpret=True)
    got = pt_attn.fused_attention_qblk_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(bias),
        torch.from_numpy(g), scale)
    for a, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        _close(a, w, TOL, f"#5 {name}")


@pytest.mark.parametrize("hd", [36, 100, 12, 1, 127])
@pytest.mark.parametrize("qblk", [False, True], ids=["bnhd", "qblk"])
def test_padding_wrapper_is_exact(hd, qblk):
    """What the wrapper does around a launch at an unaligned width, with
    the plain versions standing in for the kernels: pad, run at the true
    width's scale, cut back."""
    fwd = pt_attn.fused_attention_qblk_reference if qblk else pt_attn.fused_attention_reference
    bwd = (pt_attn.fused_attention_qblk_bwd_reference if qblk
           else pt_attn.fused_attention_bwd_reference)
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(2, 11, 3, hd, hd + 1))
    bias = torch.from_numpy(_bias(11, 3))
    scale = 1.0 / math.sqrt(hd)
    qp, kp, vp, bp = pt_attn._kernel_operands(q, k, v, bias, "test")
    wide = -(-hd // 8) * 8
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == wide
    gp = pt_attn._pad_head(g, wide)
    out_p = fwd(qp, kp, vp, bp, scale)
    assert not out_p[..., hd:].any()  # v's zero columns give zero outputs
    out, = pt_attn._cut_head(hd, out_p)
    assert out.shape == q.shape and out.is_contiguous()
    _close(out, fwd(q, k, v, bias, scale).numpy(), PAD_TOL, "forward")
    got = bwd(qp, kp, vp, bp, gp, scale)
    want = bwd(q, k, v, bias, g, scale)
    for a in got[:3]:
        assert not a[..., hd:].any()  # the padded columns' gradients are exact zeros
    for a, w, name in zip((*pt_attn._cut_head(hd, *got[:3]), got[3]), want,
                          ("dq", "dk", "dv", "dbias")):
        _close(a, w.numpy(), PAD_TOL, name)
    # autograd through the public entry, padded and not, gives the same gradients
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    entry = pt_attn.fused_attention_qblk if qblk else pt_attn.fused_attention
    grads = torch.autograd.grad(entry(*leaves, bias, scale), leaves, g)
    for a, w, name in zip(grads, want[:3], ("dq", "dk", "dv")):
        _close(a, w.numpy(), PAD_TOL, f"autograd {name}")


@pytest.mark.parametrize("hd", [1, 7, 8, 44, 64, 72, 80, 88, 120, 127, 128, 129, 136, 256,
                                200, 250, 257, 264, 512])
def test_kernel_operands_take_every_width_up_to_128(hd):
    """Every width up to 256 passes (the kD = 128 code past 64, the kD = 256
    code past 128), zero-padded to a multiple of 8; a wider head raises."""
    q, k, v = (torch.ones((1, 3, 2, hd)) for _ in range(3))
    if hd > 256:
        with pytest.raises(NotImplementedError, match=f"head dims up to 256.*got {hd}"):
            pt_attn._kernel_operands(q, k, v, None, "fused_attention")
        for call in (pt_attn._fused_attention_cuda, pt_attn._fused_attention_qblk_cuda):
            with pytest.raises(NotImplementedError, match="head dims"):
                call(q, k, v, None, 1.0)
        return
    qp, kp, vp, _ = pt_attn._kernel_operands(q, k, v, None, "fused_attention")
    assert qp.shape[-1] == -(-hd // 8) * 8
    assert (qp is q) == (hd % 8 == 0)
