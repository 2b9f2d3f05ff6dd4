"""Port parity, the BNHD attention kernels (#3-#6) at head widths of 136-256
(the kD = 256 kernels of ``csrc/attention_wide.cuh`` on the card): the
port's router ``dot_product_attention`` on the CPU against the JAX
package's at 136, 200 and 256: the forward against ``fused_attention``
(Pallas, interpret mode), the gradients through autograd against the
Pallas backward ``_fused_attention_bwd_impl`` (interpret mode, what the
JAX router's custom VJP runs on the TPU) and against ``jax.vjp`` of the
JAX router (XLA on the CPU); the unaligned 250
zero-padded to 256 before a launch; and widths above 256 refused by every
wrapper before any launch.

Tolerances: fp32, 1e-5 of the JAX result's max abs (as
``test_torch_wide_heads.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.ops.pallas.attention import (
    _fused_attention_bwd_impl,
    dot_product_attention as jax_router,
    fused_attention as jax_fused_attention,
)
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from tests._torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0), err_msg=what)


@pytest.mark.parametrize("hd", [136, 200, 256])
def test_router_matches_pallas_and_vjp_at_wide_heads(hd):
    """``dot_product_attention`` under VAR's block-causal bias at L = 14,
    forward and the three input gradients."""
    rng = np.random.default_rng(hd)
    q, k, v, g = (rng.normal(size=(2, 14, 2, hd)).astype(np.float32) for _ in range(4))
    bias = build_attn_bias((1, 2, 3)).numpy()
    scale = 1.0 / math.sqrt(hd)

    jq = [jnp.asarray(t) for t in (q, k, v)]
    want = jax_fused_attention(*jq, jnp.asarray(bias), scale=scale, interpret=True)
    pallas_grads = _fused_attention_bwd_impl(*jq, jnp.asarray(bias), jnp.asarray(g),
                                             scale=scale, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jax_router(q, k, v, jnp.asarray(bias), scale), *jq)
    vjp_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = pt_attn.dot_product_attention(*leaves, torch.from_numpy(bias), scale)
    _close(got, want, "forward")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for a, wp, wv, name in zip(grads, pallas_grads, vjp_grads, ("dq", "dk", "dv")):
        _close(a, wp, f"{name} against the Pallas backward")
        _close(a, wv, f"{name} against jax.vjp")


def test_unaligned_width_is_padded_to_256():
    """250 is zero-padded to 256, the kD = 256 code's width; the padded
    columns are zero and the true ones untouched."""
    q, k, v = (torch.randn((1, 3, 2, 250)) for _ in range(3))
    qp, kp, vp, _ = pt_attn._kernel_operands(q, k, v, None, "fused_attention")
    for x, y in zip((qp, kp, vp), (q, k, v)):
        assert x.shape[-1] == 256
        assert torch.equal(x[..., :250], y) and not x[..., 250:].any()


@pytest.mark.parametrize("hd", [257, 264, 512])
def test_wider_heads_raise_before_any_launch(hd):
    """Every wrapper's CUDA path refuses a head above 256 in its checks,
    which come before the library is loaded or a kernel launched (so CPU
    tensors reach them), and no launch is counted."""
    q, k, v = (torch.ones((1, 5, 2, hd)) for _ in range(3))
    bias = torch.zeros((1, 1, 5, 5))
    names = ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES", "QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES")
    before = [getattr(pt_attn, n) for n in names]
    for call in (pt_attn._fused_attention_cuda, pt_attn._fused_attention_qblk_cuda):
        with pytest.raises(NotImplementedError, match=f"head dims up to 256.*got {hd}"):
            call(q, k, v, bias, 1.0)
    for call in (pt_attn._fused_attention_bwd_cuda, pt_attn._fused_attention_qblk_bwd_cuda):
        with pytest.raises(NotImplementedError, match=f"head dims up to 256.*got {hd}"):
            call(q, k, v, bias, q, 1.0, False)
    assert [getattr(pt_attn, n) for n in names] == before
