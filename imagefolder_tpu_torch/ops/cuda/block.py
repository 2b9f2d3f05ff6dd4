"""ViT block sublayers (counterpart of ``imagefolder_tpu/ops/pallas/block.py``).

The composed paths, which are the JAX package's default: projections are
PyTorch matmuls, the attention goes through the packed-qkv kernel. Numerics
follow the flax Dense layers op for op: y = dtype(x @ W) + dtype(b), and the
residual add runs in fp32 through the fp32 LayerScale. Weights are in the
PyTorch (out, in) layout. The fused sublayer kernels (``IMGF_FUSE_ATTN`` /
``IMGF_FUSE_MLP`` on the TPU, off by default there) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda.attention import attention_qkv

__all__ = ["attn_sublayer", "dense", "mlp_sublayer"]


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax Dense(dtype=x.dtype) on fp32 params: x @ W and + b in x's dtype."""
    act = x.dtype
    return F.linear(x, w.to(act)) + b.to(act)


def attn_sublayer(xn: torch.Tensor, res: torch.Tensor, wq, bq, wp, bp, ls,
                  heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """res + ls * proj(attn(qkv(xn))). xn: LayerNorm output in the activation
    dtype; res: residual stream. Returns fp32."""
    qkv = dense(xn, wq, bq)
    o = attention_qkv(qkv, heads, bias=mask)
    return res.float() + ls * dense(o, wp, bp)


def mlp_sublayer(xn: torch.Tensor, res: torch.Tensor, w1, b1, w2, b2,
                 ls) -> torch.Tensor:
    """res + ls * fc2(gelu_exact(fc1(xn))). Returns fp32."""
    h = gelu_exact(dense(xn, w1, b1))
    return res.float() + ls * dense(h, w2, b2)
