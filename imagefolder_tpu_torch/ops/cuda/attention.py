"""Attention on the packed qkv projection output
(counterpart of ``imagefolder_tpu/ops/pallas/attention.py::attention_qkv``).

``attention_qkv`` dispatches on the tensor's device only: a CPU tensor goes to
``attention_qkv_reference``, the plain PyTorch version; a CUDA tensor launches
the hand-written kernel in ``csrc/attention_qkv.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from imagefolder_tpu_torch.ops.cuda import _build

__all__ = ["attention_qkv", "attention_qkv_reference", "LAUNCHES"]

# kernel launches since the counter was last reset (a caller sets it to 0)
LAUNCHES = 0

_HEAD_DIM = 64  # the kernel's compiled head width (every DINOv2 preset)


def _check(qkv: torch.Tensor, heads: int, bias: Optional[torch.Tensor]):
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % heads:
        raise ValueError(f"qkv must be (B, N, 3C) with C divisible by heads={heads}; "
                         f"got {tuple(qkv.shape)}")
    n = qkv.shape[1]
    if bias is not None and tuple(bias.shape) != (1, 1, n, n):
        raise ValueError("packed kernel supports a batch/head-shared bias of shape "
                         f"(1, 1, {n}, {n}) only; got {tuple(bias.shape)}")


def attention_qkv_reference(qkv: torch.Tensor, heads: int,
                            bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the TPU kernel's numerics:
    fp32 scores and softmax, p rounded to the input dtype before p v, the row
    sum taken on the fp32 p, and o / l at the end."""
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(qkv.dtype).float(), v.float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, c)


@functools.cache
def _kernel():
    fn = _build.load_library().attention_qkv_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _attention_qkv_cuda(qkv, heads, bias, scale):
    global LAUNCHES
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if scale is None:
        scale = 1.0 / math.sqrt(c // heads)
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention_qkv kernel takes bf16 or fp32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("attention_qkv kernel needs a contiguous qkv")
    if c // heads != _HEAD_DIM:
        raise NotImplementedError(
            f"attention_qkv kernel is built for head dim {_HEAD_DIM}, got {c // heads}")
    if bias is not None:
        if bias.device != qkv.device:
            raise ValueError("bias and qkv must be on the same device")
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(qkv.data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), b, n, c, heads, float(scale),
                        int(qkv.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def attention_qkv(qkv: torch.Tensor, heads: int,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per head, from the packed projection.

    qkv: (B, N, 3C) as the fused Linear(3C) produces it, i.e. the
    (B, N, 3, H, hd) view holds q/k/v at index 0/1/2 of axis 2. Returns
    (B, N, C) in qkv's dtype, head h at columns h*hd. bias, if given, is
    (1, 1, N, N), shared by batches and heads, and may hold -inf. The default
    scale is 1/sqrt(hd).
    """
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, heads, bias, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv runs on cpu or cuda, not {qkv.device}")
    return _attention_qkv_cuda(qkv, heads, bias, scale)
