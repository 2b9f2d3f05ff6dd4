"""Attention kernels (counterpart of ``imagefolder_tpu/ops/pallas/attention.py``).

- ``attention_qkv``: attention on the packed qkv projection output of a ViT
  block (TPU kernel ``_attention_qkv_fwd_impl``), kernel
  ``csrc/attention_qkv.cu``, launches counted in ``LAUNCHES``;
- ``fused_attention``: attention on (B, L, H, hd) views with Lq <= Lk and an
  optional bias, as VAR calls it (TPU kernel ``fused_attention``), kernel
  ``csrc/attention_bnhd.cu``, launches counted in ``FUSED_LAUNCHES``.

Each dispatches on the tensor's device only: a CPU tensor goes to its
``*_reference``, the plain PyTorch version; a CUDA tensor launches the
hand-written kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from imagefolder_tpu_torch.ops.cuda import _build

__all__ = ["attention_qkv", "attention_qkv_reference", "fused_attention",
           "fused_attention_reference", "LAUNCHES", "FUSED_LAUNCHES"]

# kernel launches since the counter was last reset (a caller sets it to 0):
# attention_qkv's and fused_attention's
LAUNCHES = 0
FUSED_LAUNCHES = 0

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


def _check_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor]):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Lq, H, hd) and k, v (B, Lk, H, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if bias is not None:
        lk = k.shape[1]
        if (bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
                or tuple(bias.shape[2:]) != (lq, lk)):
            raise ValueError(f"bias must be (1|{b}, 1|{h}, {lq}, {lk}); "
                             f"got {tuple(bias.shape)}")


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the TPU kernel's numerics:
    fp32 scores and softmax, p divided by its row sum and then rounded to
    the input dtype before p v."""
    _check_bnhd(q, k, v, bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, L, hd)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), vf)
    return o.to(q.dtype).transpose(1, 2).contiguous()


@functools.cache
def _fused_kernel():
    fn = _build.load_library().attention_bnhd_fwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [i64p] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor, dims) -> ctypes.Array:
    """Element strides of ``t`` at ``dims``, 0 where the size is 1."""
    return (ctypes.c_int64 * 3)(*(t.stride(d) if t.shape[d] != 1 else 0 for d in dims))


def _fused_attention_cuda(q, k, v, bias, scale):
    global FUSED_LAUNCHES
    _check_bnhd(q, k, v, bias)
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("fused_attention kernel takes q, k, v all bf16 or all fp32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd != _HEAD_DIM:
        raise NotImplementedError(
            f"fused_attention kernel is built for head dim {_HEAD_DIM}, got {hd}")
    if not (k.device == v.device == q.device and (bias is None or bias.device == q.device)):
        raise ValueError("q, k, v and bias must be on the same device")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if bias is not None:
        bias = bias.to(torch.float32)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
    if 0 in (b, lq, h, lk):
        raise ValueError(f"fused_attention needs non-empty inputs; got {tuple(q.shape)}, "
                         f"Lk={lk}")
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=q.device)
    bs = _strides(bias, (0, 1, 2)) if bias is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fused_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, lq, lk, h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)),
            _strides(v, (0, 1, 2)), bs, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA error {err}")
    FUSED_LAUNCHES += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per (batch, head).

    q: (B, Lq, H, hd); k, v: (B, Lk, H, hd), any strides with the last one 1
    (a view of a fused projection or of a KV cache is read in place). bias,
    if given, is (1|B, 1|H, Lq, Lk), fp32 or cast to it, and may hold -inf;
    an axis of size 1 is shared, never broadcast in memory. The default scale
    is 1/sqrt(hd). Returns a contiguous (B, Lq, H, hd) in q's dtype.
    """
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    return _fused_attention_cuda(q, k, v, bias, scale)
