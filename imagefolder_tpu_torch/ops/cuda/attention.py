"""Attention kernels (counterpart of ``imagefolder_tpu/ops/pallas/attention.py``).

- ``attention_qkv``: attention on the packed qkv projection output of a ViT
  block (TPU kernel ``_attention_qkv_fwd_impl``), kernel
  ``csrc/attention_qkv.cu``, launches counted in ``LAUNCHES``. It is
  differentiable: its backward (TPU kernel ``_attention_qkv_bwd_impl``) is
  ``attention_qkv_bwd``, kernel ``csrc/attention_qkv_bwd.cu``, which writes
  the packed dqkv directly; launches counted in ``BWD_LAUNCHES``. Past the
  single-block budget (N * N > ``_SINGLE_MAX_ELEMS``: the 512 px tokenizer)
  it takes the q-blocked kernels on the (B, N, 3, H, hd) views instead, as
  the JAX package does;
- ``fused_attention``: attention on (B, L, H, hd) views with Lq <= Lk and an
  optional bias, as VAR calls it (TPU kernel ``fused_attention``), kernel
  ``csrc/attention_bnhd.cu``, launches counted in ``FUSED_LAUNCHES``. It is
  differentiable: its backward for Lq == Lk with no bias or a shared bias
  (TPU kernel ``_fused_attention_bwd_impl``) is ``csrc/attention_bnhd_bwd.cu``,
  launches counted in ``FUSED_BWD_LAUNCHES``;
- ``fused_attention_qblk``: the q-blocked BNHD attention that the JAX
  package runs past the single-block budget (TPU kernel
  ``_fused_attention_qblk_fwd``: o divided by the row sum after p v, a
  shared bias or none), kernel ``csrc/attention_qblk.cu``, launches counted
  in ``QBLK_LAUNCHES``. It is differentiable: its backward (TPU kernel
  ``_fused_attention_qblk_bwd``: dk and dv summed in fp32 over every q
  block) is ``csrc/attention_qblk_bwd.cu``, launches counted in
  ``QBLK_BWD_LAUNCHES``;
- ``dot_product_attention``: the router VAR calls, which picks between
  ``fused_attention`` and ``fused_attention_qblk`` as the JAX package does.

The two forwards that divide after p v (#1, #4) share their device code
(``csrc/attention_fwd_tile.cuh``). In bf16 the backwards of those two (#2,
#5) share FlashAttention-2's algorithm on wgmma (``csrc/attention_bwd_sm90.cuh``):
it takes the forward's output o and its per-row log-sum-exp lse, which the
autograd forwards save when a gradient is wanted (``attention_lse_reference``
is the plain version of lse), skips the 64 x 64 tiles that a bias blanks
(``blank_tile_map``, plain version ``blank_tile_map_reference``); dk and dv
come from a kernel per 64 keys, dq from one per 64 q rows. fp32 backwards,
calls that ask for dbias, and #6 keep ``csrc/attention_bwd_tile.cuh``.
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

__all__ = ["attention_qkv", "attention_qkv_reference", "attention_qkv_bwd",
           "attention_qkv_bwd_reference", "fused_attention",
           "fused_attention_reference", "fused_attention_bwd",
           "fused_attention_bwd_reference", "fused_attention_qblk",
           "fused_attention_qblk_reference", "fused_attention_qblk_bwd",
           "fused_attention_qblk_bwd_reference", "dot_product_attention",
           "attention_lse_reference", "attention_qkv_lse", "fused_attention_qblk_lse",
           "blank_tile_map", "blank_tile_map_reference",
           "LAUNCHES", "BWD_LAUNCHES", "FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES",
           "QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES"]

# kernel launches since the counter was last reset (a caller sets it to 0):
# attention_qkv's forward and its backward, fused_attention's forward and
# its backward, fused_attention_qblk's forward and its backward
LAUNCHES = 0
BWD_LAUNCHES = 0
FUSED_LAUNCHES = 0
FUSED_BWD_LAUNCHES = 0
QBLK_LAUNCHES = 0
QBLK_BWD_LAUNCHES = 0

_HEAD_DIM = 64  # the kernel's compiled head width (every DINOv2 preset)
_TILE = 64  # q rows and keys per tile of the bf16 backward (#2, #5) and its blank map

# Score elements Lq * Lk per (batch, head) up to which the JAX package runs
# its single-block kernels (#1/#2 packed, #3/#6 BNHD; the BNHD pair divides
# p by its row sum before p v) and past which it runs the q-blocked pair
# (#4/#5, o divided after p v). On the TPU it was a VMEM budget; on the card
# no such budget binds, and the constant only selects which kernel's
# numerics a call gets, so that the port computes what the JAX package
# computes. The JAX package's caps past it (_QBLK_MAX_L*, where it gives way
# to XLA) stay behind: the port keeps the q-blocked kernels at any length.
_SINGLE_MAX_ELEMS = 1 << 22


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
    q, k, v = qkv.view(b, n, 3, heads, c3 // 3 // heads).unbind(2)
    return fused_attention_qblk_reference(q, k, v, bias, scale).view(b, n, c3 // 3)


@functools.cache
def _kernel():
    fn = _build.load_library().attention_qkv_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _attention_qkv_cuda(qkv, heads, bias, scale, want_lse: bool = False):
    """#1's launch; with ``want_lse`` also each row's log-sum-exp, fp32
    (B, heads, N), for the backward: returns (out, lse)."""
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
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device) if want_lse else None
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(qkv.data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), None if lse is None else lse.data_ptr(), b, n, c,
                        heads, float(scale), int(qkv.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (out, lse) if want_lse else out


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


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes, None for no tensor."""
    return None if t is None else t.data_ptr()


def _strides(t: torch.Tensor, dims) -> ctypes.Array:
    """Element strides of ``t`` at ``dims``, 0 where the size is 1."""
    return (ctypes.c_int64 * 3)(*(t.stride(d) if t.shape[d] != 1 else 0 for d in dims))


def _kernel_operands(q, k, v, bias, what: str):
    """The checks both BNHD kernels make: q, k and v all bf16 or all fp32,
    head dim 64, one device, unit last strides (a view is copied only if its
    last stride is not 1), the bias cast to fp32."""
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes q, k, v all bf16 or all fp32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] != _HEAD_DIM:
        raise NotImplementedError(
            f"{what} kernel is built for head dim {_HEAD_DIM}, got {q.shape[-1]}")
    if not (k.device == v.device == q.device and (bias is None or bias.device == q.device)):
        raise ValueError("q, k, v and bias must be on the same device")
    if 0 in (*q.shape, k.shape[1]):
        raise ValueError(f"{what} needs non-empty inputs; got {tuple(q.shape)}, "
                         f"Lk={k.shape[1]}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if bias is not None:
        bias = bias.to(torch.float32)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
    return q, k, v, bias


def _fused_attention_cuda(q, k, v, bias, scale):
    global FUSED_LAUNCHES
    _check_bnhd(q, k, v, bias)
    q, k, v, bias = _kernel_operands(q, k, v, bias, "fused_attention")
    b, lq, h, hd = q.shape
    lk = k.shape[1]
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


def _check_bwd(q, k, v, bias, g):
    _check_bnhd(q, k, v, bias)
    if k.shape[1] != q.shape[1] or g.shape != q.shape:
        raise ValueError(f"the backward kernel takes Lq == Lk and g shaped like q; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, g {tuple(g.shape)}")
    if bias is not None and tuple(bias.shape[:2]) != (1, 1):
        raise ValueError(f"the backward kernel takes a shared (1, 1, L, L) bias; got "
                         f"{tuple(bias.shape)}")


def fused_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: Optional[torch.Tensor], g: torch.Tensor,
                                  scale: Optional[float] = None, need_dbias: bool = True):
    """Plain PyTorch version of the backward kernel: the TPU kernel's
    ``_bwd_head_math`` op for op, with its casts. Per (batch, head), p =
    softmax(q k^T * scale + bias) in fp32, divided by its row sum; dv =
    bf16(p)^T g; dp = g v^T; ds = p (dp - rowsum(p dp)) on the fp32 p; dq =
    bf16(ds) k * scale; dk = bf16(ds)^T q * scale ("bf16" meaning the inputs'
    type). Returns (dq, dk, dv) contiguous in q's dtype and dbias = the sum of
    ds over batches and heads, (1, 1, L, L) in the bias's dtype, or None
    (no bias, or ``need_dbias`` False)."""
    _check_bwd(q, k, v, bias, g)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))  # (B, H, L, hd)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dsb = ds.to(q.dtype).float()
    dq = torch.matmul(dsb, kf) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), qf) * scale
    dq, dk, dv = (t.to(q.dtype).transpose(1, 2).contiguous() for t in (dq, dk, dv))
    dbias = None
    if bias is not None and need_dbias:
        dbias = ds.sum(dim=(0, 1), keepdim=True).to(bias.dtype)
    return dq, dk, dv, dbias


@functools.cache
def _bnhd_bwd_kernel():
    fn = _build.load_library().attention_bnhd_bwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [i64p] * 4 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_operands(q, k, v, bias, g, what: str):
    """The checks both BNHD backward kernels (#5, #6) make, on top of
    ``_kernel_operands``'s: g of q's type and device, with unit last stride.
    Returns (q, k, v, bias, g, the bias's own dtype)."""
    _check_bwd(q, k, v, bias, g)
    bias_dtype = None if bias is None else bias.dtype
    q, k, v, bias = _kernel_operands(q, k, v, bias, what)
    if g.dtype != q.dtype or g.device != q.device:
        raise TypeError(f"g must be {q.dtype} on {q.device}; got {g.dtype} on {g.device}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    return q, k, v, bias, g, bias_dtype


def _fused_attention_bwd_cuda(q, k, v, bias, g, scale, need_dbias):
    global FUSED_BWD_LAUNCHES
    what = "fused_attention backward"
    q, k, v, bias, g, bias_dtype = _bwd_operands(q, k, v, bias, g, what)
    b, l, h, hd = q.shape
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    stats = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)  # m, l, delta
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.zeros((l, l), dtype=torch.float32, device=q.device)
    row_stride = bias.stride(2) if bias is not None and l > 1 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bnhd_bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if bias is None else bias.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dbias is None else dbias.data_ptr(), stats.data_ptr(),
            b, l, h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)),
            _strides(v, (0, 1, 2)), _strides(g, (0, 1, 2)), row_stride, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    FUSED_BWD_LAUNCHES += 1
    if dbias is not None:
        dbias = dbias[None, None].to(bias_dtype)
    return dq, dk, dv, dbias


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], g: torch.Tensor,
                        scale: Optional[float] = None, need_dbias: bool = True):
    """Gradients of ``fused_attention`` for Lq == Lk with no bias or a
    shared (1, 1, L, L) bias: (dq, dk, dv, dbias | None), as
    ``fused_attention_bwd_reference`` computes them. q, k, v and g are
    (B, L, H, hd) with any strides whose last is 1."""
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cpu or cuda, not {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fused_attention_bwd_cuda(q, k, v, bias, g, scale, need_dbias)


class _FusedAttention(torch.autograd.Function):
    """``fused_attention`` with its gradient, dispatched as the JAX
    package's custom VJP (``_fad_bwd``) dispatches it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if q.device.type == "cpu":
            return fused_attention_reference(q, k, v, bias, scale)
        return _fused_attention_cuda(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        if q.shape[1] == k.shape[1] and (bias is None or tuple(bias.shape[:2]) == (1, 1)):
            dq, dk, dv, dbias = fused_attention_bwd(q, k, v, bias, g, ctx.scale, need_dbias)
            return dq, dk, dv, dbias, None
        # cross-length, or a per-(batch, head) bias: recompute through the
        # plain forward under autograd, as the reference recomputes through XLA
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            bb = None if bias is None else bias.detach().requires_grad_(need_dbias)
            out = fused_attention_reference(qq, kk, vv, bb, ctx.scale)
            grads = torch.autograd.grad(out, [qq, kk, vv] + ([bb] if need_dbias else []), g)
        return *grads[:3], (grads[3] if need_dbias else None), None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per (batch, head), differentiable.

    q: (B, Lq, H, hd); k, v: (B, Lk, H, hd), any strides with the last one 1
    (a view of a fused projection or of a KV cache is read in place). bias,
    if given, is (1|B, 1|H, Lq, Lk), fp32 or cast to it, and may hold -inf;
    an axis of size 1 is shared, never broadcast in memory. The default scale
    is 1/sqrt(hd). Returns a contiguous (B, Lq, H, hd) in q's dtype.

    The gradient of Lq == Lk with no bias or a shared bias is
    ``fused_attention_bwd`` (the backward kernel on a CUDA tensor); dbias is
    computed only when the bias requires a gradient. Other shapes recompute
    through the plain forward, as the JAX package does through XLA.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedAttention.apply(q, k, v, bias, scale)


def _check_qblk(q, k, v, bias):
    _check_bnhd(q, k, v, bias)
    if bias is not None and tuple(bias.shape[:2]) != (1, 1):
        raise ValueError(f"the q-blocked kernel takes a shared (1, 1, Lq, Lk) bias; got "
                         f"{tuple(bias.shape)}")


def fused_attention_qblk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None,
                                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the q-blocked kernel (and, on the packed
    views, of ``attention_qkv``'s), with the TPU kernels' numerics: fp32
    scores and softmax, p rounded to the input dtype before p v, the row sum
    taken on the fp32 p, and o / l at the end."""
    _check_qblk(q, k, v, bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, L, hd)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(q.dtype).float(), vf) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2).contiguous()


@functools.cache
def _qblk_kernel():
    fn = _build.load_library().attention_qblk_fwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [i64p] * 3 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse: bool = False):
    """#4's launch; with ``want_lse`` also each row's log-sum-exp, fp32
    (B, H, Lq), for the backward: returns (out, lse)."""
    global QBLK_LAUNCHES
    _check_qblk(q, k, v, bias)
    q, k, v, bias = _kernel_operands(q, k, v, bias, "fused_attention_qblk")
    b, lq, h, hd = q.shape
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if want_lse else None
    row_stride = bias.stride(2) if bias is not None and lq > 1 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qblk_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, lq, k.shape[1], h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)),
            _strides(v, (0, 1, 2)), row_stride, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_attention_qblk kernel launch failed: CUDA error {err}")
    QBLK_LAUNCHES += 1
    return (out, lse) if want_lse else out


# The q-blocked backward's plain version: its per-head math is #6's
# (``_bwd_head_math`` with its casts), with dk and dv summed in fp32 over
# every q row before their one cast, which is what the TPU kernel's fp32
# accumulation over q blocks computes.
fused_attention_qblk_bwd_reference = fused_attention_bwd_reference


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the per-row log-sum-exp that the forwards #1 and #4
    store for the bf16 backward: logsumexp over keys of the fp32 scores
    q k^T * scale + bias, (B, H, Lq) fp32, for q (B, Lq, H, hd), k
    (B, Lk, H, hd) and a shared (1, 1, Lq, Lk) bias or none (for #1, the
    (B, N, H, hd) views of qkv). A row whose every score is -inf gets -inf."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float().transpose(1, 2), k.float().transpose(1, 2).transpose(-1, -2))
    s = s * scale
    if bias is not None:
        s = s + bias.float()
    return torch.logsumexp(s, dim=-1)


def fused_attention_qblk_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None):
    """``fused_attention_qblk``'s output and each row's log-sum-exp, fp32
    (B, H, Lq), as its autograd forward saves them for the bf16 backward:
    on a card one #4 launch with the lse store on (counted in
    ``QBLK_LAUNCHES``), on the CPU the plain versions. No gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return (fused_attention_qblk_reference(q, k, v, bias, scale),
                attention_lse_reference(q, k, bias, scale))
    return _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse=True)


def attention_qkv_lse(qkv: torch.Tensor, heads: int, bias: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None):
    """``attention_qkv``'s output (single-block route) and each row's
    log-sum-exp, fp32 (B, heads, N), as its autograd forward saves them for
    the bf16 backward: on a card one #1 launch with the lse store on
    (counted in ``LAUNCHES``), on the CPU the plain versions. No gradient."""
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    if scale is None:
        scale = 1.0 / math.sqrt(c3 // 3 // heads)
    if qkv.device.type == "cpu":
        q, k, _ = qkv.view(b, n, 3, heads, c3 // 3 // heads).unbind(2)
        return (attention_qkv_reference(qkv, heads, bias, scale),
                attention_lse_reference(q, k, bias, scale))
    return _attention_qkv_cuda(qkv, heads, bias, scale, want_lse=True)


def _check_map_bias(bias: torch.Tensor) -> torch.Tensor:
    if bias.dim() == 4 and tuple(bias.shape[:2]) == (1, 1):
        bias = bias[0, 0]
    if bias.dim() != 2 or bias.shape[0] != bias.shape[1] or bias.shape[0] == 0:
        raise ValueError(f"the blank-tile map takes a shared (1, 1, L, L) or (L, L) bias; got "
                         f"{tuple(bias.shape)}")
    return bias


def blank_tile_map_reference(bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 backward's blank-tile map: for a shared
    (1, 1, L, L) or (L, L) bias, a (T, T) uint8 with T = ceil(L / 64), 1 where
    every entry of the 64 x 64 tile (q rows, keys) within (L, L) is -inf:
    the tiles whose every p is 0, which the kernel never loads."""
    bias = _check_map_bias(bias)
    n = bias.shape[0]
    t = -(-n // _TILE)
    pad = torch.full((t * _TILE, t * _TILE), float("-inf"), device=bias.device)
    pad[:n, :n] = bias.float()
    tiles = pad.view(t, _TILE, t, _TILE)
    return (tiles == float("-inf")).all(dim=3).all(dim=1).to(torch.uint8)


@functools.cache
def _map_kernel():
    fn = _build.load_library().attention_blank_tile_map
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blank_tile_map(bias: torch.Tensor) -> torch.Tensor:
    """The blank-tile map as ``blank_tile_map_reference`` computes it. On a
    CUDA tensor it runs the backward's pre-pass alone, which builds the map
    inside every bf16 call of #2 and #5 with a bias; this entry serves the
    checks and counts no launch."""
    bias = _check_map_bias(bias)
    if bias.device.type == "cpu":
        return blank_tile_map_reference(bias)
    if bias.device.type != "cuda":
        raise ValueError(f"blank_tile_map runs on cpu or cuda, not {bias.device}")
    bias = bias.to(torch.float32)
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    n = bias.shape[0]
    t = -(-n // _TILE)
    out = torch.empty((2, t, t), dtype=torch.uint8, device=bias.device)  # blank, all-zero
    with torch.cuda.device(bias.device):
        err = _map_kernel()(bias.data_ptr(), out.data_ptr(), n, bias.stride(0) if n > 1 else 0,
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"blank_tile_map kernel launch failed: CUDA error {err}")
    return out[0]


def _work_floats(b: int, n: int, h: int) -> int:
    """The bf16 backward's fp32 workspace: lse and delta, (B, H, Lpad) each,
    Lpad = L up to a whole tile (``sm90::work_floats``)."""
    return b * h * (-(-n // _TILE) * _TILE) * 2


def _copy_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its base and its batch, row and head strides sit on
    16-byte boundaries (the bf16 backward's 16-byte loads), else a
    contiguous copy."""
    ok = t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 8 == 0 or t.shape[d] == 1 for d in range(3))
    return t if ok else t.contiguous()


@functools.cache
def _qblk_bwd_kernel():
    fn = _build.load_library().attention_qblk_bwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [i64p] * 5 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fused_attention_qblk_bwd_cuda(q, k, v, bias, g, scale, need_dbias, o=None, lse=None):
    global QBLK_BWD_LAUNCHES
    what = "fused_attention_qblk backward"
    q, k, v, bias, g, bias_dtype = _bwd_operands(q, k, v, bias, g, what)
    b, l, h, hd = q.shape
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.zeros((l, l), dtype=torch.float32, device=q.device)
    # bf16 without dbias: the wgmma kernel on the forward's o and lse
    sm90 = q.dtype == torch.bfloat16 and dbias is None
    blank = None
    if sm90:
        q, k, v, g = (_copy_ready(t) for t in (q, k, v, g))
        if o is None or lse is None:  # a direct call: the forward gives them (counted as #4)
            o, lse = _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse=True)
        if o.shape != q.shape or o.dtype != q.dtype or tuple(lse.shape) != (b, h, l) \
                or lse.dtype != torch.float32:
            raise ValueError(f"{what}: o must be {tuple(q.shape)} {q.dtype} and lse ({b}, {h}, "
                             f"{l}) fp32; got {tuple(o.shape)} {o.dtype}, {tuple(lse.shape)} "
                             f"{lse.dtype}")
        o = _copy_ready(o) if o.stride(-1) == 1 else o.contiguous()
        lse = lse.contiguous()
        work = torch.empty(_work_floats(b, l, h), dtype=torch.float32, device=q.device)
        if bias is not None:
            blank = torch.empty(2 * (-(-l // _TILE)) ** 2, dtype=torch.uint8, device=q.device)
    else:
        work = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)  # m, l, delta
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    row_stride = bias.stride(2) if bias is not None and l > 1 else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qblk_bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(o if sm90 else None),
            _ptr(lse if sm90 else None), _ptr(bias), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(dbias), work.data_ptr(), _ptr(blank), b, l, h, _strides(q, (0, 1, 2)),
            _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)), _strides(g, (0, 1, 2)),
            _strides(o, (0, 1, 2)) if sm90 else None, row_stride, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    QBLK_BWD_LAUNCHES += 1
    if dbias is not None:
        dbias = dbias[None, None].to(bias_dtype)
    return dq, dk, dv, dbias


def fused_attention_qblk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: Optional[torch.Tensor], g: torch.Tensor,
                             scale: Optional[float] = None, need_dbias: bool = True,
                             o: Optional[torch.Tensor] = None,
                             lse: Optional[torch.Tensor] = None):
    """Gradients of ``fused_attention_qblk`` (Lq == Lk, no bias or a shared
    (1, 1, L, L) bias): (dq, dk, dv, dbias | None), as
    ``fused_attention_qblk_bwd_reference`` computes them. q, k, v and g are
    (B, L, H, hd) with any strides whose last is 1. o and lse are the
    forward's output and its (B, H, L) fp32 log-sum-exp, which the bf16
    kernel reads (autograd passes them); a bf16 call on the card without
    them first runs the forward (#4) to get them. A call that asks for
    dbias, fp32 or bf16, runs the two-kernel design, which recomputes the
    row statistics and needs neither. The plain version ignores them."""
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_qblk_bwd runs on cpu or cuda, not {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fused_attention_qblk_bwd_cuda(q, k, v, bias, g, scale, need_dbias, o, lse)


class _FusedAttentionQblk(torch.autograd.Function):
    """``fused_attention_qblk`` with its gradient: the counterpart of the
    JAX package's ``_fused_attention_qblk_diff`` (``_faq_fwd``/``_faq_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias, None, None)
            return fused_attention_qblk_reference(q, k, v, bias, scale)
        if q.dtype == torch.bfloat16 and any(ctx.needs_input_grad[:3]) \
                and q.shape[1] == k.shape[1]:
            # the bf16 backward reads the output and each row's lse
            out, lse = _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse=True)
            ctx.save_for_backward(q, k, v, bias, out, lse)
            return out
        ctx.save_for_backward(q, k, v, bias, None, None)
        return _fused_attention_qblk_cuda(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = fused_attention_qblk_bwd(q, k, v, bias, g, ctx.scale, need_dbias,
                                                     o, lse)
        return dq, dk, dv, dbias, None


def fused_attention_qblk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per (batch, head), normalised after
    p v, differentiable: the JAX package's q-blocked attention.

    q: (B, Lq, H, hd); k, v: (B, Lk, H, hd), any strides with the last one 1
    (the views of a packed qkv are read in place). bias, if given, is one
    (1, 1, Lq, Lk) shared by batches and heads, fp32 or cast to it, and may
    hold -inf. Any length: the card has no VMEM budget. The default scale is
    1/sqrt(hd). Returns a contiguous (B, Lq, H, hd) in q's dtype. The
    gradient (Lq == Lk only, as in the JAX package) is
    ``fused_attention_qblk_bwd``; dbias is computed only when the bias
    requires a gradient.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention_qblk runs on cpu or cuda, not {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedAttentionQblk.apply(q, k, v, bias, scale)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's attention router (``dot_product_attention``), as a
    contract on numerics rather than on memory:
    - Lq * Lk <= ``_SINGLE_MAX_ELEMS``: ``fused_attention`` (#3, backward #6);
    - past it, self-attention (Lq == Lk) with a shared bias or none:
      ``fused_attention_qblk`` (#4, backward #5), at any length (the JAX
      package caps it at 2304 with a bias and 2816 without, past which it
      uses XLA: the port's one deliberate difference, at bf16 rounding);
    - any other shape past it: ``fused_attention``. The JAX package uses
      XLA there; no path of the repository reaches it.
    Arguments and result as ``fused_attention``."""
    shared = bias is None or tuple(bias.shape[:2]) == (1, 1)
    if q.shape[1] * k.shape[1] > _SINGLE_MAX_ELEMS and shared and q.shape[1] == k.shape[1]:
        return fused_attention_qblk(q, k, v, bias, scale)
    return fused_attention(q, k, v, bias, scale)


def attention_qkv_bwd_reference(qkv: torch.Tensor, heads: int, bias: Optional[torch.Tensor],
                                g: torch.Tensor, scale: Optional[float] = None,
                                need_dbias: bool = True):
    """Plain PyTorch version of the packed backward kernel: the TPU kernel's
    ``_bwd_head_math`` op for op, with its casts (``fused_attention_bwd_reference``
    on the (B, N, H, hd) views of qkv and g). Returns dqkv, (B, N, 3C) in
    qkv's dtype with dq, dk and dv at q's, k's and v's columns, and dbias =
    the sum of ds over batches and heads, (1, 1, N, N) in the bias's dtype,
    or None (no bias, or ``need_dbias`` False)."""
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if tuple(g.shape) != (b, n, c):
        raise ValueError(f"g must be {(b, n, c)}; got {tuple(g.shape)}")
    q, k, v = qkv.view(b, n, 3, heads, c // heads).unbind(2)
    dq, dk, dv, dbias = fused_attention_bwd_reference(
        q, k, v, bias, g.view(b, n, heads, c // heads), scale, need_dbias)
    return torch.stack([dq, dk, dv], dim=2).reshape(b, n, c3), dbias


@functools.cache
def _bwd_kernel():
    fn = _build.load_library().attention_qkv_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _attention_qkv_bwd_cuda(qkv, heads, bias, g, scale, need_dbias, o=None, lse=None):
    global BWD_LAUNCHES
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype not in (torch.bfloat16, torch.float32) or g.dtype != qkv.dtype:
        raise TypeError(f"attention_qkv backward kernel takes qkv and g both bf16 or both "
                        f"fp32; got {qkv.dtype}, {g.dtype}")
    if c // heads != _HEAD_DIM:
        raise NotImplementedError(
            f"attention_qkv backward kernel is built for head dim {_HEAD_DIM}, got {c // heads}")
    if tuple(g.shape) != (b, n, c):
        raise ValueError(f"g must be {(b, n, c)}; got {tuple(g.shape)}")
    if not (g.device == qkv.device and (bias is None or bias.device == qkv.device)):
        raise ValueError("qkv, g and bias must be on the same device")
    if not qkv.is_contiguous():
        raise ValueError("attention_qkv backward kernel needs a contiguous qkv")
    g = g.contiguous()
    bias_dtype = None if bias is None else bias.dtype
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    dqkv = torch.empty_like(qkv)
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.zeros((n, n), dtype=torch.float32, device=qkv.device)
    if dqkv.numel() == 0:
        return dqkv.zero_(), None if dbias is None else dbias[None, None].to(bias_dtype)
    # bf16 without dbias: the wgmma kernel on the forward's o and lse
    sm90 = qkv.dtype == torch.bfloat16 and dbias is None
    blank = None
    if sm90:
        if o is None or lse is None:  # a direct call: the forward gives them (counted as #1)
            o, lse = _attention_qkv_cuda(qkv, heads, bias, scale, want_lse=True)
        if tuple(o.shape) != (b, n, c) or o.dtype != qkv.dtype \
                or tuple(lse.shape) != (b, heads, n) or lse.dtype != torch.float32:
            raise ValueError(f"attention_qkv backward: o must be {(b, n, c)} {qkv.dtype} and "
                             f"lse {(b, heads, n)} fp32; got {tuple(o.shape)} {o.dtype}, "
                             f"{tuple(lse.shape)} {lse.dtype}")
        o, lse = o.contiguous(), lse.contiguous()
        work = torch.empty(_work_floats(b, n, heads), dtype=torch.float32, device=qkv.device)
        if bias is not None:
            blank = torch.empty(2 * (-(-n // _TILE)) ** 2, dtype=torch.uint8, device=qkv.device)
    else:
        work = torch.empty((3, b, heads, n), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel()(
            qkv.data_ptr(), g.data_ptr(), _ptr(o if sm90 else None), _ptr(lse if sm90 else None),
            _ptr(bias), dqkv.data_ptr(), _ptr(dbias), work.data_ptr(), _ptr(blank), b, n, c, heads,
            n, float(scale), int(qkv.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    if dbias is not None:
        dbias = dbias[None, None].to(bias_dtype)
    return dqkv, dbias


def attention_qkv_bwd(qkv: torch.Tensor, heads: int, bias: Optional[torch.Tensor],
                      g: torch.Tensor, scale: Optional[float] = None, need_dbias: bool = True,
                      o: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None):
    """Gradients of ``attention_qkv``: (dqkv, dbias | None), as
    ``attention_qkv_bwd_reference`` computes them. qkv (B, N, 3C) contiguous,
    g (B, N, C), bias None or a shared (1, 1, N, N). o and lse are the
    forward's (B, N, C) output and its (B, heads, N) fp32 log-sum-exp, which
    the bf16 kernel reads (autograd passes them); a bf16 call on the card
    without them first runs the forward (#1) to get them. A call that asks
    for dbias, fp32 or bf16, runs the two-kernel design, which recomputes
    the row statistics and needs neither. The plain version ignores them."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // heads)
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, heads, bias, g, scale, need_dbias)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv_bwd runs on cpu or cuda, not {qkv.device}")
    return _attention_qkv_bwd_cuda(qkv, heads, bias, g, scale, need_dbias, o, lse)


class _AttentionQKV(torch.autograd.Function):
    """``attention_qkv`` with its gradient, dispatched as the JAX package's
    custom VJP (``_attention_qkv_diff``) dispatches it."""

    @staticmethod
    def forward(ctx, qkv, heads, bias, scale):
        ctx.heads, ctx.scale = heads, scale
        if qkv.device.type == "cpu":
            ctx.save_for_backward(qkv, bias, None, None)
            return attention_qkv_reference(qkv, heads, bias, scale)
        if qkv.dtype == torch.bfloat16 and ctx.needs_input_grad[0]:
            # the bf16 backward reads the output and each row's lse
            out, lse = _attention_qkv_cuda(qkv, heads, bias, scale, want_lse=True)
            ctx.save_for_backward(qkv, bias, out, lse)
            return out
        ctx.save_for_backward(qkv, bias, None, None)
        return _attention_qkv_cuda(qkv, heads, bias, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[2]
        dqkv, dbias = attention_qkv_bwd(qkv, ctx.heads, bias, g, ctx.scale, need_dbias, o, lse)
        return dqkv, None, dbias, None


def attention_qkv(qkv: torch.Tensor, heads: int,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v per head, from the packed projection,
    differentiable.

    qkv: (B, N, 3C) as the fused Linear(3C) produces it, i.e. the
    (B, N, 3, H, hd) view holds q/k/v at index 0/1/2 of axis 2. Returns
    (B, N, C) in qkv's dtype, head h at columns h*hd. bias, if given, is
    (1, 1, N, N), shared by batches and heads, and may hold -inf. The default
    scale is 1/sqrt(hd). The gradient is ``attention_qkv_bwd`` (the backward
    kernel on a CUDA tensor); dbias is computed only when the bias requires a
    gradient.

    Past the single-block budget (N * N > ``_SINGLE_MAX_ELEMS``) it runs the
    q-blocked pair on the (B, N, H, hd) views of qkv, read in place, as the
    JAX package does (its ``attention_qkv``'s long branch): the result is
    the same function, and the packed gradient comes back through the
    q-blocked backward.
    """
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_qkv runs on cpu or cuda, not {qkv.device}")
    _check(qkv, heads, bias)
    b, n, c3 = qkv.shape
    if scale is None:
        scale = 1.0 / math.sqrt(c3 // 3 // heads)
    if n * n > _SINGLE_MAX_ELEMS:
        q, k, v = qkv.view(b, n, 3, heads, c3 // 3 // heads).unbind(2)
        return fused_attention_qblk(q, k, v, bias, scale).view(b, n, c3 // 3)
    return _AttentionQKV.apply(qkv, heads, bias, scale)
