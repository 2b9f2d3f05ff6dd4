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
  optional bias, as VAR calls it (TPU kernel ``fused_attention``: p divided
  by the row sum before p v), kernel ``csrc/attention_bnhd.cu``, launches
  counted in ``FUSED_LAUNCHES``. It is differentiable: its backward for
  Lq == Lk with no bias or a shared bias (TPU kernel
  ``_fused_attention_bwd_impl``) is ``csrc/attention_bnhd_bwd.cu``, launches
  counted in ``FUSED_BWD_LAUNCHES``;
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

The forwards run in bf16 on wgmma (``csrc/attention_fwd_sm90.cuh``): the two
that divide after p v (#1, #4, and #7's attention step) on its one-pass
kernel, which with a square bias (#4) skips the 64 x 64 tiles that the bias
blanks (a pre-pass writes the map; ``block_key_tiles_reference`` is the
plain version of which key tiles a block copies); the BNHD forward #3 on its
two-pass kernel (k and v resident in shared memory up to Lk = 320). bf16
views whose base or strides are off 16 bytes are copied first
(``_copy_ready``). In fp32 each has an FMA kernel (#1 and #4:
``csrc/attention_fwd_tile.cuh``). In
bf16 the three backwards (#2, #5, #6) share FlashAttention-2's algorithm on
wgmma (``csrc/attention_bwd_sm90.cuh``): it takes the forward's output o
and its per-row log-sum-exp lse, which the autograd forwards save when a
gradient is wanted (the forwards' lse store; ``attention_lse_reference`` is
the plain version of lse), skips the 64 x 64 tiles that a bias blanks
(``blank_tile_map``, plain version ``blank_tile_map_reference``); dk and dv
come from a kernel per 64 keys, dq from one per 64 q rows. fp32 backwards,
calls that ask for dbias, and #6 at L = 1 keep ``csrc/attention_bwd_tile.cuh``.
The BNHD kernels (#3-#6) take every head width up to 256: 48 for RAR-B and
MaskGIT-B, 80 and 88 for RAR-XL and RAR-XXL, 256 for a generator of hidden
1024 over 4 heads. A width that is not a multiple
of 8 is zero-padded to the next one before the launch (the scale stays the
true width's; zero columns of q and k change no score, those of v give
output columns that are cut away, and the gradients are cut back to the true
width). Widths of 72-128 run the kD = 128 instantiations (in bf16 the
forwards on 128-wide wgmma tiles, every backward on the two-kernel design
of ``csrc/attention_bwd_tile.cuh``), widths of 136-256 the kD = 256 FMA
kernels of ``csrc/attention_wide.cuh`` (fp32 and bf16, eight threads a row).
Wider heads raise. The packed pair
(#1, #2), which only the ViTs call, takes 64.
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
import torch.nn.functional as F

from imagefolder_tpu_torch.ops.cuda import _build

__all__ = ["attention_qkv", "attention_qkv_reference", "attention_qkv_bwd",
           "attention_qkv_bwd_reference", "fused_attention",
           "fused_attention_reference", "fused_attention_bwd",
           "fused_attention_bwd_reference", "fused_attention_qblk",
           "fused_attention_qblk_reference", "fused_attention_qblk_bwd",
           "fused_attention_qblk_bwd_reference", "dot_product_attention",
           "attention_lse_reference", "attention_qkv_lse", "fused_attention_lse",
           "fused_attention_qblk_lse",
           "blank_tile_map", "blank_tile_map_reference", "block_key_tiles_reference",
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

# head widths: the packed pair #1/#2 (and #7's attention step) serve the
# ViTs, every preset of which has heads of 64; the BNHD kernels #3-#6 take
# every width up to _BNHD_MAX_HEAD_DIM (48: RAR-B and MaskGIT-B, 768 / 16;
# 80 and 88: RAR-XL and RAR-XXL), compiled at 48, 64, 128 and 256: a width runs
# under the smallest of them that holds it, zero-padded to its tiles on the
# card, and one that is not a multiple of 8 is first zero-padded to one by
# the wrapper. Wider heads raise.
_HEAD_DIM = 64
_BNHD_MAX_HEAD_DIM = 256
_SM90_BWD_MAX_HEAD_DIM = 64  # the wgmma backward's widest; past it the two-kernel design
_TILE = 64  # q rows and keys per tile of the bf16 backward (#2, #5, #6) and its blank map

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


def _launch(what: str, entry, device, *args):
    """The kernel entry ``entry()`` called with ``args`` and ``device``'s
    current stream; raises if it returns a CUDA error."""
    with torch.cuda.device(device):
        err = entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
            f"attention_qkv kernel is built for head dim {_HEAD_DIM} (every ViT preset), "
            f"got {c // heads}")
    if bias is not None:
        if bias.device != qkv.device:
            raise ValueError("bias and qkv must be on the same device")
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device) if want_lse else None
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    if qkv.dtype == torch.bfloat16:  # the wgmma kernel's 16-byte copies
        qkv = _copy_ready(qkv.view(b, n, 3 * heads, _HEAD_DIM)).view(b, n, c3)
    _launch("attention_qkv", _kernel, qkv.device, qkv.data_ptr(), _ptr(bias), out.data_ptr(),
            _ptr(lse), b, n, c, heads, float(scale), int(qkv.dtype == torch.bfloat16))
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [i64p] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes, None for no tensor."""
    return None if t is None else t.data_ptr()


def _strides(t: torch.Tensor, dims) -> ctypes.Array:
    """Element strides of ``t`` at ``dims``, 0 where the size is 1."""
    return (ctypes.c_int64 * 3)(*(t.stride(d) if t.shape[d] != 1 else 0 for d in dims))


def _pad_head(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``hd`` (itself if it is that wide)."""
    return t if t.shape[-1] == hd else F.pad(t, (0, hd - t.shape[-1]))


def _kernel_operands(q, k, v, bias, what: str):
    """The checks the BNHD kernels (#3-#6) make: q, k and v all bf16 or all
    fp32, a head dim up to ``_BNHD_MAX_HEAD_DIM``, one device, unit last
    strides (a view is copied only if its last stride is not 1), the bias
    cast to fp32. Every check comes before any launch. A head dim that is
    not a multiple of 8 comes back zero-padded to the next one (the caller
    cuts its results back)."""
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes q, k, v all bf16 or all fp32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] > _BNHD_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{what} kernel takes head dims up to {_BNHD_MAX_HEAD_DIM} (one that is not a "
            f"multiple of 8 zero-padded to one), got {q.shape[-1]}")
    if not (k.device == v.device == q.device and (bias is None or bias.device == q.device)):
        raise ValueError("q, k, v and bias must be on the same device")
    if 0 in (*q.shape, k.shape[1]):
        raise ValueError(f"{what} needs non-empty inputs; got {tuple(q.shape)}, "
                         f"Lk={k.shape[1]}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    hd = -(-q.shape[-1] // 8) * 8
    q, k, v = (_pad_head(t, hd) for t in (q, k, v))
    if bias is not None:
        bias = bias.to(torch.float32)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
    return q, k, v, bias


def _cut_head(hd: int, *ts: Optional[torch.Tensor]):
    """Each tensor cut back to its first ``hd`` columns, contiguous (None
    stays None; a tensor ``hd`` wide is returned as it is)."""
    return tuple(t if t is None or t.shape[-1] == hd else t[..., :hd].contiguous() for t in ts)


def _copy_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its base and its batch, row and head strides sit on
    16-byte boundaries (the wgmma kernels' 16-byte copies), else a
    contiguous copy in new memory (a contiguous tensor whose base is off
    16 bytes is copied too)."""
    ok = t.data_ptr() % 16 == 0 and all(
        t.stride(d) % 8 == 0 or t.shape[d] == 1 for d in range(3))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _fused_attention_cuda(q, k, v, bias, scale, want_lse: bool = False):
    """#3's launch; with ``want_lse`` (bf16 only) also each row's
    log-sum-exp, fp32 (B, H, Lq), for the backward: returns (out, lse)."""
    global FUSED_LAUNCHES
    _check_bnhd(q, k, v, bias)
    hd0 = q.shape[-1]
    q, k, v, bias = _kernel_operands(q, k, v, bias, "fused_attention")
    if q.dtype == torch.bfloat16:
        q, k, v = (_copy_ready(t) for t in (q, k, v))
    elif want_lse:
        raise TypeError("fused_attention's lse store is in its bf16 kernel; got fp32")
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if want_lse else None
    bs = _strides(bias, (0, 1, 2)) if bias is not None else None
    _launch("fused_attention", _fused_kernel, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(lse), b, lq, lk, h,
            _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)), bs,
            float(scale), int(q.dtype == torch.bfloat16), hd)
    FUSED_LAUNCHES += 1
    out, = _cut_head(hd0, out)
    return (out, lse) if want_lse else out


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
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [i64p] * 5 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    return q, k, v, bias, _pad_head(g, q.shape[-1]), bias_dtype


def _fused_attention_bwd_cuda(q, k, v, bias, g, scale, need_dbias, o=None, lse=None):
    global FUSED_BWD_LAUNCHES
    what = "fused_attention backward"
    hd0 = q.shape[-1]
    q, k, v, bias, g, bias_dtype = _bwd_operands(q, k, v, bias, g, what)
    b, l, h, hd = q.shape
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.zeros((l, l), dtype=torch.float32, device=q.device)
    # bf16 without dbias: the wgmma kernel on the forward's o and lse. At
    # L = 1 every p is 1 and dq, dk are exactly 0, as the two-kernel design
    # gives them; p from lse (1 - 1e-7) and delta from o leave ~1e-7 of |dp|
    # in ds there, so that call keeps the two-kernel design (as dbias does)
    sm90 = q.dtype == torch.bfloat16 and dbias is None and l > 1 \
        and hd <= _SM90_BWD_MAX_HEAD_DIM
    blank = None
    if sm90:
        q, k, v, g = (_copy_ready(t) for t in (q, k, v, g))
        if o is None or lse is None:  # a direct call: the forward gives them (counted as #3)
            o, lse = _fused_attention_cuda(q, k, v, bias, scale, want_lse=True)
        o = _pad_head(o, hd)  # the forward's columns past hd0 are exact zeros
        _check_o_lse(what, q, o, lse)
        o = _copy_ready(o) if o.stride(-1) == 1 else o.contiguous()
        lse = lse.contiguous()
        work = torch.empty(_work_floats(b, l, h), dtype=torch.float32, device=q.device)
        if bias is not None:
            blank = torch.empty(2 * (-(-l // _TILE)) ** 2, dtype=torch.uint8, device=q.device)
    else:
        work = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)  # m, l, delta
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    row_stride = bias.stride(2) if bias is not None and l > 1 else 0
    _launch(what, _bnhd_bwd_kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), _ptr(o if sm90 else None), _ptr(lse if sm90 else None), _ptr(bias),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), work.data_ptr(),
            _ptr(blank), b, l, h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)),
            _strides(v, (0, 1, 2)), _strides(g, (0, 1, 2)),
            _strides(o, (0, 1, 2)) if sm90 else None, row_stride, float(scale),
            int(q.dtype == torch.bfloat16), hd)
    FUSED_BWD_LAUNCHES += 1
    if dbias is not None:
        dbias = dbias[None, None].to(bias_dtype)
    return (*_cut_head(hd0, dq, dk, dv), dbias)


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], g: torch.Tensor,
                        scale: Optional[float] = None, need_dbias: bool = True,
                        o: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None):
    """Gradients of ``fused_attention`` for Lq == Lk with no bias or a
    shared (1, 1, L, L) bias: (dq, dk, dv, dbias | None), as
    ``fused_attention_bwd_reference`` computes them. q, k, v and g are
    (B, L, H, hd) with any strides whose last is 1. o and lse are the
    forward's output and its (B, H, L) fp32 log-sum-exp, which the bf16
    kernel reads (autograd passes them); a bf16 call on the card without
    them first runs the forward (#3) to get them. A call that asks for
    dbias, fp32 or bf16, and a call at L = 1 run the two-kernel design,
    which recomputes the row statistics and needs neither. The plain
    version ignores them."""
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cpu or cuda, not {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fused_attention_bwd_cuda(q, k, v, bias, g, scale, need_dbias, o, lse)


def _bwd_kernel_takes(q, k, bias) -> bool:
    """Whether ``fused_attention``'s gradient is the backward kernel's:
    Lq == Lk with no bias or a shared (1, 1, L, L) one."""
    return q.shape[1] == k.shape[1] and (bias is None or tuple(bias.shape[:2]) == (1, 1))


class _FusedAttention(torch.autograd.Function):
    """``fused_attention`` with its gradient, dispatched as the JAX
    package's custom VJP (``_fad_bwd``) dispatches it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias, None, None)
            return fused_attention_reference(q, k, v, bias, scale)
        if q.dtype == torch.bfloat16 and any(ctx.needs_input_grad[:3]) \
                and _bwd_kernel_takes(q, k, bias):
            # the bf16 backward reads the output and each row's lse
            out, lse = _fused_attention_cuda(q, k, v, bias, scale, want_lse=True)
            ctx.save_for_backward(q, k, v, bias, out, lse)
            return out
        ctx.save_for_backward(q, k, v, bias, None, None)
        return _fused_attention_cuda(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        if _bwd_kernel_takes(q, k, bias):
            dq, dk, dv, dbias = fused_attention_bwd(q, k, v, bias, g, ctx.scale, need_dbias,
                                                    o, lse)
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
    ``fused_attention_bwd`` (the backward kernel on a CUDA tensor; in bf16
    the forward then also stores each row's lse, and autograd keeps it with
    the output for the backward); dbias is computed only when the bias
    requires a gradient. Other shapes recompute through the plain forward,
    as the JAX package does through XLA.
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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [i64p] * 3 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse: bool = False,
                               skip_blank: bool = True):
    """#4's launch; with ``want_lse`` also each row's log-sum-exp, fp32
    (B, H, Lq), for the backward: returns (out, lse). In bf16 with a bias
    and Lq == Lk the launch is two kernels, counted as one: a pre-pass
    writes the bias's blank-tile map, and the forward skips the tiles it
    blanks; ``skip_blank=False`` passes no map, so that every tile is
    computed (for the checks: the output is the same, bit for bit)."""
    global QBLK_LAUNCHES
    _check_qblk(q, k, v, bias)
    hd0 = q.shape[-1]
    q, k, v, bias = _kernel_operands(q, k, v, bias, "fused_attention_qblk")
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the wgmma kernel's 16-byte copies
        q, k, v = (_copy_ready(t) for t in (q, k, v))
    b, lq, h, hd = q.shape
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if want_lse else None
    blank = None
    if skip_blank and bf16 and bias is not None and lq == k.shape[1]:
        blank = torch.empty(2 * (-(-lq // _TILE)) ** 2, dtype=torch.uint8, device=q.device)
    row_stride = bias.stride(2) if bias is not None and lq > 1 else 0
    _launch("fused_attention_qblk", _qblk_kernel, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(bias), _ptr(blank), out.data_ptr(), _ptr(lse), b, lq, k.shape[1],
            h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)),
            row_stride, float(scale), int(bf16), hd)
    QBLK_LAUNCHES += 1
    out, = _cut_head(hd0, out)
    return (out, lse) if want_lse else out


# The q-blocked backward's plain version: its per-head math is #6's
# (``_bwd_head_math`` with its casts), with dk and dv summed in fp32 over
# every q row before their one cast, which is what the TPU kernel's fp32
# accumulation over q blocks computes.
fused_attention_qblk_bwd_reference = fused_attention_bwd_reference


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the per-row log-sum-exp that the forwards #1, #3 and
    #4 store for the bf16 backward: logsumexp over keys of the fp32 scores
    q k^T * scale + bias, (B, H, Lq) fp32, for q (B, Lq, H, hd), k
    (B, Lk, H, hd) and a (1|B, 1|H, Lq, Lk) bias or none (for #1, the
    (B, N, H, hd) views of qkv). A row whose every score is -inf gets -inf."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float().transpose(1, 2), k.float().transpose(1, 2).transpose(-1, -2))
    s = s * scale
    if bias is not None:
        s = s + bias.float()
    return torch.logsumexp(s, dim=-1)


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None):
    """``fused_attention``'s output and each row's log-sum-exp, fp32
    (B, H, Lq), as its autograd forward saves them for the bf16 backward:
    on a card one #3 launch with the lse store on (counted in
    ``FUSED_LAUNCHES``; bf16 only), on the CPU the plain versions. No
    gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return (fused_attention_reference(q, k, v, bias, scale),
                attention_lse_reference(q, k, bias, scale))
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_lse runs on cpu or cuda, not {q.device}")
    return _fused_attention_cuda(q, k, v, bias, scale, want_lse=True)


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


def block_key_tiles_reference(bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the key tiles a block of #4's one-pass forward
    copies under a shared (1, 1, L, L) or (L, L) bias: a block of two
    warpgroups owns 128 q rows, 64 each, and copies key tile kt unless the
    blank-tile map blanks it for both (a warpgroup past L counts as
    blank). (ceil(L / 128), T) bool with T = ceil(L / 64), True where the
    block copies the tile."""
    blank = blank_tile_map_reference(bias).bool()
    t = blank.shape[0]
    rows = torch.ones((2 * (-(-t // 2)), t), dtype=torch.bool, device=blank.device)
    rows[:t] = blank
    return ~rows.view(-1, 2, t).all(dim=1)


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
    inside every bf16 call of #2, #4 and #5 with a bias; this entry serves
    the checks and counts no launch."""
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
    _launch("blank_tile_map", _map_kernel, bias.device, bias.data_ptr(), out.data_ptr(), n,
            bias.stride(0) if n > 1 else 0)
    return out[0]


def _work_floats(b: int, n: int, h: int) -> int:
    """The bf16 backward's fp32 workspace: lse and delta, (B, H, Lpad) each,
    Lpad = L up to a whole tile (``sm90::work_floats``)."""
    return b * h * (-(-n // _TILE) * _TILE) * 2


def _check_o_lse(what: str, q: torch.Tensor, o: torch.Tensor, lse: torch.Tensor):
    """o shaped and typed as q, lse fp32 (B, H, L): what the bf16 backward
    reads."""
    b, l, h, _ = q.shape
    if o.shape != q.shape or o.dtype != q.dtype or tuple(lse.shape) != (b, h, l) \
            or lse.dtype != torch.float32:
        raise ValueError(f"{what}: o must be {tuple(q.shape)} {q.dtype} and lse ({b}, {h}, "
                         f"{l}) fp32; got {tuple(o.shape)} {o.dtype}, {tuple(lse.shape)} "
                         f"{lse.dtype}")


@functools.cache
def _qblk_bwd_kernel():
    fn = _build.load_library().attention_qblk_bwd
    i64p = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [i64p] * 5 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fused_attention_qblk_bwd_cuda(q, k, v, bias, g, scale, need_dbias, o=None, lse=None):
    global QBLK_BWD_LAUNCHES
    what = "fused_attention_qblk backward"
    hd0 = q.shape[-1]
    q, k, v, bias, g, bias_dtype = _bwd_operands(q, k, v, bias, g, what)
    b, l, h, hd = q.shape
    dbias = None
    if bias is not None and need_dbias:
        dbias = torch.zeros((l, l), dtype=torch.float32, device=q.device)
    # bf16 without dbias: the wgmma kernel on the forward's o and lse
    sm90 = q.dtype == torch.bfloat16 and dbias is None and hd <= _SM90_BWD_MAX_HEAD_DIM
    blank = None
    if sm90:
        q, k, v, g = (_copy_ready(t) for t in (q, k, v, g))
        if o is None or lse is None:  # a direct call: the forward gives them (counted as #4)
            o, lse = _fused_attention_qblk_cuda(q, k, v, bias, scale, want_lse=True)
        o = _pad_head(o, hd)  # the forward's columns past hd0 are exact zeros
        _check_o_lse(what, q, o, lse)
        o = _copy_ready(o) if o.stride(-1) == 1 else o.contiguous()
        lse = lse.contiguous()
        work = torch.empty(_work_floats(b, l, h), dtype=torch.float32, device=q.device)
        if bias is not None:
            blank = torch.empty(2 * (-(-l // _TILE)) ** 2, dtype=torch.uint8, device=q.device)
    else:
        work = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)  # m, l, delta
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    row_stride = bias.stride(2) if bias is not None and l > 1 else 0
    _launch(what, _qblk_bwd_kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), _ptr(o if sm90 else None), _ptr(lse if sm90 else None), _ptr(bias),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), work.data_ptr(),
            _ptr(blank), b, l, h, _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)),
            _strides(v, (0, 1, 2)), _strides(g, (0, 1, 2)),
            _strides(o, (0, 1, 2)) if sm90 else None, row_stride, float(scale),
            int(q.dtype == torch.bfloat16), hd)
    QBLK_BWD_LAUNCHES += 1
    if dbias is not None:
        dbias = dbias[None, None].to(bias_dtype)
    return (*_cut_head(hd0, dq, dk, dv), dbias)


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
            f"attention_qkv backward kernel is built for head dim {_HEAD_DIM} (every ViT "
            f"preset), got {c // heads}")
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
    _launch("attention_qkv backward", _bwd_kernel, qkv.device, qkv.data_ptr(), g.data_ptr(),
            _ptr(o if sm90 else None), _ptr(lse if sm90 else None), _ptr(bias),
            dqkv.data_ptr(), _ptr(dbias), work.data_ptr(), _ptr(blank), b, n, c, heads, n,
            float(scale), int(qkv.dtype == torch.bfloat16))
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
