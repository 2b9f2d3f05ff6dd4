"""ViT block sublayers (counterpart of ``imagefolder_tpu/ops/pallas/block.py``).

Two ways through each residual sublayer of a LayerScale block:
- composed (the default, as in the JAX package): projections are PyTorch
  matmuls, the attention goes through the packed-qkv kernel (#1), and the
  bias adds, casts, GELU, LayerScale and fp32 residual add are elementwise
  passes;
- fused (``fused=True``, the counterpart of ``IMGF_FUSE_ATTN`` /
  ``IMGF_FUSE_MLP``, off by default there too): the hand-written GEMMs
  with those passes folded into their epilogues. ``attn_sublayer_fused``
  (TPU kernel ``_attn_sublayer_fused``, #7) is ``csrc/attn_sublayer.cu``,
  launches counted in ``SUBLAYER_ATTN_LAUNCHES``; ``mlp_sublayer_fused``
  (TPU kernel ``_mlp_sublayer_fused``, #8) and ``fused_mlp`` (the MLP probe
  ``scripts/perf.py::fused_mlp``, #10) are ``csrc/mlp_sublayer.cu``, counted
  in ``SUBLAYER_MLP_LAUNCHES`` and ``FUSED_MLP_LAUNCHES``.

Numerics follow the flax Dense layers op for op: y = dtype(x @ W) + dtype(b),
and the residual add runs in fp32 through the fp32 LayerScale; #10 adds its
fp32 biases to the fp32 accumulators instead. Weights are in the PyTorch
(out, in) layout. Each kernel wrapper dispatches on the tensor's device
only: a CPU tensor takes its ``*_reference``, the plain PyTorch version; a
CUDA tensor launches the kernel or raises. The fused sublayers are
differentiable: the backward recomputes through the composed path, as the
JAX package's custom VJPs recompute through XLA (on the card: cuBLAS, #1
and its backward #2).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda import _build
from imagefolder_tpu_torch.ops.cuda import attention as _attn
from imagefolder_tpu_torch.ops.cuda.attention import attention_qkv, attention_qkv_reference

__all__ = ["attn_sublayer", "attn_sublayer_fused", "attn_sublayer_fused_reference", "dense",
           "row_dense",
           "fused_mlp", "fused_mlp_reference", "mlp_sublayer", "mlp_sublayer_fused",
           "mlp_sublayer_fused_reference", "SUBLAYER_ATTN_LAUNCHES", "SUBLAYER_MLP_LAUNCHES",
           "FUSED_MLP_LAUNCHES"]

# kernel launches since the counter was last reset (a caller sets it to 0)
SUBLAYER_ATTN_LAUNCHES = 0
SUBLAYER_MLP_LAUNCHES = 0
FUSED_MLP_LAUNCHES = 0

_WIDTH = 64  # the GEMM's N and K must be multiples of this; #7's head dim


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax Dense(dtype=x.dtype) on fp32 params: x @ W and + b in x's dtype."""
    act = x.dtype
    return F.linear(x, w.to(act)) + b.to(act)


def row_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], tp=None):
    """``dense`` of a row layer; under tensor parallelism (``tp``, a
    ``parallel/mesh.py::ModelShard``) ``x`` and ``w`` hold this rank's input
    columns, and the partial products are summed over the model group (g)
    before the bias is added."""
    if tp is None:
        return dense(x, w, b)
    act = x.dtype
    y = tp.leave(F.linear(x, w.to(act)))
    return y if b is None else y + b.to(act)


# ------------------------------ plain versions ----------------------------- #

def attn_sublayer_fused_reference(xn: torch.Tensor, res: torch.Tensor, wq, bq, wp, bp, ls,
                                  heads: int) -> torch.Tensor:
    """Plain PyTorch version of #7, with the TPU kernel's numerics: qkv =
    dtype(xn Wq^T) + dtype(bq); per head softmax(q k^T / sqrt(hd)) v with p
    rounded to the input dtype before p v and o divided by the fp32 row sum
    after it; y = dtype(o Wp^T) + dtype(bp); res.float() + ls * y (fp32)."""
    o = attention_qkv_reference(dense(xn, wq, bq), heads)
    return res.float() + ls * dense(o, wp, bp)


def mlp_sublayer_fused_reference(xn: torch.Tensor, res: torch.Tensor, w1, b1, w2, b2,
                                 ls) -> torch.Tensor:
    """Plain PyTorch version of #8: h = gelu(dtype(xn W1^T) + dtype(b1)) with
    erf in fp32, rounded to the input dtype; y = dtype(h W2^T) + dtype(b2);
    res.float() + ls * y (fp32). It launches no kernel, and is also the
    composed MLP sublayer."""
    h = gelu_exact(dense(xn, w1, b1))
    return res.float() + ls * dense(h, w2, b2)


def fused_mlp_reference(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of #10 (``scripts/perf.py``'s ``_mlp_kernel``):
    h = dtype(gelu(fp32(x W1^T) + b1)), o = dtype(fp32(h W2^T) + b2), the
    products of dtype-valued operands accumulated in fp32, the biases fp32."""
    act = x.dtype
    h = F.linear(x.float(), w1.to(act).float()) + b1.float()
    h = F.gelu(h, approximate="none").to(act)
    return (F.linear(h.float(), w2.to(act).float()) + b2.float()).to(act)


# --------------------------------- kernels --------------------------------- #

@functools.cache
def _entry(symbol: str):
    """The C entry ``symbol`` of the kernel library, its argument types set
    from the entry's own signature in ``csrc/``."""
    fn = getattr(_build.load_library(), symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "attn_sublayer_fwd": [p] * 10 + [i] * 5 + [ctypes.c_float, i, i, p],
        "mlp_sublayer_fwd": [p] * 9 + [i] * 5 + [p],
        "fused_mlp_fwd": [p] * 7 + [i] * 4 + [p],
    }[symbol]
    fn.restype = ctypes.c_int
    return fn


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and on a 16-byte boundary (the base
    address a TMA tensor map takes); a copy only where it is not already
    so."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_operands(what: str, x: torch.Tensor, shapes: dict):
    """The checks every fused kernel makes: x (and res, where there is one)
    bf16 or fp32, every tensor on x's card and of its given shape."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or fp32 activations, got {x.dtype}")
    for name, (t, shape) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the activations on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}; got {tuple(t.shape)}")
        if name == "res" and t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{what}: res must be bf16 or fp32, got {t.dtype}")


def _check_widths(what: str, **widths: int):
    bad = {k: v for k, v in widths.items() if v % _WIDTH or v <= 0}
    if bad:
        raise ValueError(f"{what} kernel takes widths that are positive multiples of {_WIDTH}; "
                         f"got {bad}")


def _launch(symbol: str, what: str, dev: torch.device, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _attn_sublayer_cuda(xn, res, wq, bq, wp, bp, ls, heads):
    global SUBLAYER_ATTN_LAUNCHES
    what = "attn_sublayer_fused"
    if xn.dim() != 3:
        raise ValueError(f"{what}: xn must be (B, N, C); got {tuple(xn.shape)}")
    b, n, c = xn.shape
    ci = wq.shape[0] // 3  # the heads' width: C, or one rank's heads under TP
    _check_operands(what, xn, {"res": (res, xn.shape), "wq": (wq, (3 * ci, c)),
                               "bq": (bq, (3 * ci,)), "wp": (wp, (c, ci)), "bp": (bp, (c,)),
                               "ls": (ls, (c,))})
    _check_widths(what, C=c, heads_width=ci)
    if heads <= 0 or ci % heads or ci // heads != _attn._HEAD_DIM:
        raise NotImplementedError(f"{what} kernel is built for head dim {_attn._HEAD_DIM} "
                                  f"(every ViT preset), got {ci} wide over {heads} heads")
    act = xn.dtype
    if 0 in (b, n):
        raise ValueError(f"{what} needs a non-empty input; got {tuple(xn.shape)}")
    ops = [_operand(xn, act), _operand(res, res.dtype)]
    ops += [_operand(t, act) for t in (wq, bq, wp, bp)] + [_operand(ls, torch.float32)]
    qkv = torch.empty((b * n, 3 * ci), dtype=act, device=xn.device)
    o = torch.empty((b * n, ci), dtype=act, device=xn.device)
    out = torch.empty((b, n, c), dtype=torch.float32, device=xn.device)
    _launch("attn_sublayer_fwd", what, xn.device, *(t.data_ptr() for t in ops),
            qkv.data_ptr(), o.data_ptr(), out.data_ptr(), b, n, c, ci, heads,
            1.0 / math.sqrt(_attn._HEAD_DIM), int(act == torch.bfloat16),
            int(res.dtype == torch.bfloat16))
    SUBLAYER_ATTN_LAUNCHES += 1
    return out


def _mlp_sublayer_cuda(xn, res, w1, b1, w2, b2, ls):
    global SUBLAYER_MLP_LAUNCHES
    what = "mlp_sublayer_fused"
    c, hid = xn.shape[-1], w1.shape[0]
    _check_operands(what, xn, {"res": (res, xn.shape), "w1": (w1, (hid, c)),
                               "b1": (b1, (hid,)), "w2": (w2, (c, hid)), "b2": (b2, (c,)),
                               "ls": (ls, (c,))})
    _check_widths(what, C=c, hidden=hid)
    act = xn.dtype
    m = xn.numel() // c
    if m == 0:
        raise ValueError(f"{what} needs a non-empty input; got {tuple(xn.shape)}")
    ops = [_operand(xn, act), _operand(res, res.dtype)]
    ops += [_operand(t, act) for t in (w1, b1, w2, b2)] + [_operand(ls, torch.float32)]
    h = torch.empty((m, hid), dtype=act, device=xn.device)
    out = torch.empty(xn.shape, dtype=torch.float32, device=xn.device)
    _launch("mlp_sublayer_fwd", what, xn.device, *(t.data_ptr() for t in ops), h.data_ptr(),
            out.data_ptr(), m, c, hid, int(act == torch.bfloat16),
            int(res.dtype == torch.bfloat16))
    SUBLAYER_MLP_LAUNCHES += 1
    return out


def _fused_mlp_cuda(x, w1, b1, w2, b2):
    global FUSED_MLP_LAUNCHES
    what = "fused_mlp"
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (M, D); got {tuple(x.shape)}")
    m, d = x.shape
    hid = w1.shape[0]
    _check_operands(what, x, {"w1": (w1, (hid, d)), "b1": (b1, (hid,)), "w2": (w2, (d, hid)),
                              "b2": (b2, (d,))})
    _check_widths(what, D=d, hidden=hid)
    if m == 0:
        raise ValueError(f"{what} needs a non-empty input")
    act = x.dtype
    ops = [_operand(x, act), _operand(w1, act), _operand(b1, torch.float32),
           _operand(w2, act), _operand(b2, torch.float32)]
    h = torch.empty((m, hid), dtype=act, device=x.device)
    out = torch.empty((m, d), dtype=act, device=x.device)
    _launch("fused_mlp_fwd", what, x.device, *(t.data_ptr() for t in ops), h.data_ptr(),
            out.data_ptr(), m, d, hid, int(act == torch.bfloat16))
    FUSED_MLP_LAUNCHES += 1
    return out


def _on(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return x.device.type


def _recompute_grads(ctx, composed, g):
    """Gradients of the saved inputs through ``composed`` (the composed
    path), under autograd; None where no gradient is needed."""
    saved = ctx.saved_tensors  # once: under activation checkpointing a second read raises
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        args = [t.detach().requires_grad_(nd) for t, nd in zip(saved, need)]
        out = composed(*args)
        grads = iter(torch.autograd.grad(out, [a for a, nd in zip(args, need) if nd], g))
    return [next(grads) if nd else None for nd in need]


def _attn_composed(xn, res, wq, bq, wp, bp, ls, heads, mask=None, tp=None):
    o = attention_qkv(dense(xn, wq, bq), heads, bias=mask)
    return res.float() + ls * row_dense(o, wp, bp, tp)


class _AttnSublayerFused(torch.autograd.Function):
    """#7 with its gradient: the counterpart of ``_attn_sublayer_diff``
    (``_asd_fwd`` launches the kernel, ``_asd_bwd`` recomputes)."""

    @staticmethod
    def forward(ctx, xn, res, wq, bq, wp, bp, ls, heads):
        ctx.save_for_backward(xn, res, wq, bq, wp, bp, ls)
        ctx.heads = heads
        if xn.device.type == "cpu":
            return attn_sublayer_fused_reference(xn, res, wq, bq, wp, bp, ls, heads)
        return _attn_sublayer_cuda(xn, res, wq, bq, wp, bp, ls, heads)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(ctx, lambda *a: _attn_composed(*a, ctx.heads), g)
        return (*grads, None)


class _MlpSublayerFused(torch.autograd.Function):
    """#8 with its gradient: the counterpart of ``_mlp_sublayer_diff``."""

    @staticmethod
    def forward(ctx, xn, res, w1, b1, w2, b2, ls):
        ctx.save_for_backward(xn, res, w1, b1, w2, b2, ls)
        if xn.device.type == "cpu":
            return mlp_sublayer_fused_reference(xn, res, w1, b1, w2, b2, ls)
        return _mlp_sublayer_cuda(xn, res, w1, b1, w2, b2, ls)

    @staticmethod
    def backward(ctx, g):
        return tuple(_recompute_grads(ctx, mlp_sublayer_fused_reference, g))


def attn_sublayer_fused(xn: torch.Tensor, res: torch.Tensor, wq, bq, wp, bp, ls,
                        heads: int) -> torch.Tensor:
    """res + ls * proj(attn(qkv(xn))) as kernel #7, differentiable. xn: (B, N,
    C) LayerNorm output in the activation dtype (bf16 or fp32); res: the
    residual stream (B, N, C), bf16 or fp32; wq (3C, C), bq (3C,), wp (C, C),
    bp (C,) in any float type (cast to xn's); ls (C,). No mask. On the card C
    must be heads * 64 and a multiple of 64. Returns fp32 (B, N, C)."""
    _on(xn, "attn_sublayer_fused")
    return _AttnSublayerFused.apply(xn, res, wq, bq, wp, bp, ls, heads)


def mlp_sublayer_fused(xn: torch.Tensor, res: torch.Tensor, w1, b1, w2, b2,
                       ls) -> torch.Tensor:
    """res + ls * fc2(gelu_exact(fc1(xn))) as kernel #8, differentiable. xn:
    (..., C) in the activation dtype; res like xn, bf16 or fp32; w1 (H, C),
    b1 (H,), w2 (C, H), b2 (C,), ls (C,). On the card C and H must be
    multiples of 64. Returns fp32, shaped like xn."""
    _on(xn, "mlp_sublayer_fused")
    return _MlpSublayerFused.apply(xn, res, w1, b1, w2, b2, ls)


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """fc2(gelu(fc1(x))) as kernel #10, the MLP probe: x (M, D) bf16 or fp32,
    w1 (H, D), w2 (D, H) cast to x's type, b1 (H,) and b2 (D,) added in fp32
    to the fp32 accumulators. On the card D and H must be multiples of 64.
    Returns (M, D) in x's type. Not differentiable (a probe)."""
    if _on(x, "fused_mlp") == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    return _fused_mlp_cuda(x, w1, b1, w2, b2)


# --------------------------------- routers --------------------------------- #

def attn_sublayer(xn: torch.Tensor, res: torch.Tensor, wq, bq, wp, bp, ls,
                  heads: int, mask: Optional[torch.Tensor] = None,
                  fused: bool = False, tp=None) -> torch.Tensor:
    """res + ls * proj(attn(qkv(xn))). xn: LayerNorm output in the activation
    dtype; res: residual stream. Returns fp32. With ``fused``, no mask and
    N * N within ``_SINGLE_MAX_ELEMS``, kernel #7 (``attn_sublayer_fused``);
    otherwise the composed path, as the JAX router decides (so the 512 px
    decoder, N = 2050, stays on the q-blocked attention).

    Under tensor parallelism (``tp``, a ``parallel/mesh.py::ModelShard``)
    ``wq`` and ``bq`` hold the q, k and v rows of this rank's ``heads``
    heads and ``wp`` their columns; xn enters through f, and the partial
    products of proj are summed over the model group (g). The composed path
    adds ``bp`` after the sum. #7 adds res + ls * (proj + bp) in its
    epilogue, so there rank 0 alone passes res and bp (the others zeros,
    ``ModelShard.first``) and ls enters through f: g then sums ls times every
    rank's partial product, plus res and ls * bp once."""
    n = xn.shape[1]
    if tp is not None:
        xn = tp.enter(xn)
    if fused and mask is None and n * n <= _attn._SINGLE_MAX_ELEMS:
        if tp is None:
            return attn_sublayer_fused(xn, res, wq, bq, wp, bp, ls, heads)
        return tp.leave(attn_sublayer_fused(xn, tp.first(res), wq, bq, wp, tp.first(bp),
                                            tp.enter(ls), heads))
    return _attn_composed(xn, res, wq, bq, wp, bp, ls, heads, mask, tp)


def mlp_sublayer(xn: torch.Tensor, res: torch.Tensor, w1, b1, w2, b2, ls,
                 fused: bool = False) -> torch.Tensor:
    """res + ls * fc2(gelu_exact(fc1(xn))). Returns fp32. With ``fused``,
    kernel #8 (``mlp_sublayer_fused``) at any N, as the JAX router decides;
    otherwise the composed path."""
    if fused:
        return mlp_sublayer_fused(xn, res, w1, b1, w2, b2, ls)
    return mlp_sublayer_fused_reference(xn, res, w1, b1, w2, b2, ls)
