"""Nearest-code search (counterpart of
``imagefolder_tpu/ops/pallas/codebook.py::codebook_argmin``).

``codebook_argmin`` dispatches on the tensor's device only: a CPU tensor goes
to ``codebook_argmin_reference``, the plain PyTorch version; a CUDA tensor
launches the hand-written kernel in ``csrc/codebook_argmin.cu`` or raises.
The kernel is compiled at the code widths ``WIDTHS``; the wrapper picks the
smallest that holds the true width C (``kernel_width``) and passes both, and
the kernel zero-fills its tiles' columns past C as it loads them (zero
columns change neither |e|^2 nor x.e, so the indices are those of the
search at C). Past the widest, the widest walks C in chunks of its width,
adding each chunk's products into the same accumulators (each score is
still one fp32 chain over C in order), so every C runs on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from imagefolder_tpu_torch.ops.cuda import _build

__all__ = ["codebook_argmin", "codebook_argmin_reference", "code_ranges", "kernel_width",
           "LAUNCHES", "WIDTHS"]

# kernel launches since the counter was last reset (a caller sets it to 0)
LAUNCHES = 0

# code widths C the kernel is compiled for; 128 holds every codebook_embed_dim
# of the shipped configs and the ModelArgs defaults, and walks a wider C in
# chunks of 128
WIDTHS = (8, 16, 32, 64, 128)


def kernel_width(c: int) -> int:
    """The compiled width that a search at code width ``c`` runs at, which
    the wrapper passes to the kernel's entry (and the entry checks): the
    smallest of ``WIDTHS`` that holds it, and the widest past it (in
    chunks of its width)."""
    if c < 1:
        raise ValueError(f"code width must be positive, got {c}")
    return next((w for w in WIDTHS if c <= w), WIDTHS[-1])



def _check(x: torch.Tensor, codebook: torch.Tensor):
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"x must be (N, C) and codebook (V, C); got {tuple(x.shape)} "
                         f"and {tuple(codebook.shape)}")
    if codebook.shape[0] == 0:
        raise ValueError("empty codebook")


def codebook_argmin_reference(x: torch.Tensor, codebook: torch.Tensor,
                              maximize: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: argmin_v (|e_v|^2 - 2 x.e_v), or
    argmin_v (-2 x.e_v) when ``maximize`` (argmax of the dot product), in fp32,
    first occurrence on ties. Returns (N,) int64."""
    _check(x, codebook)
    x, cb = x.float(), codebook.float()
    dist = -2.0 * (x @ cb.T)
    if not maximize:
        dist = cb.square().sum(dim=-1) + dist
    return torch.argmin(dist, dim=-1)


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous fp32 tensor whose base sits on a 16-byte
    boundary (the kernel copies rows in 16-byte chunks): copied only where
    it is not one already."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _kernel():
    fn = _build.load_library().codebook_argmin
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _codebook_argmin_cuda(x, codebook, maximize):
    global LAUNCHES
    _check(x, codebook)
    if codebook.device != x.device:
        raise ValueError("x and codebook must be on the same device")
    n, c = x.shape
    w = kernel_width(c)
    x, cb = _ready(x), _ready(codebook)
    e2 = None if maximize else cb.square().sum(dim=-1)
    out = torch.empty((n,), dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), cb.data_ptr(), None if e2 is None else e2.data_ptr(),
                        out.data_ptr(), n, cb.shape[0], c, w, stream)
    if err != 0:
        raise RuntimeError(f"codebook_argmin kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def codebook_argmin(x: torch.Tensor, codebook: torch.Tensor,
                    maximize: bool = False) -> torch.Tensor:
    """Nearest codebook index per row: argmin_v |x - e_v|^2 (computed as
    |e_v|^2 - 2 x.e_v), or argmax_v x.e_v with ``maximize`` (callers pass
    L2-normalised rows for a cosine search). x (N, C), codebook (V, C), both
    cast to fp32 (on the card searched by the instantiation at
    ``kernel_width(C)``, over zero columns past C); ties go to the lowest
    index. Returns (N,) int64."""
    if x.device.type == "cpu":
        return codebook_argmin_reference(x, codebook, maximize)
    if x.device.type != "cuda":
        raise ValueError(f"codebook_argmin runs on cpu or cuda, not {x.device}")
    return _codebook_argmin_cuda(x, codebook, maximize)


@functools.cache
def _split_entry():
    fn = _build.load_library().codebook_argmin_split
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def code_ranges(n: int, v: int, c: int, maximize: bool) -> int:
    """The number of code ranges (the cluster size) the card's kernel splits
    a (v, c) codebook into for n rows, as it picks it on the current CUDA
    device; for the checks, which plant codes on the ranges' boundaries."""
    with torch.cuda.device(torch.cuda.current_device()):
        return _split_entry()(n, v, c, kernel_width(c), int(not maximize))
