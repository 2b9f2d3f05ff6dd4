"""Torch-parity image resizing as separable matrix multiplies
(counterpart of ``imagefolder_tpu/ops/resize.py``).

Each resize is a fixed linear map per axis: an (out, in) interpolation matrix
built on the host in float64 with numpy and applied as two fp32 matmuls. The
matrices reproduce ``F.interpolate``'s ``area``, ``bicubic``
(align_corners=False, antialias=False), legacy ``nearest`` and antialiased
``bicubic`` (the timm pos-embed resampling path), so code indices match the
JAX package's. The builders are a copy of the JAX package's numpy code: the
port imports nothing of that package.

Inputs are NHWC (or HWC), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize", "resize_matrix"]

_A = -0.75  # torch's bicubic coefficient (cubic convolution, Keys 1981)


def _cubic_w1(t: np.ndarray) -> np.ndarray:
    # weight for the two inner taps, |offset| = t in [0, 1]
    return ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0


def _cubic_w0(t: np.ndarray) -> np.ndarray:
    # weight for the two outer taps, offset = t + 1 in [1, 2]
    return ((_A * (t + 1.0) - 5.0 * _A) * (t + 1.0) + 8.0 * _A) * (t + 1.0) - 4.0 * _A


def _bicubic_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Row-stochastic (out,in) matrix matching torch bicubic, align_corners=False,
    antialias=False (torch clamps out-of-range taps to the border)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        f = int(np.floor(src))
        t = src - f
        ws = (_cubic_w0(np.float64(t)), _cubic_w1(np.float64(t)),
              _cubic_w1(np.float64(1.0 - t)), _cubic_w0(np.float64(1.0 - t)))
        for k, w in enumerate(ws):
            idx = min(max(f - 1 + k, 0), in_size - 1)
            m[o, idx] += w
    return m


def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out,in) matrix matching torch mode='area' (= adaptive average pooling:
    output cell o averages input rows [floor(o*in/out), ceil((o+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        start = (o * in_size) // out_size
        end = -((-(o + 1) * in_size) // out_size)  # ceil div
        m[o, start:end] = 1.0 / (end - start)
    return m


def _nearest_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out,in) matrix matching torch legacy mode='nearest': src = floor(o*in/out)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        src = min(int(o * in_size / out_size), in_size - 1)
        m[o, src] = 1.0
    return m


_A_AA = -0.5  # antialias path uses PIL's bicubic coefficient, not -0.75


def _cubic_kernel(x: np.ndarray, a: float = _A_AA) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0),
    )


def _bicubic_aa_matrix(out_size: int, in_size: int) -> np.ndarray:
    """torch bicubic with antialias=True (the timm resample_abs_pos_embed
    path). PIL-style separable resampling: kernel support scaled by the
    downsample factor, truncated integer window, weights normalized to 1."""
    scale = in_size / out_size
    inv = 1.0 / max(scale, 1.0)
    support = 2.0 * max(scale, 1.0)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        j = np.arange(lo, hi)
        w = _cubic_kernel((j - center + 0.5) * inv)
        s = w.sum()
        if s != 0:
            w = w / s
        m[o, lo:hi] = w
    return m


_MODES = {
    "bicubic": _bicubic_matrix,
    "bicubic_aa": _bicubic_aa_matrix,
    "area": _area_matrix,
    "nearest": _nearest_matrix,
}


@functools.lru_cache(maxsize=None)
def resize_matrix(out_size: int, in_size: int, mode: str) -> np.ndarray:
    """Cached float32 (out,in) interpolation matrix for one axis. The cache
    hands every caller the same array: treat it as read-only."""
    if mode not in _MODES:
        raise ValueError(f"unknown resize mode {mode!r}; options: {sorted(_MODES)}")
    m = np.ascontiguousarray(_MODES[mode](out_size, in_size), dtype=np.float32)
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=None)
def _matrix(out_size: int, in_size: int, mode: str, device: torch.device) -> torch.Tensor:
    """The matrix on ``device``, copied there once: a host-to-card copy on
    every call would wait for the card each time. Made outside inference
    mode, so that the cached tensor serves every later caller."""
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(out_size, in_size, mode).copy()).to(device)


def resize(x: torch.Tensor, size: tuple[int, int], mode: str = "bicubic") -> torch.Tensor:
    """Resize NHWC (or HWC) ``x`` to spatial ``size`` with torch-interpolate
    parity. Identity sizes return ``x``. Runs in fp32 (the matmuls are exact
    fp32 while ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's
    default) and returns the input dtype."""
    out_h, out_w = size
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = _matrix(out_h, in_h, mode, x.device)
    ww = _matrix(out_w, in_w, mode, x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x.float())
    y = torch.einsum("pw,...owc->...opc", ww, y)
    return y.to(x.dtype)
