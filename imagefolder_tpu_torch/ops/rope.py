"""Rotary position embeddings for the ViT decoder's RoPE option
(counterpart of ``imagefolder_tpu/ops/rope.py``; reference
``dino_enc/vision_transformer.py:58-198``): a learnable mixed-2D rotary on
the image tokens and a learnable 1D rotary on the latent tokens.

Complex cis values are carried as (cos, sin) pairs on a last axis of 2, as
the JAX module carries them, so that they are ordinary fp32 parameters. The
frequency initialisers and the token grid are numpy, copied from the JAX
module; ``compute_mixed_cis`` and ``apply_rotary`` are torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["init_1d_freqs", "init_2d_freqs", "init_t_xy", "compute_mixed_cis",
           "apply_rotary"]


def init_1d_freqs(dim: int, end: int, theta: float = 10000.0) -> np.ndarray:
    """(end, dim//2, 2) cos/sin (vision_transformer.py:58-78)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    ang = np.outer(np.arange(end), freqs)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def init_2d_freqs(dim: int, num_heads: int, theta: float = 10.0,
                  rotate: bool = True, seed: int = 0) -> np.ndarray:
    """(2, num_heads, dim//2) fx/fy magnitudes with a random rotation per
    head (vision_transformer.py:81-95)."""
    rng = np.random.default_rng(seed)
    mag = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4] / dim))
    fx, fy = [], []
    for _ in range(num_heads):
        a = rng.random() * 2 * math.pi if rotate else 0.0
        fx.append(np.concatenate([mag * math.cos(a),
                                  mag * math.cos(math.pi / 2 + a)], axis=-1))
        fy.append(np.concatenate([mag * math.sin(a),
                                  mag * math.sin(math.pi / 2 + a)], axis=-1))
    return np.stack([np.stack(fx), np.stack(fy)]).astype(np.float32)


def init_t_xy(end_x: int, end_y: int):
    """The (x, y) grid position of each of end_x * end_y tokens, row-major."""
    t = np.arange(end_x * end_y, dtype=np.float32)
    return t % end_x, np.floor(t / end_x)


def compute_mixed_cis(freqs: torch.Tensor, t_x: torch.Tensor,
                      t_y: torch.Tensor) -> torch.Tensor:
    """freqs (2, H, d/2), t (N,) -> (H, N, d/2, 2) cos/sin
    (vision_transformer.py:104-111)."""
    ang = (t_x[None, :, None] * freqs[0][:, None, :]
           + t_y[None, :, None] * freqs[1][:, None, :])  # (H, N, d/2)
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def apply_rotary(x: torch.Tensor, cis: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, hd); cis: (N, hd//2, 2), shared over heads, or (H, N,
    hd//2, 2). Consecutive channels pair as a complex number (torch
    ``view_as_complex``), rotated in fp32; the result is in x's dtype."""
    b, n, h, hd = x.shape
    xf = x.float().reshape(b, n, h, hd // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    if cis.dim() == 3:  # (N, d/2, 2) shared over heads
        cr, ci = cis[None, :, None, :, 0], cis[None, :, None, :, 1]
    else:  # (H, N, d/2, 2)
        cr = cis[..., 0].permute(1, 0, 2)[None]  # (1, N, H, d/2)
        ci = cis[..., 1].permute(1, 0, 2)[None]
    out = torch.stack([xr * cr - xi * ci, xr * ci + xi * cr], dim=-1)
    return out.reshape(b, n, h, hd).to(x.dtype)
