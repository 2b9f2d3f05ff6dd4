"""StyleGAN-T differentiable augmentation (counterpart of
``imagefolder_tpu/losses/diffaug.py``; reference ``diffaug.py:23-118``).

Translation (+-12.5% with a clamped gather over a 1-px zero pad), colour
jitter (brightness, saturation, contrast), cutout (0.2), and the warm-up
Gaussian blur that DinoDisc sees early in training. NHWC.

The ``*_with_u`` functions take their uniform draws explicitly ((B, 1, 1)
or (B, 1, 1, 1) in [0, 1)): they are the exact math of the reference's
branches given its ``rand01`` tensor. ``diff_aug`` draws them, and the three
per-batch gates, from a ``torch.Generator`` on the images' device, or takes
them from ``draws``; each gated transform is applied with ``torch.where``
(as the JAX package does), so no draw reaches the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["diff_aug", "draw_aug", "warmup_blur", "translate_with_u", "color_with_u",
           "cutout_with_u"]


def warmup_blur(x_BHWC: torch.Tensor, blur_schedule: float) -> torch.Tensor:
    """Gaussian warm-up blur (diffaug.py:46-67), separable, reflect-padded;
    ``blur_schedule`` is a host float."""
    if blur_schedule <= 0:
        return x_BHWC
    h = x_BHWC.shape[1]
    sigma = (h * 0.5) ** 0.5 * blur_schedule
    radius = math.floor(sigma * 3)
    if radius < 1:
        return x_BHWC
    g = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x_BHWC.device)
    g = torch.exp2(-(g / sigma).square())
    g = g / g.sum()
    c = x_BHWC.shape[-1]
    x = F.pad(x_BHWC.permute(0, 3, 1, 2), (radius,) * 4, mode="reflect")
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1)


def translate_with_u(x: torch.Tensor, u_h: torch.Tensor, u_w: torch.Tensor,
                     ratio: float = 0.125) -> torch.Tensor:
    """diffaug.py:84-97 given rand01[0] = u_h, rand01[1] = u_w ((B, 1, 1))."""
    b, h, w, c = x.shape
    dh, dw = round(h * ratio), round(w * ratio)
    th = torch.floor(u_h * (2 * dh + 1)).long() - dh
    tw = torch.floor(u_w * (2 * dw + 1)).long() - dw
    ar_h = torch.arange(h, device=x.device)[None, :, None]
    ar_w = torch.arange(w, device=x.device)[None, None, :]
    gh = (ar_h + th + 1).clamp(0, h + 1)  # (B, H, 1)
    gw = (ar_w + tw + 1).clamp(0, w + 1)  # (B, 1, W)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    xp = torch.gather(xp, 1, gh[..., None].expand(b, h, w + 2, c))
    return torch.gather(xp, 2, gw[..., None].expand(b, h, w, c))


def color_with_u(x: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor,
                 r4: torch.Tensor) -> torch.Tensor:
    """diffaug.py:99-107 given rand01[2:5] ((B, 1, 1, 1) each)."""
    x = x + (r2 - 0.5)  # brightness
    mean_c = x.mean(dim=-1, keepdim=True)
    x = (x - mean_c) * (r3 * 2.0) + mean_c  # saturation
    mean_all = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean_all) * (r4 + 0.5) + mean_all  # contrast


def cutout_with_u(x: torch.Tensor, u5: torch.Tensor, u6: torch.Tensor,
                  ratio: float = 0.2) -> torch.Tensor:
    """diffaug.py:109-121 given rand01[5] = u5, rand01[6] = u6 ((B, 1, 1))."""
    b, h, w, c = x.shape
    ch, cw = round(h * ratio), round(w * ratio)
    oh = torch.floor(u5 * (h + (1 - ch % 2))).long()
    ow = torch.floor(u6 * (w + (1 - cw % 2))).long()
    gh = (torch.arange(ch, device=x.device)[None, :, None] + oh - ch // 2).clamp(0, h - 1)
    gw = (torch.arange(cw, device=x.device)[None, None, :] + ow - cw // 2).clamp(0, w - 1)
    mask = torch.ones((b, h, w), dtype=x.dtype, device=x.device)
    mask[torch.arange(b, device=x.device)[:, None, None], gh, gw] = 0.0
    return x * mask[..., None]


def draw_aug(batch: int, generator: Optional[torch.Generator],
             device: torch.device) -> dict:
    """One ``diff_aug`` call's uniforms: the three gates (3,), translation
    (u_h, u_w), colour (r2, r3, r4) and cutout (u5, u6)."""

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"gates": u(3), "translate": (u(batch, 1, 1), u(batch, 1, 1)),
            "color": (u(batch, 1, 1, 1), u(batch, 1, 1, 1), u(batch, 1, 1, 1)),
            "cutout": (u(batch, 1, 1), u(batch, 1, 1))}


def diff_aug(x_BHWC: torch.Tensor, generator: Optional[torch.Generator] = None,
             prob: float = 1.0, cutout: float = 0.2, blur_schedule: float = 0.0, *,
             draws: Optional[dict] = None) -> torch.Tensor:
    """Warm-up blur, then translation, colour and cutout, each gated by its
    own per-batch Bernoulli(prob) (gate u <= prob). fp32 out. ``draws``
    (``draw_aug``'s dict) replaces the generator's draws."""
    x = warmup_blur(x_BHWC.float(), blur_schedule)
    if prob < 1e-6:
        return x
    d = draws if draws is not None else draw_aug(x.shape[0], generator, x.device)
    gates = d["gates"] <= prob
    x = torch.where(gates[0], translate_with_u(x, *d["translate"]), x)
    x = torch.where(gates[1], color_with_u(x, *d["color"]), x)
    if cutout > 0:
        x = torch.where(gates[2], cutout_with_u(x, *d["cutout"], cutout), x)
    return x
