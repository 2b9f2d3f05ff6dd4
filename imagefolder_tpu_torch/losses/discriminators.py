"""DinoDisc, the flagship discriminator (counterpart of
``imagefolder_tpu/losses/discriminators.py:36-168``; reference
``discriminator_dino.py``).

A frozen DINO ViT-S/16 trunk at 224 px (``init_values=None``: no
LayerScale, the residual stream in the trunk's dtype) whose readouts at
depths {pre, 2, 5, 8, 11} (patches + cls, fp32) each feed a trainable head:
spectral-norm circular conv1d (k=1) -> BatchNormLocal -> LeakyReLU(0.2),
a residual block of the same with k=9, then a spectral-norm conv1d to one
logit per token.

``SpectralNorm`` follows **flax**'s ``nn.SpectralNorm``, which the JAX
package uses, and not ``torch.nn.utils.parametrizations.spectral_norm``:
the kernel is flattened to (k*in, out), ``u`` is (1, out), and every call
runs one power iteration from the stored ``u`` (no gradient through u and
v; sigma is differentiable in the kernel). Only a call with
``update_stats=True`` (the discriminator's own pass) stores the new ``u``
and ``sigma``; the generator's pass leaves them. The circular conv1d is one
fp32 matmul over the gathered k-token neighbourhoods, so it never takes
cuDNN's TF32 path. PatchGAN and StyleGAN are not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.models.vit import ViTBackbone
from imagefolder_tpu_torch.ops.resize import resize
from imagefolder_tpu_torch.utils.init import linear_kaiming_uniform_

__all__ = ["DinoDisc", "BatchNormLocal", "SpectralNormConv1d", "draw_crop"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class BatchNormLocal(nn.Module):
    """Virtual-batch norm (discriminator_dino.py:127-154) on (B, L, C):
    statistics per channel over each group of ``virtual_bs`` samples and
    the tokens, fp32, biased variance."""

    def __init__(self, c: int, virtual_bs: int = 8, eps: float = 1e-6):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        g = -(-b // self.virtual_bs)
        xg = x.float().reshape(g, -1, l, c)
        var, mean = torch.var_mean(xg, dim=(1, 2), keepdim=True, correction=0)
        xg = (xg - mean) / torch.sqrt(var + self.eps)
        return (xg * self.weight + self.bias).reshape(b, l, c)


class SpectralNormConv1d(nn.Module):
    """Circular-padded conv1d over the token axis of (B, L, C) with flax's
    spectral norm. ``weight`` is (out, in, k) as in ``nn.Conv1d``; the
    buffers ``u`` (1, out) and ``sigma`` () are flax's ``spectral``
    collection."""

    def __init__(self, cin: int, cout: int, k: int, *,
                 generator: Optional[torch.Generator] = None, eps: float = 1e-12):
        super().__init__()
        self.k, self.eps = k, eps
        self.weight = nn.Parameter(linear_kaiming_uniform_(torch.empty(cout, cin, k), cin * k,
                                                           generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("u", torch.randn((1, cout), generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def _l2n(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().sum() + self.eps)

    def normalized_kernel(self, update_stats: bool) -> torch.Tensor:
        """The (k*in, out) kernel over sigma, after one power iteration."""
        w = self.weight.permute(2, 1, 0).reshape(-1, self.weight.shape[0])  # flax layout
        with torch.no_grad():
            v0 = self._l2n(self.u @ w.T)
            u0 = self._l2n(v0 @ w)
        sigma = (v0 @ w @ u0.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, *, update_stats: bool) -> torch.Tensor:
        l = x.shape[1]
        pad = (self.k - 1) // 2
        idx = (torch.arange(l, device=x.device)[:, None]
               + torch.arange(self.k, device=x.device)[None, :] - pad) % l
        cols = x.float()[:, idx].flatten(2)  # (B, L, k*in), taps in (k, in) order
        return cols @ self.normalized_kernel(update_stats) + self.bias


class _HeadBlock(nn.Module):
    """make_block (discriminator_dino.py:157-174)."""

    def __init__(self, c: int, k: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = SpectralNormConv1d(c, c, k, generator=generator)
        self.bn = BatchNormLocal(c)

    def forward(self, x: torch.Tensor, *, update_stats: bool) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x, update_stats=update_stats)), 0.2)


class _DinoHead(nn.Module):
    """One head (discriminator_dino.py:208-217) -> logits (B, L)."""

    def __init__(self, c: int, ks: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.b0 = _HeadBlock(c, 1, generator)
        self.b1 = _HeadBlock(c, ks, generator)
        self.out = SpectralNormConv1d(c, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor, *, update_stats: bool) -> torch.Tensor:
        x = self.b0(x, update_stats=update_stats)
        x = (x + self.b1(x, update_stats=update_stats)) * (1.0 / math.sqrt(2.0))
        return self.out(x, update_stats=update_stats)[..., 0]


def draw_crop(height: int, generator: Optional[torch.Generator],
              device: torch.device) -> Optional[tuple]:
    """One step's crop-or-resize draw for inputs above 224 px: (take_crop,
    oh, ow) as 0-d tensors on ``device`` (a crop half the time); None at or
    below 224 px, which takes no draw."""
    if height <= 224:
        return None
    u = torch.rand((), generator=generator, device=device)
    oh, ow = (torch.randint(0, height - 224 + 1, (), generator=generator, device=device)
              for _ in range(2))
    return u <= 0.5, oh, ow


class DinoDisc(nn.Module):
    """Frozen DINO-S/16 trunk at 224 px with readout heads at depths {pre} +
    ``key_depths`` below ``depth``. ``forward(x, crop=None, update_stats=False)``:
    NHWC images in [-1, 1] -> logits (B, 5 * 196), fp32. ``crop`` is a
    ``draw_crop`` result (the training crop-or-resize); None takes the area
    resize. The trunk's parameters are frozen (``requires_grad`` False);
    gradients still flow through it to the image."""

    def __init__(self, depth: int = 12, key_depths: Sequence[int] = (2, 5, 8, 11),
                 ks: int = 9, dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dino = ViTBackbone(img_size=224, patch_size=16, embed_dim=384, depth=depth,
                                num_heads=6, init_values=None, dtype=dtype,
                                generator=generator)
        # the readouts are taken before any final norm, so the trunk has none
        # (flax never creates it)
        self.dino.norm = None
        self.dino.requires_grad_(False)
        self.kd = tuple(d for d in key_depths if d < depth)
        self.heads = nn.ModuleList(_DinoHead(384, ks, generator)
                                   for _ in range(len(self.kd) + 1))
        self.register_buffer("scale", torch.tensor([0.5 / s for s in _IMAGENET_STD]),
                             persistent=False)
        self.register_buffer("shift", torch.tensor(
            [(0.5 - m) / s for m, s in zip(_IMAGENET_MEAN, _IMAGENET_STD)]), persistent=False)

    def preprocess(self, x: torch.Tensor, crop: Optional[tuple]) -> torch.Tensor:
        """[-1, 1] -> ImageNet-normalised 224 x 224 (discriminator_dino.py:296-336):
        bicubic up from below 224; from above, the area resize, or with
        ``crop`` the crop at (oh, ow) where take_crop holds."""
        x = x.float() * self.scale + self.shift
        h = x.shape[1]
        if h == 224:
            return x
        if h < 224:
            return resize(x, (224, 224), "bicubic")
        resized = resize(x, (224, 224), "area")
        if crop is None:
            return resized
        take, oh, ow = crop
        ar = torch.arange(224, device=x.device)
        cropped = x[:, oh + ar][:, :, ow + ar]
        return torch.where(take, cropped, resized)

    def forward(self, x: torch.Tensor, crop: Optional[tuple] = None, *,
                update_stats: bool = False) -> torch.Tensor:
        m = self.dino
        t = m.pos_embed_tokens(m.patchify(self.preprocess(x, crop)))  # (B, 1+L, D) fp32
        acts = [t[:, 1:] + t[:, :1]]  # readout: patches + cls
        t = t.to(m.dtype)
        for i, blk in enumerate(m.blocks):
            t = blk(t)
            if i in self.kd:
                tf = t.float()
                acts.append(tf[:, 1:] + tf[:, :1])
        return torch.cat([head(a, update_stats=update_stats)
                          for head, a in zip(self.heads, acts)], dim=1)
