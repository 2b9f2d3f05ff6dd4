"""The discriminators (counterpart of ``imagefolder_tpu/losses/
discriminators.py``): DinoDisc, the flagship (reference
``discriminator_dino.py``), and the PatchGAN and StyleGAN convnets that
``disc_type`` selects (``discriminator_{patchgan,stylegan}.py``).

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
cuDNN's TF32 path.

``PatchGANDiscriminator`` and ``StyleGANDiscriminator`` take NHWC images and
run in fp32, as the JAX modules (which take no dtype) do; their convs are
``F.conv2d``, exact fp32 on the card while
``torch.backends.cudnn.allow_tf32`` is False. Their parameters keep the
flax modules' names (``conv0``, ``bn1``, ``res_8``, ``fc1``, ...), each a
torch-layout ``weight`` and ``bias``, so ``flax_path`` reads them. PatchGAN's
BatchNorm is flax's (momentum 0.9 on the running statistics, the biased
batch variance as E[x^2] - E[x]^2, eps 1e-5).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.models.vit import ViTBackbone
from imagefolder_tpu_torch.ops.resize import resize
from imagefolder_tpu_torch.parallel.dist import (all_gather_batch, global_batch_rows, global_mean,
                                                 own_rows)
from imagefolder_tpu_torch.utils.init import lecun_normal_, linear_kaiming_uniform_, normal_

__all__ = ["DinoDisc", "BatchNormLocal", "SpectralNormConv1d", "draw_crop",
           "PatchGANDiscriminator", "StyleGANDiscriminator"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class BatchNormLocal(nn.Module):
    """Virtual-batch norm (discriminator_dino.py:127-154) on (B, L, C):
    statistics per channel over each group of ``virtual_bs`` samples and
    the tokens, fp32, biased variance. The groups split the global batch
    (``parallel/dist.py``): where a group straddles two processes' shards,
    every process gathers the batch, normalises it whole and keeps its own
    rows."""

    def __init__(self, c: int, virtual_bs: int = 8, eps: float = 1e-6):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def _norm(self, x: torch.Tensor, group: int) -> torch.Tensor:
        b, l, c = x.shape
        xg = x.float().reshape(b // group, group, l, c)
        var, mean = torch.var_mean(xg, dim=(1, 2), keepdim=True, correction=0)
        xg = (xg - mean) / torch.sqrt(var + self.eps)
        return (xg * self.weight + self.bias).reshape(b, l, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        rows = global_batch_rows(b)[1]
        group = rows // -(-rows // self.virtual_bs)
        if b % group:
            return own_rows(self._norm(all_gather_batch(x), group), b)
        return self._norm(x, group)


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


class _Conv(nn.Module):
    """A flax ``nn.Conv`` on NCHW activations: ``weight`` (out, in, k, k) with
    ``init`` ("normal": N(0, 0.02); "kaiming": U(+-1/sqrt(fan_in))), a zero
    ``bias`` unless ``bias=False``, fp32 ``F.conv2d``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, *,
                 init: str = "kaiming", bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        w = torch.empty(cout, cin, k, k)
        if init == "normal":
            normal_(w, 0.02, generator)
        else:
            linear_kaiming_uniform_(w, cin * k * k, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW's (N, H, W) per channel, in fp32:
    ``scale`` (here ``weight``) drawn N(0, 0.02) as the JAX module draws it.
    In training the batch statistics normalise, and ``update_stats`` keeps
    them in the running buffers; otherwise the running statistics
    normalise."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(normal_(torch.empty(c), 0.02, generator))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, *, train: bool, update_stats: bool) -> torch.Tensor:
        if train:  # the global batch's statistics (parallel/dist.py)
            mean = global_mean(x.mean(dim=(0, 2, 3)))
            var = (global_mean(x.square().mean(dim=(0, 2, 3))) - mean.square()).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class PatchGANDiscriminator(nn.Module):
    """The Pix2Pix NLayer discriminator (discriminator_patchgan.py:8-68):
    conv0 (4x4, stride 2) and LeakyReLU(0.2), then ``n_layers`` of conv (4x4,
    stride 2 but the last 1, no bias), BatchNorm and LeakyReLU, then
    conv_out to one logit per patch. NHWC images -> (B, H', W', 1) fp32
    logits. ``train`` normalises with the batch statistics (the trainer's
    setting in both passes), ``update_stats`` keeps them."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = _Conv(3, ndf, 4, 2, 1, init="normal", generator=generator)
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv{n}", _Conv(ndf * nf_prev, ndf * nf, 4,
                                              2 if n < n_layers else 1, 1, init="normal",
                                              bias=False, generator=generator))
            self.add_module(f"bn{n}", _BatchNorm(ndf * nf, generator=generator))
        self.conv_out = _Conv(ndf * nf, 1, 4, 1, 1, init="normal", generator=generator)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                update_stats: bool = False) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x.float().permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"conv{n}")(x)
            x = getattr(self, f"bn{n}")(x, train=train, update_stats=update_stats)
            x = F.leaky_relu(x, 0.2)
        return self.conv_out(x).permute(0, 2, 3, 1)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """The normalised [1, 2, 1] blur (discriminator_stylegan.py:83-91) per
    channel of NCHW activations, reflect-padded."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = (f[:, None] * f[None, :]) / 16.0
    c = x.shape[1]
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k.expand(c, 1, 3, 3), groups=c)


class StyleGANDiscriminator(nn.Module):
    """The StyleGAN2-style discriminator (discriminator_stylegan.py:13-54):
    conv_in (3x3) and LeakyReLU(0.2); per resolution from ``image_size``
    down to 8, a residual block (res_i: 1x1 stride 2; c1_i, c2_i: 3x3 with
    LeakyReLU; blur; down_i: 3x3 stride 2; the sum over sqrt 2); final_conv
    (3x3) and LeakyReLU, flattened in NHWC order, fc1 (LeakyReLU) and fc2.
    NHWC images -> (B, 1) fp32 logits; it keeps no state."""

    def __init__(self, image_size: int = 256, channel_multiplier: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cm = channel_multiplier
        ch = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm,
              512: 32 * cm, 1024: 16 * cm}
        self.log_size = int(math.log2(image_size))
        in_ch = ch[image_size]
        self.conv_in = _Conv(3, in_ch, 3, 1, 1, generator=generator)
        for i in range(self.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.add_module(f"res_{i}", _Conv(in_ch, out_ch, 1, 2, 0, generator=generator))
            self.add_module(f"c1_{i}", _Conv(in_ch, out_ch, 3, 1, 1, generator=generator))
            self.add_module(f"c2_{i}", _Conv(out_ch, out_ch, 3, 1, 1, generator=generator))
            self.add_module(f"down_{i}", _Conv(out_ch, out_ch, 3, 2, 1, generator=generator))
            in_ch = out_ch
        self.final_conv = _Conv(in_ch, ch[4], 3, 1, 1, generator=generator)
        self.fc1 = nn.Linear(ch[4] * 16, ch[4])
        self.fc2 = nn.Linear(ch[4], 1)
        for fc in (self.fc1, self.fc2):  # flax Dense: lecun normal kernel, zero bias
            lecun_normal_(fc.weight, fc.in_features, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv_in(x.float().permute(0, 3, 1, 2)), 0.2)
        for i in range(self.log_size, 2, -1):
            res = getattr(self, f"res_{i}")(x)
            h = F.leaky_relu(getattr(self, f"c1_{i}")(x), 0.2)
            h = F.leaky_relu(getattr(self, f"c2_{i}")(h), 0.2)
            h = getattr(self, f"down_{i}")(_blur(h))
            x = (h + res) * (1.0 / math.sqrt(2.0))
        x = F.leaky_relu(self.final_conv(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.leaky_relu(self.fc1(x), 0.2))
