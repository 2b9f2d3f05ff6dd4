"""LPIPS perceptual loss (counterpart of ``imagefolder_tpu/losses/lpips.py``;
reference ``tokenizer/tokenizer_image/lpips.py``).

VGG16 features (taps after relu1_2, 2_2, 3_3, 4_3, 5_3), the input scaling
layer and one 1x1 linear head per tap: channel-unit-normalised squared
feature differences, spatially averaged, summed over the taps. The VGG convs
run in ``dtype`` (the trainer's ``loss_dtype``) through ``F.conv2d``; the
JAX package runs them through XLA, not Pallas, so they are no kernel to
port. The normalisation, differences and heads are fp32. The module is
frozen. Parameter names are the taming layout that the JAX package's
``convert_lpips_checkpoint`` reads (``net.slice{k}.{i}.weight``,
``lin{i}.model.1.weight``), so a published ``vgg.pth`` would load.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.utils.init import lecun_normal_

__all__ = ["LPIPS"]

# torchvision VGG16 "features": conv index -> channels; max-pools precede
# conv 5, 10, 17 and 24; taps follow relu 3, 8, 15, 22 and 29
_VGG_CFG = [(0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
            (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512)]
_POOL_BEFORE = {5, 10, 17, 24}
_TAP_AFTER = {3, 8, 15, 22, 29}
_SLICE_ENDS = (4, 9, 16, 23, 30)  # taming's slice1..slice5 = features[0:4], [4:9], ...
_LIN_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    """taming NetLinLayer: ``model.1`` is a bias-free 1x1 conv (1, C, 1, 1)."""

    def __init__(self, c: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))
        lecun_normal_(self.model[1].weight, c, generator)


class LPIPS(nn.Module):
    """``forward(x, y)``: NHWC images in [-1, 1] -> per-sample LPIPS
    (B, 1, 1, 1), fp32. Parameters are drawn from ``generator`` (flax's
    default inits) and frozen."""

    def __init__(self, dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Module()
        cin, start = 3, 0
        convs = dict(_VGG_CFG)
        for k, end in enumerate(_SLICE_ENDS, start=1):
            sl = nn.Sequential()
            for i in range(start, end):
                if i in convs:
                    conv = nn.Conv2d(cin, convs[i], 3, padding=1)
                    lecun_normal_(conv.weight, cin * 9, generator)
                    nn.init.zeros_(conv.bias)
                    sl.add_module(str(i), conv)
                    cin = convs[i]
                else:  # the ReLUs and max-pools hold no parameters
                    sl.add_module(str(i), nn.MaxPool2d(2) if i + 1 in _POOL_BEFORE
                                  else nn.ReLU())
            setattr(self.net, f"slice{k}", sl)
            start = end
        for i, c in enumerate(_LIN_CHANNELS):
            setattr(self, f"lin{i}", _Lin(c, generator))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def _features(self, h: torch.Tensor):
        feats = []
        for k in range(1, 6):
            for i, layer in getattr(self.net, f"slice{k}").named_children():
                if isinstance(layer, nn.Conv2d):
                    h = F.conv2d(h, layer.weight.to(self.dtype), layer.bias.to(self.dtype),
                                 padding=1)
                elif isinstance(layer, nn.MaxPool2d):
                    h = F.max_pool2d(h, 2)
                else:
                    h = F.relu(h)
                if int(i) in _TAP_AFTER:
                    feats.append(h.float())
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = torch.cat([x, y]).float().permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        h = ((h - self.shift) / self.scale).to(self.dtype)
        total = 0.0
        for i, f in enumerate(self._features(h)):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            d = (f[:b] - f[b:]).square()
            w = getattr(self, f"lin{i}").model[1].weight.float().flatten()
            total = total + torch.einsum("bchw,c->bhw", d, w).mean(dim=(1, 2))
        return total.view(b, 1, 1, 1)
