"""InceptionV3 feature extractor for FID / sFID / IS (counterpart of
``imagefolder_tpu/eval/inception.py``).

The FID-standard InceptionV3 (pytorch-fid's port of the TF1
``classify_image_graph_def.pb`` that the reference ``evaluator.py:587-629``
runs): BasicConv2d = conv + BatchNorm (eps 1e-3, eval mode) + ReLU, the FID
variants of blocks A, C and E (3 x 3 average pools that leave the padding
out of the count; the last block's pool branch a max pool), 2048-wide pool3
features, 1008-way logits for IS, and the first 7 channels of the Mixed_6e
map as sFID's "spatial" features.

Parameter and buffer names are pytorch-fid's (``Mixed_5b.branch1x1.conv
.weight``, ``...bn.running_var``, ``fc.weight``), the names the JAX
package's ``convert_inception_checkpoint`` reads, so a pytorch-fid ``.pth``
loads with ``load_state_dict(strict=True)`` and no converter. Without one
the weights are drawn from a seeded ``torch.Generator``: such features
drive the FID plumbing and mean nothing.

Input is NHWC in [0, 1] at any size, resized to 299 as the JAX module
resizes (``jax.image.resize``'s antialiased bilinear, ``ops/resize.py``'s
``bilinear_aa``) and mapped to [-1, 1]; the convolutions run NCHW.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.ops.resize import resize

__all__ = ["InceptionV3", "load_inception", "uint8_feature_fn"]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    """3 x 3 stride-1 average pool, the padding left out of the count."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # the last block (pytorch-fid's E_2)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool else _avg_pool3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """``forward`` takes NHWC in [0, 1] and returns {"pool3": (N, 2048),
    "spatial": (N, 7 * 17 * 17), "softmax": (N, 1008)}, fp32. Made in eval
    mode; ``generator`` (a CPU generator) draws the weights, a stand-in
    until a checkpoint is loaded."""

    input_size = 299  # the side every input is resized to

    def __init__(self, num_classes: int = 1008, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.fc = nn.Linear(2048, num_classes)
        self._draw(generator)
        self.to(device).eval()

    @torch.no_grad()
    def _draw(self, generator: Optional[torch.Generator]):
        """He-normal conv kernels (so that the activations keep their scale
        through the ReLUs and two images' features differ), a LeCun-normal
        ``fc``, zero biases, identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(gain / m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x01: torch.Tensor) -> Dict[str, torch.Tensor]:
        side = self.input_size
        x = resize(x01.float(), (side, side), "bilinear_aa") * 2.0 - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        spatial = x[:, :7]  # sFID's features: the first 7 channels at 17 x 17
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "spatial": spatial.reshape(x.shape[0], -1),
                "softmax": torch.softmax(self.fc(pool3), dim=-1)}


def load_inception(path: Optional[str] = None, *, seed: int = 0,
                   device: torch.device | str = "cuda") -> InceptionV3:
    """The InceptionV3 of a pytorch-fid checkpoint (``path``, loaded with
    strict=True after unwrapping a ``state_dict`` entry), or without one
    drawn from ``torch.Generator().manual_seed(seed)``."""
    model = InceptionV3(generator=torch.Generator().manual_seed(seed), device="cpu")
    if path is not None:
        sd = torch.load(Path(path), map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def uint8_feature_fn(inception: InceptionV3, device: torch.device | str) -> Callable:
    """uint8 NHWC (numpy or tensor) in [0, 255] -> ``inception``'s features,
    tensors on ``device``, with no gradient."""
    def feat(x_u8):
        with torch.no_grad():
            return inception(torch.as_tensor(np.asarray(x_u8), device=device).float() / 255.0)
    return feat
