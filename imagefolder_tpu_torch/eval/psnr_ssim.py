"""PSNR / SSIM reconstruction metrics (counterpart of
``imagefolder_tpu/eval/psnr_ssim.py``; reference
``tokenizer/vqgan/reconstruction_vqgan_ddp.py:166-196``, which uses
skimage).

SSIM is skimage's for float images in [0, data_range] with
gaussian_weights=False: a 7 x 7 uniform window (a depthwise ``conv2d``, no
padding), C1 = (0.01 R)^2, C2 = (0.03 R)^2, the sample covariance (n / (n -
1)), per channel and averaged. Inputs are NHWC tensors on any device; the
results stay there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim"]


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR (B,) over NHWC batches."""
    mse = (a.float() - b.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """The valid size x size mean of each channel of NCHW ``x``."""
    c = x.shape[1]
    k = torch.full((c, 1, size, size), 1.0 / (size * size), dtype=x.dtype, device=x.device)
    return F.conv2d(x, k, groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Per-image SSIM (B,) of NHWC images in [0, data_range]."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)
    ua, ub = _uniform_filter(a, win_size), _uniform_filter(b, win_size)
    uaa = _uniform_filter(a * a, win_size)
    ubb = _uniform_filter(b * b, win_size)
    uab = _uniform_filter(a * b, win_size)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    s = ((2 * ua * ub + c1) * (2 * vab + c2)) / ((ua ** 2 + ub ** 2 + c1) * (va + vb + c2))
    return s.mean(dim=(1, 2, 3))
