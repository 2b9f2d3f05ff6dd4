"""Visualisation grids (counterpart of ``imagefolder_tpu/utils/viz.py``;
reference ``utils/viz_utils.py``): original / reconstruction / difference
panels and generation grids, on host numpy arrays (a tensor is read back
first)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["recon_grid", "generation_grid", "scale_recon_grid", "to_uint8", "save_png"]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def to_uint8(img_pm1) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (reference clamp(127.5 x + 128),
    xqgan_train.py:524-557)."""
    return np.clip(127.5 * _np(img_pm1) + 128.0, 0, 255).astype(np.uint8)


def _grid(rows) -> np.ndarray:
    return np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)


def recon_grid(originals_pm1, recons_pm1, max_items: int = 8) -> np.ndarray:
    """(orig | recon | 0.5 + diff) panel per sample (viz_utils.py:22-52)."""
    o = _np(originals_pm1)[:max_items]
    r = _np(recons_pm1)[:max_items]
    diff = np.clip((o - r) * 0.5 + 0.5, 0, 1) * 2.0 - 1.0
    return to_uint8(_grid([(o[i], r[i], diff[i]) for i in range(len(o))]))


def generation_grid(samples_pm1, ncol: int = 8) -> np.ndarray:
    """Tiled generation preview (viz_utils.py:55-66)."""
    s = _np(samples_pm1)
    n = (len(s) // ncol) * ncol
    return to_uint8(_grid([s[i:i + ncol] for i in range(0, n, ncol)]))


def scale_recon_grid(imgs_pm1, recons_per_scale, ncol: int = 4) -> np.ndarray:
    """Per-scale recon panel (reference xqgan_train.py:504-513: make_grid of
    ``recons_with_scale + [imgs]``, nrow=4): one row per quantizer scale,
    the originals as the last row."""
    stack = np.concatenate([_np(r)[:ncol] for r in recons_per_scale] + [_np(imgs_pm1)[:ncol]])
    return generation_grid(np.clip(stack, -1, 1), ncol=ncol)


def save_png(img_uint8_hwc, path) -> None:
    """Write an (H, W, 3) uint8 array as PNG (Pillow, imported here)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(img_uint8_hwc)).save(path)
