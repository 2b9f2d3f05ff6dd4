"""In-training evaluation loops (counterpart of
``imagefolder_tpu/eval/validation.py``, which imports jax: this is a copy of
the parts the VAR trainer uses, on numpy).

- ``pad_to_batch``: pad a ragged batch to the loop's batch size;
- ``var_eval_ep``: VAR's validation epoch (reference trainer.py:58-101),
  per-sample CE and accuracy summed on the host over the real rows only.

One process only: the multi-process all-gather waits for the port's
distributed layer.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

__all__ = ["pad_to_batch", "var_eval_ep"]


def pad_to_batch(arr: np.ndarray, batch: int):
    """Pad the leading dim up to ``batch`` with zeros; returns (padded, true_n)."""
    n = arr.shape[0]
    if n == batch:
        return arr, n
    pad = np.zeros((batch - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad]), n


def var_eval_ep(eval_step: Callable, loader: Iterable, batch_size: int,
                max_batches: Optional[int] = None) -> dict:
    """VAR validation epoch: ``eval_step(imgs, labels)`` takes one padded
    numpy batch and returns a dict of (B,) per-sample vectors (numpy arrays
    or tensors, e.g. ``VARTrainer.eval_step`` on tensors made from them);
    each is summed over the real rows and divided by the sample count."""
    sums = {k: 0.0 for k in ("L_mean", "L_tail", "acc_mean", "acc_tail")}
    tot = 0
    for i, b in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        x, n = pad_to_batch(np.asarray(b["image"]), batch_size)
        y, _ = pad_to_batch(np.asarray(b["label"]), batch_size)
        out = eval_step(x, y)
        for k in sums:
            val = out[k]
            if hasattr(val, "detach"):  # a tensor, possibly on the card
                val = val.detach().cpu().numpy()
            sums[k] += float(np.sum(np.asarray(val)[:n]))
        tot += n
    denom = max(tot, 1)
    return {"val_" + k: v / denom for k, v in sums.items()} | {"val_tot": tot}
