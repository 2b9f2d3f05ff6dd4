"""In-training evaluation loops (counterpart of
``imagefolder_tpu/eval/validation.py``):

- ``pad_to_batch``: pad a ragged batch to the loop's batch size;
- ``tokenizer_val_rfid``: the tokenizer's validation rFID and its
  best-checkpoint gate (reference ``xqgan_train.py:516-569``: the uint8
  ``clamp(127.5 x + 128, 0, 255)`` protocol at ``:524-557``, FID by the
  OpenAI evaluator's math), activations streamed batch by batch and
  gathered across processes;
- ``tokenizer_val_psnr``: the PSNR the CLI gates on without Inception
  weights;
- ``var_eval_ep``: VAR's validation epoch (reference trainer.py:58-101),
  per-sample CE and accuracy summed on the host over the real rows only.

A loader may end on a ragged batch: each call pads it to the batch size
and keeps the real rows. Across processes the tokenizer's rows are gathered
by ``_gather_rows`` (``parallel/dist.py``), which takes shards of
different lengths; ``var_eval_ep`` sums on one process only.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from imagefolder_tpu_torch.eval.fid import compute_statistics, frechet_distance
from imagefolder_tpu_torch.parallel.dist import process_allgather, process_count
from imagefolder_tpu_torch.utils.viz import to_uint8

__all__ = ["pad_to_batch", "tokenizer_val_rfid", "tokenizer_val_psnr", "var_eval_ep"]


def pad_to_batch(arr: np.ndarray, batch: int):
    """Pad the leading dim up to ``batch`` with zeros; returns (padded, true_n)."""
    n = arr.shape[0]
    if n == batch:
        return arr, n
    pad = np.zeros((batch - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad]), n


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gather_rows(feats: np.ndarray) -> np.ndarray:
    """Every process's rows, concatenated in process order (the reference
    all-gathers the uint8 samples, xqgan_train.py:529-530; rows of pooled
    features are ~25x smaller, same math). The val split shards without
    dropping a remainder, so the counts may differ by one batch: each
    process pads to the largest count, and the padding is cut off again."""
    if process_count() == 1:
        return feats
    counts = process_allgather(np.asarray([feats.shape[0]], np.int64)).reshape(-1)
    m = int(counts.max())
    padded = np.zeros((m,) + feats.shape[1:], feats.dtype)
    padded[:feats.shape[0]] = feats
    rows = process_allgather(padded)  # (P, m, ...)
    return np.concatenate([rows[p, :int(counts[p])] for p in range(len(counts))], axis=0)


def tokenizer_val_rfid(rec_fn: Callable, params, loader: Iterable, feat_fn: Callable,
                       batch_size: int, max_batches: Optional[int] = None,
                       log: Callable[[str], None] = lambda s: None,
                       gt_cache: Optional[dict] = None) -> float:
    """The validation rFID (xqgan_train.py:516-567).

    ``rec_fn(params, imgs)`` reconstructs a padded numpy batch in [-1, 1]
    (``params``: the model it runs) and ``feat_fn(uint8 NHWC numpy)``
    returns {"pool3": (B, 2048), ...} (tensors or arrays). Both images go
    through the uint8 protocol before Inception. ``gt_cache``: the same dict
    across calls computes the ground truth's statistics once, valid while
    the val loader and ``max_batches`` stay as they are."""
    have_gt = gt_cache is not None and "stats" in gt_cache
    gt_acts, rec_acts, total = [], [], 0
    for i, b in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        x, n = pad_to_batch(_host(b["image"]), batch_size)
        rec_u8 = to_uint8(_host(rec_fn(params, x))[:n])
        rec_pad, _ = pad_to_batch(rec_u8, batch_size)
        rec_acts.append(_host(feat_fn(rec_pad)["pool3"])[:n])
        if not have_gt:
            gt_pad, _ = pad_to_batch(to_uint8(x[:n]), batch_size)
            gt_acts.append(_host(feat_fn(gt_pad)["pool3"])[:n])
        total += n
    rec = _gather_rows(np.concatenate(rec_acts))
    if have_gt:
        s_gt = gt_cache["stats"]
    else:
        s_gt = compute_statistics(_gather_rows(np.concatenate(gt_acts)))
        if gt_cache is not None:
            gt_cache["stats"] = s_gt
    log(f"val rFID over {len(rec)} images ({total} on this process)")
    s_rec = compute_statistics(rec)
    return frechet_distance(s_rec.mu, s_rec.sigma, s_gt.mu, s_gt.sigma)


def tokenizer_val_psnr(rec_fn: Callable, params, loader: Iterable, batch_size: int,
                       max_batches: Optional[int] = None) -> float:
    """The mean PSNR of the reconstructions, the gate used when no
    Inception weights are given (the reference has none: it cannot
    save_best without its TF graph)."""
    from imagefolder_tpu_torch.eval.psnr_ssim import psnr

    vals = []
    for i, b in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        x, n = pad_to_batch(_host(b["image"]), batch_size)
        r = _host(rec_fn(params, x))[:n]
        vals.append(psnr(torch.from_numpy(x[:n] * 0.5 + 0.5),
                         torch.from_numpy(r * 0.5 + 0.5)).numpy())
    return float(np.mean(_gather_rows(np.concatenate(vals))))


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
