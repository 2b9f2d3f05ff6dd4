"""Evaluator CLI (counterpart of ``scripts/evaluate_fid.py``): a reference
npz and a sample npz -> FID, sFID, IS, precision and recall, by the
protocol of the reference ``evaluator.py:27-60`` (the OpenAI
guided-diffusion evaluator):

- activations are InceptionV3's pool3 (2048) and spatial (Mixed_6e's
  first 7 channels, 7 * 17 * 17) features over ``arr_0``'s uint8 NHWC
  batches, the last batch zero-padded (``evaluator.py:151-172``);
- a reference npz that carries ``mu``/``sigma``/``mu_s``/``sigma_s`` is
  used as it is (``evaluator.py:174-187``);
- the Inception Score from the 1008-way softmax (``evaluator.py:195-206``);
- improved precision and recall on pool3 (``evaluator.py:210-216``).

Usage:
    python -m imagefolder_tpu_torch.scripts.evaluate_fid REF.npz SAMPLE.npz \
        (--inception_ckpt <pytorch-fid .pth> | --random_inception) [--device cpu]

``--random_inception`` draws the weights from a seeded generator: it drives
the protocol and its numbers mean nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.eval.fid import (
    FIDStatistics,
    compute_statistics,
    inception_score,
    precision_recall,
)
from imagefolder_tpu_torch.eval.inception import load_inception, uint8_feature_fn
from imagefolder_tpu_torch.scripts._cli import resolve_device

__all__ = ["main", "load_inception_fn", "compute_activations", "read_statistics", "evaluate"]


def load_inception_fn(inception_ckpt: Optional[str], device: torch.device):
    """The feature function over uint8 NHWC in [0, 255], with a warning on
    stderr that the numbers are not validated: the port has no real-weight
    gate, and random weights give meaningless ones."""
    if inception_ckpt is not None:
        print("WARNING: the Inception port has NOT been validated against this checkpoint "
              f"({inception_ckpt}).\n         FID/sFID/IS numbers are NOT trustworthy until "
              "the real-weight gate has run once.", file=sys.stderr, flush=True)
    else:
        print("WARNING: random Inception weights (--random_inception): the FID/sFID/IS "
              "numbers are meaningless.", file=sys.stderr, flush=True)
    return uint8_feature_fn(load_inception(inception_ckpt, device=device), device)


def compute_activations(arr, feat_fn, batch_size: int = 64, verbose: bool = True):
    """uint8 (N, H, W, 3) -> (pool3 (N, 2048), spatial (N, 2023), softmax
    (N, 1008)) as host arrays; the last partial batch is zero-padded and cut
    back (evaluator.py:151-172)."""
    pools, spatials, softs = [], [], []
    n = len(arr)
    for i in range(0, n, batch_size):
        b = arr[i:i + batch_size]
        nb = len(b)
        if nb < batch_size:
            b = np.concatenate([b, np.zeros((batch_size - nb,) + b.shape[1:], b.dtype)])
        out = feat_fn(b)
        pools.append(out["pool3"][:nb].cpu().numpy())
        spatials.append(out["spatial"][:nb].cpu().numpy())
        softs.append(out["softmax"][:nb].cpu().numpy())
        if verbose and (i // batch_size) % 50 == 0:
            print(f"  {i + nb}/{n}", file=sys.stderr)
    return np.concatenate(pools), np.concatenate(spatials), np.concatenate(softs)


def read_batch(path) -> np.ndarray:
    with np.load(path) as obj:
        return obj["arr_0"]


def read_statistics(path, acts):
    """evaluator.py:174-187: a npz's own mu/sigma win over its activations'."""
    with np.load(path) as obj:
        if "mu" in obj:
            return (FIDStatistics(obj["mu"], obj["sigma"]),
                    FIDStatistics(obj["mu_s"], obj["sigma_s"]))
    return compute_statistics(acts[0]), compute_statistics(acts[1])


def evaluate(ref_batch, sample_batch, feat_fn, batch_size: int = 64,
             verbose: bool = True) -> dict:
    """The evaluator's main protocol; returns the five metrics."""
    def log(msg):
        if verbose:
            print(msg)

    log("computing reference batch activations...")
    ref_acts = compute_activations(read_batch(ref_batch), feat_fn, batch_size, verbose)
    log("computing/reading reference batch statistics...")
    ref_stats, ref_stats_spatial = read_statistics(ref_batch, ref_acts)
    log("computing sample batch activations...")
    sample_acts = compute_activations(read_batch(sample_batch), feat_fn, batch_size, verbose)
    log("computing/reading sample batch statistics...")
    sample_stats, sample_stats_spatial = read_statistics(sample_batch, sample_acts)

    log("Computing evaluations...")
    metrics = {"inception_score": inception_score(sample_acts[2]),
               "fid": sample_stats.frechet_distance(ref_stats),
               "sfid": sample_stats_spatial.frechet_distance(ref_stats_spatial)}
    metrics["precision"], metrics["recall"] = precision_recall(ref_acts[0], sample_acts[0])
    log(f"Inception Score: {metrics['inception_score']}")
    log(f"FID: {metrics['fid']}")
    log(f"sFID: {metrics['sfid']}")
    log(f"Precision: {metrics['precision']}")
    log(f"Recall: {metrics['recall']}")
    return metrics


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.evaluate_fid")
    ap.add_argument("ref_batch", help="path to reference batch npz file")
    ap.add_argument("sample_batch", help="path to sample batch npz file")
    ap.add_argument("--inception_ckpt", default=None,
                    help="pytorch-fid InceptionV3 torch checkpoint")
    ap.add_argument("--random_inception", action="store_true",
                    help="drive the protocol with seeded random Inception weights "
                         "(numbers are meaningless)")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.inception_ckpt is None and not args.random_inception:
        ap.error("pass --inception_ckpt (or --random_inception to smoke-test)")
    dev = resolve_device(device or args.device)
    feat_fn = load_inception_fn(args.inception_ckpt, dev)
    return evaluate(args.ref_batch, args.sample_batch, feat_fn, args.batch_size)


if __name__ == "__main__":
    main()
