"""Host input-pipeline benchmark (counterpart of ``scripts/bench_loader.py``):
can the port's loader feed the card?

Measures, on synthetic JPEG data of ImageNet-val-like size (500x375 q87):
  1. the full per-record pipeline (PIL decode -> ADM random-crop resize ->
     fused C++ crop/flip/normalize): img/s on one core;
  2. the fused fastops stage alone (C++ crop+flip+normalize);
  3. a pre-decoded uint8-cache path (np.load + fastops), the fallback when
     decode-bound;
  4. the port's loader end to end (``data/imagenet.py``'s
     ``torch.utils.data`` pipeline) with worker processes, as many as the
     host has cores.

Prints one JSON line: per-core rates and the worker cores needed to sustain
``--target`` img/s, the device rate the loader must keep up with. There is
no default: give the port's own rate on the card, e.g. the VQ-4096 round
trip's img/s that ``chip_smoke.py`` prints (847 img/s on an H100 80GB HBM3
at 700 W, ``PERF.md`` §5). Per-core rate x cores is the capacity model
(loader workers are independent processes, as the reference's DataLoader
num_workers).

Usage: python -m imagefolder_tpu_torch.scripts.bench_loader --target 847 [--n 200]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
from PIL import Image

from imagefolder_tpu_torch.data._native import crop_flip_normalize
from imagefolder_tpu_torch.data.imagenet import (ImageFolderSource, list_image_folder,
                                                 make_dataloader)

__all__ = ["main", "make_dataset"]


def make_dataset(root, n, w=500, h=375, quality=87):
    """n photo-like JPEGs (low-frequency content and noise) in one class
    folder under ``root/train``; returns that tree's path."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "train", "cls0")
    os.makedirs(d, exist_ok=True)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for i in range(n):
        base = (127 + 80 * np.sin(xx / (17 + i % 13)) * np.cos(yy / (23 + i % 7))
                + rng.normal(0, 12, (h, w)))
        img = np.stack([base, np.roll(base, 5, 0), np.roll(base, 9, 1)],
                       axis=-1).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{i}.jpg"), quality=quality)
    return os.path.join(root, "train")


def bench_records(source, n):
    rng = np.random.default_rng(1)
    for i in range(min(8, n)):  # warm-up
        source.getitem_with_rng(i, rng)
    t0 = time.perf_counter()
    for i in range(n):
        source.getitem_with_rng(i % len(source), rng)
    return n / (time.perf_counter() - t0)


def bench_fastops(n, image_size=256):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (image_size + 32, image_size + 32, 3), np.uint8)
    crop_flip_normalize(arr, 0, 0, image_size, True)
    t0 = time.perf_counter()
    for i in range(n):
        crop_flip_normalize(arr, i % 32, (i * 7) % 32, image_size, bool(i & 1))
    return n / (time.perf_counter() - t0)


def bench_predecoded(root, n, image_size=256):
    """The uint8-cache path: np.load of a pre-decoded (288, 288, 3) crop
    source + fastops, what pretokenized or cached pipelines pay a record."""
    rng = np.random.default_rng(3)
    path = os.path.join(root, "cache.npy")
    np.save(path, rng.integers(0, 256, (image_size + 32, image_size + 32, 3), np.uint8))
    np.load(path)
    t0 = time.perf_counter()
    for i in range(n):
        crop_flip_normalize(np.load(path), i % 32, 0, image_size, False)
    return n / (time.perf_counter() - t0)


def bench_loader(data_root, n, batch_size=64, workers=None):
    """The port's train loader's img/s with ``workers`` processes (the
    host's cores by default), after its first batch; returns (rate, the
    workers it runs: the loader keeps every worker at a batch or more)."""
    workers = workers if workers is not None else (os.cpu_count() or 1)
    n_records = len(list_image_folder(data_root)[0])
    workers = max(0, min(workers, n_records // max(batch_size, 1)))
    it = iter(make_dataloader(data_root, batch_size, 256, train=True, num_workers=workers,
                              num_epochs=None, seed=0))
    next(it)  # spin the workers up
    batches = max(n // batch_size, 2)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches * batch_size / (time.perf_counter() - t0)
    del it
    return rate, workers


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.bench_loader")
    ap.add_argument("--target", type=float, required=True,
                    help="device img/s the loader must sustain: the port's own rate on the "
                         "card (e.g. the VQ-4096 round trip's)")
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--keep", default=None, help="reuse/keep the dataset at this dir")
    args = ap.parse_args(argv)

    root = args.keep or tempfile.mkdtemp(prefix="bench_loader_")
    data_root = os.path.join(root, "train")
    if not os.path.isdir(data_root):
        data_root = make_dataset(root, max(args.n, 128))
    files, labels, _ = list_image_folder(data_root)
    src = ImageFolderSource(files, labels, 256, train=True)

    r_full = bench_records(src, args.n)
    r_fast = bench_fastops(args.n * 10)
    r_cache = bench_predecoded(root, args.n * 2)
    r_loader, workers = bench_loader(data_root, args.n)
    out = {
        "metric": "host_loader_images_per_sec_per_core",
        "decode_crop_fastops_per_core": round(r_full, 1),
        "fastops_stage_only_per_core": round(r_fast, 1),
        "predecoded_cache_per_core": round(r_cache, 1),
        "loader_end_to_end": round(r_loader, 1),
        "loader_workers": workers,
        "host_cores": os.cpu_count(),
        "target_device_img_per_sec": args.target,
        "worker_cores_needed_for_target": round(args.target / r_full, 1),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
