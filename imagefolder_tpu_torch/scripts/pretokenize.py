"""Offline pretokenization for RAR training (counterpart of
``scripts/pretokenize.py``; reference ``scripts/pretokenization.py``):
encode each train image (center + hflip x2, or ten-crop x10) to its
final-scale token ids and write ``pretokenized.jsonl`` rows of
``{"class_id": int, "tokens": [...]}``, in the folder's order, each image's
crops in turn.

Usage:
    python -m imagefolder_tpu_torch.scripts.pretokenize --config configs/RobustTok.yaml \
        --vq_ckpt <file> --data_path <dir> --output out.jsonl [--crop_mode ten_crop] \
        [--device cpu]

Codes are argmax-sensitive, so the tokenizer runs in fp32 whatever the
YAML's dtype (as the reference's autocast-free pretokenization.py).
``--vq_ckpt`` is a port training checkpoint (its EMA, else its model) or an
upstream-layout weight file. In a multi-process run each process encodes a
strided share of the files into ``<output>.rank<i>`` and process 0 merges
the parts in process order (pretokenization.py:218-254).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.data.imagenet import center_crop_arr, list_image_folder
from imagefolder_tpu_torch.parallel.dist import (
    add_distributed_args,
    init_from_args,
    process_count,
    process_index,
    sync_global_devices,
)
from imagefolder_tpu_torch.scripts._cli import load_tokenizer, resolve_device

__all__ = ["main", "crops_for"]


def crops_for(img_hwc: np.ndarray, mode: str, size: int):
    """center + hflip (x2), or ten-crop (x10: the four corners and the
    center of a ``size`` window, each with its flip) (pretokenization.py:
    165-186)."""
    crops = []
    if mode == "center":
        crops = [img_hwc, img_hwc[:, ::-1]]
    else:
        h, w = img_hwc.shape[:2]
        offs = [(0, 0), (0, w - size), (h - size, 0), (h - size, w - size),
                ((h - size) // 2, (w - size) // 2)]
        for oy, ox in offs:
            c = img_hwc[oy:oy + size, ox:ox + size]
            crops.extend([c, c[:, ::-1]])
    return [np.ascontiguousarray(c) for c in crops]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.pretokenize")
    ap.add_argument("--config", required=True)
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--output", default="pretokenized.jsonl")
    ap.add_argument("--crop_mode", choices=["center", "ten_crop"], default="center")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda")
    return add_distributed_args(ap)


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"output": the JSONL's path, "rows": rows this process wrote,
    "batches": encode calls}."""
    from PIL import Image

    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)
    model, margs, run = load_tokenizer(args.config, args.vq_ckpt, dev, "float32")
    data_path = args.data_path or run.data_path

    files, labels, _ = list_image_folder(data_path)
    rank, nproc = process_index(), process_count()
    part_path = args.output
    if nproc > 1:
        files, labels = files[rank::nproc], labels[rank::nproc]
        part_path = f"{args.output}.rank{rank}"
    Path(part_path).parent.mkdir(parents=True, exist_ok=True)
    size = margs.image_size
    batch_imgs, batch_labels = [], []
    rows = batches = 0
    with open(part_path, "w") as out:
        def flush():
            nonlocal rows, batches
            if not batch_imgs:
                return
            x = torch.from_numpy(np.stack(batch_imgs)).to(dev) / 127.5 - 1.0
            with torch.no_grad():
                toks = model.encode_to_tokens(x).cpu().numpy()
            for t, lb in zip(toks, batch_labels):
                out.write(json.dumps({"class_id": int(lb), "tokens": t.tolist()}) + "\n")
            rows += len(batch_labels)
            batches += 1
            batch_imgs.clear()
            batch_labels.clear()

        for f, lb in zip(files, labels):
            img = Image.open(f).convert("RGB")
            base = center_crop_arr(img, size if args.crop_mode == "center" else size + 32)
            for c in crops_for(base.astype(np.float32), args.crop_mode, size):
                batch_imgs.append(c[:size, :size])
                batch_labels.append(lb)
                if len(batch_imgs) >= args.batch_size:
                    flush()
        flush()
    if nproc > 1:
        sync_global_devices("pretokenize")
        if rank == 0:
            with open(args.output, "w") as merged:
                for i in range(nproc):
                    merged.write(Path(f"{args.output}.rank{i}").read_text())
    print(f"wrote {args.output}")
    return {"output": args.output, "rows": rows, "batches": batches}


if __name__ == "__main__":
    main()
