"""Image-folder -> webdataset tar shards (counterpart of
``scripts/convert_to_wds.py``; reference ``data/convert_imagenet_to_wds.py``,
HF streaming -> wds.ShardWriter): a dependency-free tar writer over an
ImageFolder tree, emitting the (<key>.<ext>, <key>.cls) pairs that
``data/webdataset.py``'s ``WebDatasetReader`` and the reference
SimpleImageDataset read. Each member's ``TarInfo`` keeps its defaults
(mtime 0, uid 0), so the shards are the JAX script's byte for byte.

Usage:
    python -m imagefolder_tpu_torch.scripts.convert_to_wds --data_path /data/imagenet/train \\
        --output_dir /data/wds --prefix imagenet-train --samples_per_shard 5000

It runs on the host only: no device is used.
"""

from __future__ import annotations

import argparse
import io
import sys
import tarfile
import time
from pathlib import Path
from typing import Optional

from imagefolder_tpu_torch.data.imagenet import list_image_folder

__all__ = ["main", "write_shards"]


def write_shards(data_path: str, output_dir: str, prefix: str,
                 samples_per_shard: int, reencode_quality: int = 0):
    """Write the tree's images, in ``list_image_folder``'s order, into
    ``<prefix>-<shard:06d>.tar`` of ``samples_per_shard`` samples each;
    returns (samples, shards)."""
    files, labels, _ = list_image_folder(data_path)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    first = out_dir / f"{prefix}-000000.tar"
    if first.exists():
        raise FileExistsError(f"{first} already exists")

    def add(tf, name, payload: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tf.addfile(info, io.BytesIO(payload))

    t0 = time.time()
    tf = None
    shard = -1
    for i, (path, label) in enumerate(zip(files, labels)):
        if i % samples_per_shard == 0:
            if tf is not None:
                tf.close()
            shard += 1
            tf = tarfile.open(out_dir / f"{prefix}-{shard:06d}.tar", "w")
            print(f"shard {shard} @ sample {i}", file=sys.stderr)
        key = f"{i:08d}"
        if reencode_quality > 0:
            from PIL import Image

            buf = io.BytesIO()
            Image.open(path).convert("RGB").save(buf, "JPEG", quality=reencode_quality)
            payload = buf.getvalue()
            ext = "jpg"
        else:  # pass the original bytes through untouched
            payload = Path(path).read_bytes()
            ext = Path(path).suffix.lstrip(".").lower() or "jpg"
            if ext == "jpeg":
                ext = "jpg"
        add(tf, f"{key}.{ext}", payload)
        add(tf, f"{key}.cls", str(int(label)).encode())
    if tf is not None:
        tf.close()
    n = len(files)
    print(f"wrote {n} samples in {shard + 1} shards ({time.time() - t0:.1f}s) -> "
          f"{out_dir}/{prefix}-{{000000..{shard:06d}}}.tar")
    return n, shard + 1


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.convert_to_wds")
    ap.add_argument("--data_path", required=True, help="ImageFolder tree")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--prefix", default="imagenet-train")
    ap.add_argument("--samples_per_shard", type=int, default=5000)
    ap.add_argument("--reencode_quality", type=int, default=0,
                    help=">0: re-encode as JPEG at this quality; default passes original "
                         "bytes through")
    args = ap.parse_args(argv)
    return write_shards(args.data_path, args.output_dir, args.prefix,
                        args.samples_per_shard, args.reencode_quality)


if __name__ == "__main__":
    main()
