"""ImageNet-1k class-id -> name table (reference ``imagenet_classes.py``),
stored as JSON data (counterpart of ``imagefolder_tpu/data/classes.py``, a
copy with its own copy of the table)."""

from __future__ import annotations

import functools
import json
from pathlib import Path

__all__ = ["imagenet_idx2classname"]


@functools.lru_cache(maxsize=1)
def imagenet_idx2classname() -> dict[int, str]:
    path = Path(__file__).parent / "imagenet_classes.json"
    return {int(k): v for k, v in json.loads(path.read_text()).items()}
