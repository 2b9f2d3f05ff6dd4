"""A small ``.safetensors`` codec, so that the port reads and writes the
format without the ``safetensors`` package.

The file is an 8-byte little-endian header length N, N bytes of JSON (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the
buffer that follows, and an optional ``__metadata__`` of strings, which
the reader skips; the header is padded with spaces to a multiple of 8),
then the tensors' raw little-endian bytes, C order.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["save_file", "load_file"]

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    return t.detach().cpu().contiguous()


def save_file(tensors: Mapping[str, object], path):
    """Write {name: tensor or numpy array} to ``path``."""
    header, blobs, at = {}, [], 0
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_file(path) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of the file at ``path``."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        buf = bytearray(data[base + begin:base + end])
        flat = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
        out[name] = flat.view(dtype).reshape(info["shape"])
    return out
