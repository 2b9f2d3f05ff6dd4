"""ctypes binding for the native data ops (``fastops.cc``; counterpart of
``imagefolder_tpu/data/_native/fastops.py``), compiled with the host's
``g++`` at first use into the package's ``_build/`` directory (gitignored,
beside the CUDA kernels' library). This is host code for the input
pipeline, not a device kernel. Where there is no compiler the numpy path
below runs instead; both give the same bits (``native_available`` says
which one runs)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "fastops.cc"
_BUILD = Path(__file__).resolve().parents[2] / "_build"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[ctypes.CDLL]:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"fastops_{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # a per-process temp name: loader workers may build at once
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            return None
    lib = ctypes.CDLL(str(so))
    lib.crop_flip_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.normalize_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
    return _LIB


def native_available() -> bool:
    return _lib() is not None


def crop_flip_normalize(arr_u8: np.ndarray, oy: int, ox: int, size: int,
                        flip: bool) -> np.ndarray:
    """uint8 HWC -> float32 (size, size, 3) in [-1, 1], the endpoints
    exactly -1 and 1: the crop at (oy, ox), mirrored left to right when
    ``flip``."""
    lib = _lib()
    if lib is None:  # numpy: the same (v / 255 - 0.5) / 0.5 in float64
        c = arr_u8[oy:oy + size, ox:ox + size]
        if flip:
            c = c[:, ::-1]
        return ((c.astype(np.float64) / 255.0 - 0.5) / 0.5).astype(np.float32)
    arr_u8 = np.ascontiguousarray(arr_u8)
    out = np.empty((size, size, 3), np.float32)
    lib.crop_flip_normalize(arr_u8.ctypes.data, arr_u8.shape[0], arr_u8.shape[1],
                            oy, ox, size, int(bool(flip)), out.ctypes.data)
    return out
