"""What the CLIs share: the device, the tokenizer and checkpoint loaders,
the class-balanced label set of the samplers and their rank-merged npz, and
the per-step generators of the trainers."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.parallel.dist import (
    is_primary,
    process_count,
    process_index,
    sync_global_devices,
)
from imagefolder_tpu_torch.utils.config import load_tokenizer_config
from imagefolder_tpu_torch.utils.hub import load_state_dict_file

__all__ = ["resolve_device", "checkpoint_weights", "load_tokenizer", "class_balanced_batches",
           "save_samples", "step_generator"]

_TORCH_SUFFIXES = {".pt", ".pth", ".bin"}


def resolve_device(name: str) -> torch.device:
    """``--device``: a CUDA device only where there is one; a run asked to
    use the card on a machine without one stops instead of running on the
    CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is False "
                         "(pass --device cpu to run on the CPU)")
    return dev


def checkpoint_weights(path, use_ema: bool = True) -> dict:
    """The weights in ``path`` as a flat {name: CPU tensor}: from a training
    checkpoint of the port (``utils/ckpt.py``: a dict with ``model`` and
    ``ema``) its EMA copy when ``use_ema`` and it has one, else its model;
    from a weight file (``.safetensors``, or a ``torch.load``-able dict,
    unwrapped from its ``ema``, ``model`` or ``state_dict`` entry) its
    tensors."""
    p = Path(path)
    if p.suffix in _TORCH_SUFFIXES:
        sd = torch.load(p, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            ema = sd.get("ema")
            return dict(ema if use_ema and ema is not None else sd["model"])
    return load_state_dict_file(p)


def load_tokenizer(config: str, vq_ckpt: str, device: torch.device,
                   dtype_str: Optional[str] = None):
    """(the frozen ``VQModel`` in eval mode on ``device``, its ModelArgs, the
    run config) from a tokenizer YAML and ``vq_ckpt``: a port training
    checkpoint (its EMA, else its model) or an upstream-layout weight file,
    loaded with strict=True (the counterpart of the JAX package's
    ``scripts/pretokenize.py::_load_params``). ``dtype_str`` overrides the
    YAML's activation dtype (``float32`` for code extraction)."""
    margs, _, run = load_tokenizer_config(
        config, {"dtype_str": dtype_str} if dtype_str else None)
    model = VQModel(margs, device=device)
    model.load_state_dict(checkpoint_weights(vq_ckpt), strict=True)
    return model.requires_grad_(False).eval(), margs, run


def class_balanced_batches(num_samples: int, num_classes: int, batch_size: int):
    """The samplers' label set (sample_imagenet_rar.py:94-101): 0..C-1
    repeated up to ``num_samples``, this process's strided slice (still
    class-balanced), in batches of ``batch_size`` padded with class 0.
    Yields (labels (batch_size,) int64, how many of them are real)."""
    labels = np.tile(np.arange(num_classes), -(-num_samples // num_classes))[:num_samples]
    labels = labels[process_index()::process_count()]
    for i in range(0, len(labels), batch_size):
        lb = labels[i:i + batch_size]
        n = len(lb)
        yield torch.from_numpy(np.pad(lb, (0, batch_size - n)).astype(np.int64)), n


def save_samples(output: str, arr: np.ndarray, num_samples: int) -> Optional[np.ndarray]:
    """Write the uint8 samples as ``output`` (npz, ``arr_0``). In a
    multi-process run each process writes ``<output>.rank<i>.npz``, and
    process 0 merges them in process order; the others return None."""
    if process_count() > 1:
        np.savez(f"{output}.rank{process_index()}", arr_0=arr)
        sync_global_devices("samples")
        if not is_primary():
            return None
        arr = np.concatenate([np.load(f"{output}.rank{i}.npz")["arr_0"]
                              for i in range(process_count())])
    arr = arr[:num_samples]
    np.savez(output, arr_0=arr)
    print(f"wrote {output}: {arr.shape}")
    return arr


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The training draws of step ``step`` of a run seeded ``seed``: a
    generator on ``device`` seeded from both (the JAX scripts'
    ``fold_in(PRNGKey(seed), step)``; the two packages' streams differ), the
    same on every process. A resumed run needs no generator state."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
