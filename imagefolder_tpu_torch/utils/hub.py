"""Weight-file interchange (counterpart of ``imagefolder_tpu/utils/hub.py``;
reference ``RAR/modules/base_model.py:15-127``, ``BaseModel``'s
``save_pretrained_weight`` / ``load_pretrained_weight``).

The port's ``VQModel``, ``RAR`` and ``VAR`` keep the upstream torch layout
in their state dicts (``utils/convert.py``), so a file written here loads
in the upstream repo and in the JAX package's converters, and a file of
theirs loads here with ``strict=True``. Formats by suffix:
``.safetensors`` (the port's own codec, ``utils/safetensors.py``) and
``.bin`` / ``.pt`` / ``.pth`` (``torch.save`` of the tensor state dict).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Optional

import torch
from torch import nn

from imagefolder_tpu_torch.utils import safetensors

__all__ = ["save_pretrained_weight", "load_pretrained_weight", "save_pretrained",
           "load_state_dict_file"]

_KINDS = {"vqmodel", "rar", "var"}
_TORCH_SUFFIXES = {".bin", ".pt", ".pth"}


def _state_dict(model_or_sd) -> dict:
    sd = model_or_sd.state_dict() if isinstance(model_or_sd, nn.Module) else model_or_sd
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def save_pretrained_weight(path, model: nn.Module | Mapping) -> Path:
    """Write ``model``'s state dict (or a state dict) as a reference-layout
    weight file (base_model.py:52-81)."""
    path = Path(path)
    if path.suffix != ".safetensors" and path.suffix not in _TORCH_SUFFIXES:
        raise ValueError(f"unknown weight suffix {path.suffix!r} (.safetensors/.bin/.pt/.pth)")
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = _state_dict(model)
    if path.suffix == ".safetensors":
        safetensors.save_file(sd, path)
    else:
        torch.save(sd, path)
    return path


def load_state_dict_file(path) -> dict:
    """A weight or checkpoint file as a flat {name: CPU tensor}: a
    ``.safetensors`` file, or a ``torch.load``-able dict, unwrapped from its
    ``ema``, ``model`` or ``state_dict`` entry where it has one (the
    reference's training checkpoints; base_model.py:83-127, pretokenize.py's
    reader)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return safetensors.load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        for k in ("ema", "model", "state_dict"):
            if k in sd:
                sd = sd[k]
                break
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_pretrained_weight(path, model: nn.Module) -> nn.Module:
    """Load a weight file into ``model`` with strict=True (its parameters
    keep their device and dtype); returns the model."""
    model.load_state_dict(load_state_dict_file(path), strict=True)
    return model


def save_pretrained(directory, model: nn.Module | Mapping, kind: str,
                    config: Optional[dict] = None) -> Path:
    """HF-style directory: ``model.safetensors`` and ``config.json``
    (base_model.py:15-50); ``kind`` is one of vqmodel, rar, var."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    save_pretrained_weight(directory / "model.safetensors", model)
    (directory / "config.json").write_text(
        json.dumps({"model_kind": kind, **(config or {})}, indent=1))
    return directory
