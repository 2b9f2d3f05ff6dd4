"""What the CLIs share."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str) -> torch.device:
    """``--device``: a CUDA device only where there is one; a run asked to
    use the card on a machine without one stops instead of running on the
    CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is False "
                         "(pass --device cpu to run on the CPU)")
    return dev
