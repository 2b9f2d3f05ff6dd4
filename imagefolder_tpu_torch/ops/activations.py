"""Activation functions (counterpart of ``imagefolder_tpu/ops/activations.py``).

The JAX package evaluates erf with the Abramowitz & Stegun 7.1.26 expansion
because Pallas on a TPU cannot lower erf; it differs from the exact erf by at
most 1.5e-7. PyTorch's exact GELU takes its place here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu_exact"]


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU evaluated in fp32, returned in the input dtype."""
    return F.gelu(h.float(), approximate="none").to(h.dtype)
