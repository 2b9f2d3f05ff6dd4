"""Parameter initializers (counterpart of ``imagefolder_tpu/utils/torch_init.py``
and the flax defaults the JAX modules use), drawn from an explicit
``torch.Generator``. The distributions match the JAX package's; the bits do
not, since the two packages' generators differ.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

__all__ = ["linear", "linear_kaiming_uniform_", "lecun_normal_", "normal_",
           "trunc_normal_", "uniform_"]


@torch.no_grad()
def uniform_(t: torch.Tensor, lo: float, hi: float,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.uniform_(lo, hi, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, std) truncated at +-2 std (timm/torch trunc_normal_)."""
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def linear_kaiming_uniform_(t: torch.Tensor, fan_in: int,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """PyTorch's nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return uniform_(t, -bound, bound, generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default conv kernel init: variance 1/fan_in, truncated normal."""
    # std of a unit normal truncated at +-2, as jax.nn.initializers.variance_scaling
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return trunc_normal_(t, std, generator)


def linear(din: int, dout: int, generator: Optional[torch.Generator] = None,
           bias: bool = True) -> nn.Linear:
    """nn.Linear with the flax Dense init the JAX package uses: torch-default
    kaiming-uniform weight, zero bias."""
    lin = skip_init(nn.Linear, din, dout, bias=bias)
    linear_kaiming_uniform_(lin.weight, din, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin
