"""GAN objectives and regularizers (counterpart of
``imagefolder_tpu/losses/gan.py``; reference ``vq_loss.py:18-78``).

Pure functions; the LeCam EMA state is a pair of 0-d tensors that the
trainer threads through its steps (the reference mutates floats on the
loss module)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from imagefolder_tpu_torch.parallel.dist import global_mean

__all__ = ["hinge_d_loss", "vanilla_d_loss", "non_saturating_d_loss", "hinge_gen_loss",
           "non_saturating_gen_loss", "adopt_weight", "LeCamState", "lecam_update",
           "lecam_reg", "adaptive_disc_weight", "D_LOSSES", "G_LOSSES"]


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def _bce_logits(target, logits):
    """The reference calls F.binary_cross_entropy_with_logits(target, logits)
    with its arguments swapped (vq_loss.py:33-34): the constant is the input
    and the logits the target. This computes what that call computes."""
    return (target.clamp(min=0) - target * logits
            + torch.logaddexp(torch.zeros_like(target), -target.abs())).mean()


def non_saturating_d_loss(logits_real, logits_fake):
    return 0.5 * (_bce_logits(torch.ones_like(logits_real), logits_real)
                  + _bce_logits(torch.zeros_like(logits_fake), logits_fake))


def hinge_gen_loss(logits_fake):
    return -logits_fake.mean()


def non_saturating_gen_loss(logits_fake):
    return _bce_logits(torch.ones_like(logits_fake), logits_fake)


D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss,
            "non-saturating": non_saturating_d_loss}
G_LOSSES = {"hinge": hinge_gen_loss, "non-saturating": non_saturating_gen_loss}


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """Disc warm start (vq_loss.py:47): ``weight`` from step ``threshold`` on,
    ``value`` before. The step is a host int."""
    return value if global_step < threshold else weight


class LeCamState(NamedTuple):
    logits_real_ema: torch.Tensor
    logits_fake_ema: torch.Tensor

    @staticmethod
    def init(device=None) -> "LeCamState":
        return LeCamState(torch.zeros((), device=device), torch.zeros((), device=device))


def lecam_update(state: LeCamState, logits_real, logits_fake, decay: float = 0.999):
    """The EMAs of the logits' means over the global batch."""
    return LeCamState(
        state.logits_real_ema * decay + global_mean(logits_real.mean()) * (1 - decay),
        state.logits_fake_ema * decay + global_mean(logits_fake.mean()) * (1 - decay))


def lecam_reg(logits_real, logits_fake, state: LeCamState):
    return (F.relu(logits_real - state.logits_fake_ema).square().mean()
            + F.relu(state.logits_real_ema - logits_fake).square().mean())


def adaptive_disc_weight(nll_grad, g_grad, eps: float = 1e-4, group=None):
    """Reference calculate_adaptive_weight (vq_loss.py:153-159):
    ||d nll/dW|| / (||d g/dW|| + eps) clamped to [0, 1e4], without gradient.
    With ``group`` the two gradients are this rank's shards of W's (W split
    by tensor parallelism over that process group), and each norm is the
    whole gradient's: the shards' square norms summed over the group."""
    norms = torch.stack([torch.linalg.vector_norm(nll_grad), torch.linalg.vector_norm(g_grad)])
    if group is not None:
        norms = norms.square()
        dist.all_reduce(norms, group=group)
        norms = norms.sqrt()
    w = norms[0] / (norms[1] + eps)
    return w.clamp(0.0, 1e4).detach()
