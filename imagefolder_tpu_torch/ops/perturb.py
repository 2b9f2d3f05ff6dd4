"""RobustTok latent perturbation (counterpart of
``imagefolder_tpu/ops/perturb.py``; reference ``latent_perturbation.py:4-35``).

With probability ``alpha`` each token's code is replaced by a uniformly
random one of its ``delta_eff`` nearest codebook entries, only in the first
floor(B * beta) samples, straight-through to the encoder. The tokenizer
applies it after the vq and commit losses, so that it moves only the
reconstruction, perceptual, GAN and guide gradients
(reference ``xqgan_model.py:295-298``).

The nearest codes come from the fp32 distance on the (normalised) rows, as
``SingleVQ``'s search: exact while ``torch.backends.cuda.matmul.allow_tf32``
stays False. ``torch.topk`` picks the ``delta`` nearest, nearest first, as
``jax.lax.top_k`` of the negated distances does; two codes at the same
distance may come in either order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from imagefolder_tpu_torch.parallel.dist import global_batch_rows

__all__ = ["add_perturbation", "draw_perturbation"]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _nearest_codes(flat_NC: torch.Tensor, emb_VC: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` nearest codes of each row, nearest first: (N, k) indices of
    the smallest fp32 |z|^2 + |e|^2 - 2 z.e."""
    d = (flat_NC.square().sum(dim=-1, keepdim=True) + emb_VC.square().sum(dim=-1)
         - 2.0 * flat_NC @ emb_VC.T)
    return torch.topk(d, k, dim=-1, largest=False).indices


def draw_perturbation(n: int, generator: Optional[torch.Generator],
                      device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of one ``add_perturbation`` over ``n`` tokens:
    the replace-or-keep probability and the pick among the nearest codes,
    each (n,) fp32 in [0, 1)."""
    return (torch.rand((n,), generator=generator, device=device),
            torch.rand((n,), generator=generator, device=device))


def add_perturbation(z_BHWC: torch.Tensor, z_q_BHWC: torch.Tensor, codebook_VC: torch.Tensor,
                     *, alpha: float, beta: float, delta: int,
                     generator: Optional[torch.Generator] = None, codebook_norm: bool = True,
                     delta_eff: Optional[float] = None,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``z_q_BHWC`` with the first floor(B * beta) samples perturbed.
    ``delta`` is the top-k budget (the config's delta); ``delta_eff`` (the
    annealed delta, ``delta`` when None) is clipped to [1, delta] in fp32,
    and the pick is floor(u * delta_eff) of the nearest-first list, or the
    nearest code where the probability draw exceeds ``alpha``. ``draws``
    (a test hook, as ``draw_perturbation`` makes them) replaces the two
    uniform draws from ``generator``. The perturbed samples take the
    straight-through z + sg(e - z) on the (normalised) latent ``z``; the
    codebook gets no gradient from it."""
    if delta <= 0:
        return z_q_BHWC
    if delta_eff is None:
        delta_eff = delta
    b, c = z_BHWC.shape[0], z_BHWC.shape[-1]
    z = z_BHWC.float()
    emb = codebook_VC.detach().float()
    if codebook_norm:
        z, emb = _l2n(z), _l2n(emb)
    flat = z.detach().reshape(-1, c)
    with torch.no_grad():
        top_idx = _nearest_codes(flat, emb, delta)
        u_prob, u_idx = draws if draws is not None else draw_perturbation(
            flat.shape[0], generator, z.device)
        # alpha, beta and delta_eff enter in fp32, as the JAX step's traced scalars
        d_eff = min(max(float(np.float32(delta_eff)), 1.0), float(delta))
        rand_idx = torch.floor(u_idx.float() * d_eff).long()
        rand_idx = torch.where(u_prob.float() > float(np.float32(alpha)), 0, rand_idx)
        chosen = top_idx.gather(1, rand_idx[:, None])[:, 0]
    pq = codebook_VC.detach().float()[chosen]
    if codebook_norm:
        pq = _l2n(pq)
    pq = z + (pq.reshape(z.shape) - z).detach()
    # the first floor(B beta) samples of the global batch, of which this
    # process holds rows r0 to r0 + b (parallel/dist.py)
    r0, rows = global_batch_rows(b)
    n_pert = min(max(math.floor(float(np.float32(rows) * np.float32(beta))) - r0, 0), b)
    if n_pert <= 0:
        return z_q_BHWC
    return torch.cat([pq[:n_pert].to(z_q_BHWC.dtype), z_q_BHWC[n_pert:]], dim=0)
