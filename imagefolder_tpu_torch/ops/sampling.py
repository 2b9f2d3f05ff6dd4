"""Token sampling helpers (counterpart of ``imagefolder_tpu/ops/sampling.py``;
reference ``models/helpers.py:6-38``).

top-k / top-p filtered categorical sampling and gumbel-softmax. The JAX
package found its thresholds with a 32-pass search on the float32 bit
lattice, because sorts were slow on the TPU; on the card ``torch.topk`` and
``torch.sort`` take their place, with the same kept set: top-k keeps every
logit >= the k-th largest value (``top_k`` clamped to the vocabulary), top-p
removes a token when the probability mass of all tokens at or below its
probability is <= 1 - top_p (ties counted together), and the row argmax is
always kept. Sampling is gumbel-max with noise drawn from an explicit
``torch.Generator`` on the logits' device.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["top_k_top_p_filter", "sample_with_top_k_top_p", "gumbel_softmax", "gumbel"]


def top_k_top_p_filter(logits_BlV: torch.Tensor, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Mask logits outside top-k / nucleus top-p with -inf (helpers.py:8-15).
    Returns fp32."""
    logits = logits_BlV.float()
    v = logits.shape[-1]
    # clamp to the vocab size: the reference CLIs default top_k=900 assuming
    # V=4096 (inference.py:32); a small vocabulary degrades to no filter
    top_k = min(top_k, v)
    if 0 < top_k < v:
        kth = torch.topk(logits, top_k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p > 0:
        probs = torch.softmax(logits, dim=-1)
        sorted_p, order = torch.sort(probs, dim=-1)
        mass = torch.cumsum(sorted_p, dim=-1)
        # tied probabilities share the mass at the last of their run
        last_tie = torch.searchsorted(sorted_p, sorted_p, right=True) - 1
        remove_sorted = torch.gather(mass, -1, last_tie) <= (1.0 - top_p)
        remove = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
        # the largest logit always stays (the reference keeps the last sorted one)
        remove.scatter_(-1, logits.argmax(dim=-1, keepdim=True), False)
        logits = logits.masked_fill(remove, float("-inf"))
    return logits


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U ~ U[0, 1), fp32."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample_with_top_k_top_p(logits_BlV: torch.Tensor, generator: Optional[torch.Generator],
                            top_k: int = 0, top_p: float = 0.0,
                            return_p: bool = False) -> torch.Tensor:
    """One draw per row from the filtered logits (gumbel-max): (B, l) int64
    indices, or the filtered softmax when ``return_p``."""
    logits = top_k_top_p_filter(logits_BlV, top_k, top_p)
    if return_p:
        return torch.softmax(logits, dim=-1)
    return (logits + gumbel(logits.shape, generator, logits.device)).argmax(dim=-1)


def gumbel_softmax(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                   tau: float = 1.0, hard: bool = False,
                   g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-softmax (helpers.py:25-40). ``g`` injects explicit gumbel noise
    (the tests share it with the JAX package); otherwise it is drawn from
    ``generator``."""
    if g is None:
        g = gumbel(logits.shape, generator, logits.device)
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        idx = y.argmax(dim=-1, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(-1, idx, 1.0)
        y = y_hard - y.detach() + y
    return y
