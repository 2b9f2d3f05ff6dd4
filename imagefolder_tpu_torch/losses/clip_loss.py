"""Contrastive (InfoNCE) alignment loss (counterpart of
``imagefolder_tpu/losses/clip_loss.py``; reference ``cliploss.py:66-130``).

The tokenizer's semantic guide aligns the frozen teacher's pooled feature
with the quantized latent's. The batch here is the whole batch: the
reference all-gathers features across ranks, and one card holds them all.
``siglip_loss`` (unused by the shipped configs) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["clip_loss"]


def clip_loss(feats_a: torch.Tensor, feats_b: torch.Tensor, logit_scale) -> torch.Tensor:
    """Symmetric InfoNCE between two (N, D) feature sets of N aligned pairs,
    in fp32: the mean of the cross entropies of ``logit_scale * a b^T`` by
    rows and by columns against the diagonal."""
    a, b = feats_a.float(), feats_b.float()
    logits = logit_scale * (a @ b.T)
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
