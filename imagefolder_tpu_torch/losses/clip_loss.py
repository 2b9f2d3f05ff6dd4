"""Contrastive (InfoNCE) alignment loss (counterpart of
``imagefolder_tpu/losses/clip_loss.py``; reference ``cliploss.py:66-130``).

The tokenizer's semantic guide aligns the frozen teacher's pooled feature
with the quantized latent's. The batch here is the whole batch: the
reference all-gathers features across ranks, and one card holds them all.
``siglip_loss`` is the reference's pairwise sigmoid loss, which no shipped
config uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["clip_loss", "siglip_loss"]


def clip_loss(feats_a: torch.Tensor, feats_b: torch.Tensor, logit_scale) -> torch.Tensor:
    """Symmetric InfoNCE between two (N, D) feature sets of N aligned pairs,
    in fp32: the mean of the cross entropies of ``logit_scale * a b^T`` by
    rows and by columns against the diagonal."""
    a, b = feats_a.float(), feats_b.float()
    logits = logit_scale * (a @ b.T)
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def siglip_loss(feats_a: torch.Tensor, feats_b: torch.Tensor, logit_scale,
                logit_bias=0.0) -> torch.Tensor:
    """Pairwise sigmoid loss (reference SigLipLoss, cliploss.py:306) in fp32:
    -mean(log sigmoid(label * (logit_scale * a b^T + logit_bias))) * N, the
    label +1 on the diagonal and -1 off it."""
    a, b = feats_a.float(), feats_b.float()
    logits = logit_scale * (a @ b.T) + logit_bias
    n = a.shape[0]
    labels = 2.0 * torch.eye(n, device=a.device) - 1.0
    return -F.logsigmoid(labels * logits).mean() * n
