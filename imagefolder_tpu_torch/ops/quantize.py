"""Single-scale vector quantizer (counterpart of
``imagefolder_tpu/ops/quantize.py::SingleVQ``), inference path.

Nearest-code search in fp32: L2-normalised rows when ``codebook_norm``, the
full |z|^2 + |e|^2 - 2 z.e expansion, then ``argmin`` with first-occurrence
ties. The z.e product is a PyTorch fp32 matmul; it is exact fp32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default):
TF32 would flip near-tied codes. The training ``__call__`` (losses, hit
counts, straight-through) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.nn.utils import skip_init

from imagefolder_tpu_torch.utils.init import uniform_

__all__ = ["SingleVQ"]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class SingleVQ(nn.Module):
    """State dict: ``embedding.weight`` (V, C) and the upstream flat (V,)
    ``ema_vocab_hit_SV`` usage buffer."""

    def __init__(self, vocab_size: int, z_channels: int, codebook_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.z_channels = vocab_size, z_channels
        self.codebook_norm = codebook_norm
        self.embedding = skip_init(nn.Embedding, vocab_size, z_channels)
        with torch.no_grad():
            w = uniform_(self.embedding.weight, -1.0 / vocab_size, 1.0 / vocab_size,
                         generator)
            if codebook_norm:
                w.copy_(_l2n(w))
        self.register_buffer("ema_vocab_hit_SV", torch.zeros(vocab_size))

    def _normed_codebook(self) -> torch.Tensor:
        w = self.embedding.weight.float()
        return _l2n(w) if self.codebook_norm else w

    def f_to_idxBl_or_fhat(self, z_BHWC: torch.Tensor, to_fhat: bool,
                           v_patch_nums: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
        """(B, h, w, C) latents -> [quantized (B, h, w, C)] when ``to_fhat``,
        else [indices (B, h*w)]. ``v_patch_nums`` is ignored (single scale)."""
        z = z_BHWC.detach().float()
        if self.codebook_norm:
            z = _l2n(z)
        flat = z.reshape(-1, self.z_channels)
        emb = self._normed_codebook()
        d = (flat.square().sum(dim=-1, keepdim=True) + emb.square().sum(dim=-1)
             - 2.0 * flat @ emb.T)
        idx = torch.argmin(d, dim=-1)
        if not to_fhat:
            return [idx.reshape(z.shape[0], -1)]
        return [self.embed(idx).reshape(z.shape)]

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        z_q = self.embedding.weight.float()[idx]
        return _l2n(z_q) if self.codebook_norm else z_q
