"""Quantizers (counterpart of ``imagefolder_tpu/ops/quantize.py``).

- ``SingleVQ``: the single-scale VQ of the main round trip. Nearest-code
  search in fp32: L2-normalised rows when ``codebook_norm``, the full
  |z|^2 + |e|^2 - 2 z.e expansion, then ``argmin`` with first-occurrence
  ties (its own distance matrix, as in the JAX package).
- ``MultiScaleVQ``: the multi-scale residual VQ of the VAR tokenizers. Per
  scale it area-pools the residual, looks the codes up through
  ``_codebook_lookup`` (the ``codebook_argmin`` kernel on a CUDA tensor),
  bicubic-upsamples the code map and applies the scale's ``Phi`` conv. Its
  training ``forward`` (quant.py:64-144) adds quantizer dropout, the vq and
  commit losses, straight-through f_hat and per-scale hit counts
  (``QuantOut``); ``update_usage_ema`` and ``usage_percent`` turn the hits
  into the trainer's codebook-usage metrics.

``SingleVQ``'s training ``forward`` (xqgan_model.py:722-790) returns the
same ``QuantOut``: the vq and commit losses, straight-through ``f_hat``, one
row of hit counts and an entropy loss of 0; it has no quantizer dropout.

The z.e products, the resizes and the Phi convs are PyTorch fp32 matmuls,
exact fp32 as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(PyTorch's default): TF32 would flip near-tied codes. ``Phi`` is written as
a matmul over the 3x3 neighbourhood rather than a conv, because cuDNN runs
fp32 convs in TF32 by default (``torch.backends.cudnn.allow_tf32``).

- ``MultiScaleLFQ``: the lookup-free quantizer (LFQ) and, with
  ``using_znorm``, binary spherical quantization (BSQ) of the MSBR recipes.
  A code is the latent's sign bits, scaled by ``scale**si`` (divided by
  sqrt(Cvae) under BSQ), so no codebook is searched and no kernel runs: the
  residual pyramid, the Phi bank, quantizer dropout and the VAR interface
  are the multi-scale VQ's, and the entropy loss is the soft per-bit one
  (the default) or MagViT's logits entropy over the full 2**Cvae codebook,
  a plain product left to ``torch.matmul`` as the JAX package leaves it to
  XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from imagefolder_tpu_torch.ops.cuda.codebook import codebook_argmin
from imagefolder_tpu_torch.ops.resize import resize
from imagefolder_tpu_torch.parallel.dist import global_batch_rows, global_mean, global_sum
from imagefolder_tpu_torch.utils.init import uniform_

__all__ = ["SingleVQ", "MultiScaleVQ", "MultiScaleLFQ", "Phi", "phi_index", "QuantOut",
           "update_usage_ema", "usage_percent"]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


@dataclasses.dataclass
class QuantOut:
    """Result of a training-mode quantizer call (the reference forward's
    ``(f_hat, usages, vq_loss, commit_loss, entropy_loss)``, with usage as
    raw hit counts so that its EMA lives in the trainer)."""

    f_hat: torch.Tensor         # (B, H, W, C) straight-through quantized feature
    vq_loss: torch.Tensor       # 0-d
    commit_loss: torch.Tensor   # 0-d
    entropy_loss: torch.Tensor  # 0-d (0 for plain VQ)
    hits_SV: torch.Tensor       # (S, V) this batch's codebook hit counts, fp32


def _n_quantizers(batch: int, num_scales: int, codebook_drop: float,
                  dropout_n: Optional[torch.Tensor], train: bool,
                  device: torch.device) -> torch.Tensor:
    """Per-sample active-scale count (quant.py:79-86), fp32 (B,).
    ``dropout_n`` is the shared randint(start_drop, S + 1) draw; only the
    first ``int(B * codebook_drop)`` samples of the global batch adopt it
    (``parallel/dist.py``: this process's rows start at r0)."""
    full = torch.full((batch,), float(num_scales + 1), device=device)
    if not train or dropout_n is None or codebook_drop <= 0.0:
        return full
    r0, rows = global_batch_rows(batch)
    keep = torch.arange(r0, r0 + batch, device=device) >= int(rows * codebook_drop)
    return torch.where(keep, full, dropout_n.to(device=device, dtype=torch.float32))


@torch.no_grad()
def update_usage_ema(ema_SV: torch.Tensor, hits_SV: torch.Tensor, record_hit: int):
    """EMA of codebook hits with the reference's warm-up (quant.py:121-127):
    a copy at record 0, decay 0.9 below 100 records, then 0.99. Returns
    (new EMA, record_hit + 1); ``record_hit`` is a host int."""
    decay = 0.0 if record_hit == 0 else (0.9 if record_hit < 100 else 0.99)
    return ema_SV * decay + hits_SV * (1.0 - decay), record_hit + 1


def usage_percent(ema_SV: torch.Tensor, tokens_per_scale: float,
                  vocab_size: int) -> torch.Tensor:
    """Per-scale % of codes whose EMA hit count clears the reference margin
    (quant.py:137-141): tokens / V * 0.08."""
    margin = tokens_per_scale / vocab_size * 0.08
    return (ema_SV >= margin).float().mean(dim=-1) * 100.0


def phi_index(ratio: float, num_phi: int) -> int:
    """Reference PhiPartiallyShared.__getitem__ (quant.py:287): nearest tick.

    ticks = linspace(1/3K, 1-1/3K, K) for K==4 else linspace(1/2K, 1-1/2K, K).
    """
    k = num_phi
    if k == 1:
        return 0
    ticks = (
        np.linspace(1 / 3 / k, 1 - 1 / 3 / k, k)
        if k == 4
        else np.linspace(1 / 2 / k, 1 - 1 / 2 / k, k)
    )
    return int(np.argmin(np.abs(ticks - ratio)))


class Phi(nn.Module):
    """Scale-conditioned residual conv: (1-r)*x + r*conv3x3(x) (quant.py:261).

    The upstream Phi is an nn.Conv2d, so its state is ``weight`` (C, C, 3, 3)
    and ``bias`` (C,). Applied to NHWC input in fp32 as one matmul of the
    zero-padded 3x3 neighbourhoods (never cuDNN, see the module note)."""

    def __init__(self, embed_dim: int, resi_ratio: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(9 * embed_dim)  # torch Conv2d default init
        self.weight = nn.Parameter(
            uniform_(torch.empty(embed_dim, embed_dim, 3, 3), -bound, bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(embed_dim), -bound, bound, generator))
        self.resi_ratio = abs(resi_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        x = x.float()
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, i:i + hh, j:j + ww] for i in range(3) for j in range(3)],
                         dim=-1)  # (B, H, W, 9C), taps in (kh, kw) order
        w = self.weight.float().permute(2, 3, 1, 0).reshape(9 * c, -1)  # (kh kw in, out)
        h = cols @ w + self.bias.float()
        r = self.resi_ratio
        return x * (1.0 - r) + h * r


class _PhiShared(nn.Module):
    """One Phi for every scale (upstream PhiShared: ``qresi``)."""

    def __init__(self, phi: Phi):
        super().__init__()
        self.qresi = phi

    def __len__(self) -> int:
        return 1

    def __getitem__(self, i: int) -> Phi:
        return self.qresi

    def __iter__(self):
        return iter((self.qresi,))


class _PhiPartiallyShared(nn.Module):
    """K Phis picked by the nearest tick (upstream PhiPartiallyShared:
    ``qresi_ls``)."""

    def __init__(self, phis: List[Phi]):
        super().__init__()
        self.qresi_ls = nn.ModuleList(phis)

    def __len__(self) -> int:
        return len(self.qresi_ls)

    def __getitem__(self, i: int) -> Phi:
        return self.qresi_ls[i]

    def __iter__(self):
        return iter(self.qresi_ls)


def _phi_bank(embed_dim: int, num_scales: int, quant_resi: float, share_quant_resi: int,
              default_qresi_counts: int, generator: Optional[torch.Generator]):
    """The Phi convs of ``_PhiBank`` (quant.py:29-38) under the upstream
    names: share 0 -> ``quant_resi.{i}``, 1 -> ``quant_resi.qresi``,
    k > 1 -> ``quant_resi.qresi_ls.{i}``. None when |quant_resi| is 0."""
    if abs(quant_resi) <= 1e-6:
        return None
    if share_quant_resi == 0:  # non-shared
        k = default_qresi_counts or num_scales
    elif share_quant_resi == 1:  # fully shared
        k = 1
    else:
        k = share_quant_resi
    phis = [Phi(embed_dim, quant_resi, generator=generator) for _ in range(k)]
    if share_quant_resi == 0:
        return nn.ModuleList(phis)
    if share_quant_resi == 1:
        return _PhiShared(phis[0])
    return _PhiPartiallyShared(phis)


def _codebook_lookup(rest_NC: torch.Tensor, codebook_VC: torch.Tensor,
                     znorm: bool) -> torch.Tensor:
    """Nearest-code indices (quant.py:155-183): with ``znorm`` the cosine
    argmax over L2-normalised rows, else the squared-L2 argmin. The
    ``codebook_argmin`` kernel on a CUDA tensor, its plain version on the CPU.
    (The JAX package takes the Pallas kernel on a TPU when N*V >= 2**20 and
    XLA otherwise; the results are the same.)"""
    rest = rest_NC.detach().float()
    cb = codebook_VC.detach().float()
    if znorm:
        return codebook_argmin(_l2n(rest), _l2n(cb), maximize=True)
    return codebook_argmin(rest, cb)


class MultiScaleVQ(nn.Module):
    """Multi-scale residual vector quantizer (reference VectorQuantizer2,
    quant.py:13), inference surface. NHWC latents; ``v_patch_nums`` may
    repeat a size, so everything follows scale positions, not sizes.

    State dict: ``embedding.weight`` (V, C), the Phi convs under
    ``quant_resi.*`` and the (S, V) ``ema_vocab_hit_SV`` usage buffer."""

    def __init__(self, vocab_size: int, Cvae: int, v_patch_nums: Sequence[int],
                 using_znorm: bool = True, quant_resi: float = 0.5,
                 share_quant_resi: int = 4, default_qresi_counts: int = 0,
                 beta: float = 0.25, codebook_drop: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.Cvae = vocab_size, Cvae
        self.v_patch_nums = tuple(v_patch_nums)
        self.using_znorm = using_znorm
        self.beta, self.codebook_drop = beta, codebook_drop
        self.embedding = skip_init(nn.Embedding, vocab_size, Cvae)
        with torch.no_grad():
            w = uniform_(self.embedding.weight, -1.0 / vocab_size, 1.0 / vocab_size,
                         generator)
            if using_znorm:
                w.copy_(_l2n(w))
        self.quant_resi = _phi_bank(Cvae, len(self.v_patch_nums), quant_resi,
                                    share_quant_resi, default_qresi_counts, generator)
        self.register_buffer("ema_vocab_hit_SV",
                             torch.zeros(len(self.v_patch_nums), vocab_size))

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding.weight

    def apply_phi(self, si: int, num_scales: int, h: torch.Tensor) -> torch.Tensor:
        if self.quant_resi is None:
            return h
        ratio = 0.0 if num_scales == 1 else si / (num_scales - 1)
        return self.quant_resi[phi_index(ratio, len(self.quant_resi))](h)

    def _lookup(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding.weight.float()[idx]

    def _scale_codes(self, idx: torch.Tensor, si: int) -> torch.Tensor:
        """Scale ``si``'s codes -> their values (the codebook's rows; LFQ's
        depend on the scale)."""
        return self._lookup(idx)

    def phis_used(self) -> set:
        """Indices of the Phis that some scale applies (all of them unless
        the nearest-tick mapping skips one, e.g. phi_2 of K = 4 over three
        scales: that one gets no gradient)."""
        if self.quant_resi is None:
            return set()
        sn = len(self.v_patch_nums)
        return {phi_index(0.0 if sn == 1 else si / (sn - 1), len(self.quant_resi))
                for si in range(sn)}

    def forward(self, f_BHWC: torch.Tensor, *, dropout_n: Optional[torch.Tensor] = None,
                train: bool = False) -> QuantOut:
        """Training forward (quant.py:64-144): per scale, the lookup of the
        pooled residual (``_codebook_lookup``, no gradient), the code map
        upsampled and through its Phi, added to f_hat under each sample's
        dropout mask; vq_loss (gradient to the codebook and Phis) and
        commit_loss (gradient to f) per scale over the active samples. vq_loss
        is divided by S, commit_loss is not (the reference's quirk). f_hat
        comes back straight-through: its value is the quantized map, its
        gradient f's."""
        f = f_BHWC.float()
        b, hh, ww, c = f.shape
        sn = len(self.v_patch_nums)
        f_no_grad = f.detach()
        f_rest = f_no_grad
        f_hat = torch.zeros_like(f_no_grad)
        n_q = _n_quantizers(b, sn, self.codebook_drop, dropout_n, train, f.device)
        vq_loss = torch.zeros((), device=f.device)
        commit_loss = torch.zeros((), device=f.device)
        hits = []
        for si, pn in enumerate(self.v_patch_nums):
            rest = f_rest if (si == sn - 1 and pn == hh) else resize(f_rest, (pn, pn), "area")
            idx = _codebook_lookup(rest.reshape(-1, c), self.embedding.weight,
                                   self.using_znorm)
            hits.append(torch.bincount(idx, minlength=self.vocab_size).float())
            h = self._lookup(idx).reshape(b, pn, pn, c)
            if si != sn - 1:
                h = resize(h, (hh, ww), "bicubic")
            h = self.apply_phi(si, sn, h)
            mask = (si < n_q).float()[:, None, None, None]
            ratio = global_mean(mask.mean())  # the global batch's share
            f_hat = f_hat + h * mask
            f_rest = (f_rest - h).detach()
            vq_loss = vq_loss + ((f_hat - f_no_grad).square() * mask).mean() / ratio
            commit_loss = commit_loss + ((f_hat.detach() - f).square() * mask).mean() * (
                self.beta / ratio)
        f_hat = f_hat.detach() - f_no_grad + f
        return QuantOut(f_hat.to(f_BHWC.dtype), vq_loss / sn, commit_loss,
                        torch.zeros((), device=f.device), torch.stack(hits))

    def f_to_idxBl_or_fhat(self, f_BHWC: torch.Tensor, to_fhat: bool,
                           v_patch_nums: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
        """Greedy multi-scale encode (quant.py:182-223): per scale the
        cumulative f_hat (B, H, W, C) when ``to_fhat``, else the indices
        (B, pn*pn)."""
        f = f_BHWC.detach().float()
        b, hh, ww, c = f.shape
        pns = tuple(v_patch_nums or self.v_patch_nums)
        sn = len(pns)
        f_rest, f_hat = f, torch.zeros_like(f)
        out = []
        for si, pn in enumerate(pns):
            rest = f_rest if (si == sn - 1 and pn == hh) else resize(f_rest, (pn, pn), "area")
            idx = _codebook_lookup(rest.reshape(-1, c), self.embedding.weight,
                                   self.using_znorm)
            h = self._lookup(idx).reshape(b, pn, pn, c)
            if si != sn - 1:
                h = resize(h, (hh, ww), "bicubic")
            h = self.apply_phi(si, sn, h)
            f_hat = f_hat + h
            f_rest = f_rest - h
            out.append(f_hat if to_fhat else idx.reshape(b, pn * pn))
        return out

    def embed_to_fhat(self, ms_h_list: Sequence[torch.Tensor], last_one: bool = False):
        """Sum per-scale embeddings (B, pn, pn, C) into f_hat(s) (quant.py:148-165)."""
        hh = self.v_patch_nums[-1]
        sn = len(self.v_patch_nums)
        f_hat = torch.zeros_like(ms_h_list[-1], dtype=torch.float32)
        outs = []
        for si, h in enumerate(ms_h_list):
            if si < sn - 1:
                h = resize(h, (hh, hh), "bicubic")
            f_hat = f_hat + self.apply_phi(si, sn, h)
            outs.append(f_hat)
        return outs[-1] if last_one else outs

    def idxBl_to_var_input(self, gt_ms_idx_Bl: Sequence[torch.Tensor],
                           prog_si: int = -1) -> Optional[torch.Tensor]:
        """Teacher-forcing input for VAR (quant.py:226-244): for each scale
        si < SN-1, accumulate f_hat, then area-pool it to the NEXT scale;
        concatenated to (B, L - first_l, C). ``prog_si >= 0`` stops before
        scale ``prog_si`` (progressive training)."""
        b = gt_ms_idx_Bl[0].shape[0]
        hh = self.v_patch_nums[-1]
        sn = len(self.v_patch_nums)
        f_hat = torch.zeros((b, hh, hh, self.Cvae), device=gt_ms_idx_Bl[0].device)
        pieces = []
        pn_next = self.v_patch_nums[0]
        stop = sn - 1 if prog_si < 0 else min(prog_si, sn - 1)
        for si in range(stop):
            h = self._scale_codes(gt_ms_idx_Bl[si], si).reshape(b, pn_next, pn_next, self.Cvae)
            f_hat = f_hat + self.apply_phi(si, sn, resize(h, (hh, hh), "bicubic"))
            pn_next = self.v_patch_nums[si + 1]
            nxt = resize(f_hat, (pn_next, pn_next), "area")
            pieces.append(nxt.reshape(b, pn_next * pn_next, self.Cvae))
        return torch.cat(pieces, dim=1) if pieces else None

    def get_next_autoregressive_input(self, si: int, sn: int, f_hat: torch.Tensor,
                                      h_BHWC: torch.Tensor):
        """One VAR decode stage (quant.py:247-258): phi(upsample(h)) added to
        f_hat; the next token map is f_hat area-pooled to the next scale.
        Returns (f_hat, next map)."""
        hw = self.v_patch_nums[-1]
        if si != sn - 1:
            h = self.apply_phi(si, sn, resize(h_BHWC, (hw, hw), "bicubic"))
            f_hat = f_hat + h
            pn = self.v_patch_nums[si + 1]
            return f_hat, resize(f_hat, (pn, pn), "area")
        f_hat = f_hat + self.apply_phi(si, sn, h_BHWC)
        return f_hat, f_hat

    def embed(self, idx: torch.Tensor, si: Optional[int] = None) -> torch.Tensor:
        """Codes -> their codebook rows; ``si`` (LFQ's scale) is ignored."""
        return self._lookup(idx)


def _sign_bits(rest: torch.Tensor) -> torch.Tensor:
    """LFQ's code of a pooled residual: its sign bits (> 0), one per channel.
    An entry within rounding of 0 may take either bit on another device."""
    return rest > 0


def _entropy(probs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return -(probs * torch.log(probs + eps)).sum(dim=-1)


class MultiScaleLFQ(nn.Module):
    """Multi-scale lookup-free quantizer / BSQ (reference LFQ,
    lookup_free_quantize.py:83). Per scale the residual is area-pooled, its
    sign bits are the code (bit c is 2**c of the index), the code map is
    +-``scaler(si)`` per bit, bicubic-upsampled and put through the scale's
    Phi, as ``MultiScaleVQ`` puts its codewords. With ``using_znorm`` (BSQ)
    the latents are L2-normalised first and the scaler divided by
    sqrt(Cvae). The codebook is implicit (``2**Cvae`` codes), so the state
    dict holds only the Phi convs under ``quant_resi.*``, and there is no
    usage buffer (the JAX exporter writes none for LFQ)."""

    def __init__(self, codebook_size: int, Cvae: int, v_patch_nums: Sequence[int],
                 using_znorm: bool = False, beta: float = 0.25, quant_resi: float = 0.5,
                 share_quant_resi: int = 4, default_qresi_counts: int = 0,
                 codebook_drop: float = 0.0, scale: float = 1.0, entropy_weight: float = 0.1,
                 soft_entropy: bool = True, sample_minimization_weight: float = 1.0,
                 batch_maximization_weight: float = 1.0, entropy_temperature: float = 0.01, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if 2 ** Cvae != codebook_size:
            raise ValueError(f"LFQ's vocabulary is 2**Cvae = {2 ** Cvae}; got {codebook_size}")
        self.vocab_size = self.codebook_size = codebook_size
        self.Cvae = Cvae
        self.v_patch_nums = tuple(v_patch_nums)
        self.using_znorm = using_znorm
        self.beta, self.codebook_drop, self.scale = beta, codebook_drop, scale
        self.entropy_weight, self.soft_entropy = entropy_weight, soft_entropy
        self.sample_minimization_weight = sample_minimization_weight
        self.batch_maximization_weight = batch_maximization_weight
        self.entropy_temperature = entropy_temperature
        self.quant_resi = _phi_bank(Cvae, len(self.v_patch_nums), quant_resi,
                                    share_quant_resi, default_qresi_counts, generator)

    apply_phi = MultiScaleVQ.apply_phi
    phis_used = MultiScaleVQ.phis_used

    def scaler(self, si: int) -> float:
        """A bit's magnitude at scale ``si``: scale**si, / sqrt(Cvae) under BSQ."""
        s = self.scale ** si
        return s / math.sqrt(self.Cvae) if self.using_znorm else s

    def _index_dtype(self) -> torch.dtype:
        return torch.int64 if self.Cvae > 31 else torch.int32

    def bits_to_indices(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., Cvae) bools -> indices, bit c weighing 2**c (int32 for
        Cvae <= 31, else int64, as the JAX package)."""
        dt = self._index_dtype()
        weights = 2 ** torch.arange(self.Cvae, dtype=dt, device=bits.device)
        return (bits.to(dt) * weights).sum(dim=-1, dtype=dt)

    def indices_to_bits(self, idx: torch.Tensor, si: Optional[int] = None) -> torch.Tensor:
        """Indices -> (..., Cvae) bools, or with ``si`` the fp32 code values
        +-``scaler(si)``."""
        mask = 2 ** torch.arange(self.Cvae, dtype=torch.int64, device=idx.device)
        bits = (idx.long()[..., None] & mask) != 0
        if si is None:
            return bits
        s = self.scaler(si)
        return torch.where(bits, s, -s).float()

    def _full_codebook(self, device) -> torch.Tensor:
        """Every code's +-1 bits, (2**Cvae, Cvae) fp32."""
        idx = torch.arange(self.vocab_size, device=device)
        return self.indices_to_bits(idx).float() * 2.0 - 1.0

    def _soft_entropy_loss(self, z: torch.Tensor, si: int, sample_mask: torch.Tensor):
        """The analytic per-bit entropy and the per-bit codebook entropy
        (lookup_free_quantize.py:283-300), with the samples weighted by
        ``sample_mask`` (B,): the JAX package's intended semantics, not
        upstream's int-mask indexing. z: (B, hw, 1, C)."""
        w = sample_mask.float()
        denom = global_sum(w.sum()).clamp_min(1.0)  # sums over the global batch
        p = torch.sigmoid(-4.0 * z * self.scaler(si))
        prob = torch.stack([p, 1.0 - p], dim=-1)  # (B, hw, 1, C, 2)
        ent = _entropy(prob).sum(dim=-1)  # (B, hw, 1)
        per_sample = global_sum((ent * w[:, None, None]).sum()) / (
            denom * ent.shape[1] * ent.shape[2])
        avg_prob = global_sum((prob * w[:, None, None, None, None]).sum(dim=(0, 1))) / (
            denom * prob.shape[1])
        return per_sample, _entropy(avg_prob).sum()

    def _hard_entropy_loss(self, z: torch.Tensor, codebook: torch.Tensor,
                           sample_mask: torch.Tensor) -> torch.Tensor:
        """MagViT's logits entropy (lookup_free_quantize.py:41-79), the
        samples weighted by ``sample_mask``: logits 2 z . code over the full
        codebook (a plain product), at temperature ``entropy_temperature``."""
        logits = 2.0 * torch.matmul(z, codebook.T)  # (B, hw, 1, V)
        t = self.entropy_temperature
        probs = torch.softmax(logits / t, dim=-1)
        log_probs = torch.log_softmax(logits / t + 1e-5, dim=-1)
        w = sample_mask.float()
        denom = global_sum(w.sum()).clamp_min(1.0)  # sums over the global batch
        avg_probs = global_sum((probs * w[:, None, None, None]).sum(dim=0)) / denom
        avg_probs = avg_probs.mean(dim=(0, 1))
        avg_entropy = -(avg_probs * torch.log(avg_probs + 1e-5)).sum()
        sample_ent = -(probs * log_probs).sum(dim=-1)
        sample_entropy = global_sum((sample_ent * w[:, None, None]).sum()) / (
            denom * sample_ent.shape[1] * sample_ent.shape[2])
        return (self.sample_minimization_weight * sample_entropy
                - self.batch_maximization_weight * avg_entropy)

    def _normed(self, f_BHWC: torch.Tensor) -> torch.Tensor:
        f = f_BHWC.float()
        return _l2n(f) if self.using_znorm else f

    def _code_map(self, rest: torch.Tensor, si: int, sn: int, hw: tuple):
        """The pooled residual's bits -> (indices (N,) as int64, PyTorch's
        index type, and the code map through the scale's Phi at full size)."""
        c = self.Cvae
        bits = _sign_bits(rest)
        idx = self.bits_to_indices(bits.reshape(-1, c)).long()
        s = self.scaler(si)
        h = torch.where(bits, s, -s).float()
        if si != sn - 1:
            h = resize(h, hw, "bicubic")
        return idx, self.apply_phi(si, sn, h)

    def forward(self, f_BHWC: torch.Tensor, *, dropout_n: Optional[torch.Tensor] = None,
                train: bool = False) -> QuantOut:
        """Training forward: per scale the sign-bit code of the pooled
        residual (no gradient) through its Phi, added to f_hat under each
        sample's dropout mask; the entropy loss of the residual f - sg(f_hat)
        (with the encoder's gradient) weighted by ``entropy_weight``; vq_loss,
        commit_loss and entropy_loss each divided by S (unlike
        ``MultiScaleVQ``'s commit_loss). f_hat comes back straight-through."""
        f = self._normed(f_BHWC)
        b, hh, ww, c = f.shape
        sn = len(self.v_patch_nums)
        f_no_grad = f.detach()
        f_rest = f_no_grad
        f_hat = torch.zeros_like(f_no_grad)
        n_q = _n_quantizers(b, sn, self.codebook_drop, dropout_n, train, f.device)
        zero = torch.zeros((), device=f.device)
        vq_loss, commit_loss, entropy_loss = zero, zero, zero
        base_codebook = None if self.soft_entropy else self._full_codebook(f.device)
        hits = []
        for si, pn in enumerate(self.v_patch_nums):
            rest = f_rest if (si == sn - 1 and pn == hh) else resize(f_rest, (pn, pn), "area")
            idx, h = self._code_map(rest, si, sn, (hh, ww))
            hits.append(torch.bincount(idx, minlength=self.vocab_size).float())
            x = (f - f_hat.detach()).reshape(b, hh * ww, 1, c)
            mask_b = (si < n_q).float()
            mask = mask_b[:, None, None, None]
            ratio = global_mean(mask.mean())  # the global batch's share
            f_hat = f_hat + h * mask
            f_rest = (f_rest - h).detach()
            if self.soft_entropy:
                per_sample, codebook_ent = self._soft_entropy_loss(x, si, mask_b)
                ent_aux = (self.sample_minimization_weight * per_sample
                           - self.batch_maximization_weight * codebook_ent)
            else:
                ent_aux = self._hard_entropy_loss(x, base_codebook * self.scaler(si), mask_b)
            vq_loss = vq_loss + ((f_hat - f_no_grad).square() * mask).mean() / ratio
            commit_loss = commit_loss + ((f_hat.detach() - f).square() * mask).mean() * (
                self.beta / ratio)
            entropy_loss = entropy_loss + ent_aux * (self.entropy_weight / ratio)
        f_hat = f_hat.detach() - f_no_grad + f
        return QuantOut(f_hat.to(f_BHWC.dtype), vq_loss / sn, commit_loss / sn,
                        entropy_loss / sn, torch.stack(hits))

    @torch.no_grad()
    def f_to_idxBl_or_fhat(self, f_BHWC: torch.Tensor, to_fhat: bool,
                           v_patch_nums: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
        """Greedy multi-scale encode: per scale the cumulative f_hat
        (B, H, W, C) when ``to_fhat``, else the indices (B, pn*pn)."""
        f = self._normed(f_BHWC.detach())
        b, hh, ww, c = f.shape
        pns = tuple(v_patch_nums or self.v_patch_nums)
        sn = len(pns)
        f_rest, f_hat = f, torch.zeros_like(f)
        out = []
        for si, pn in enumerate(pns):
            rest = f_rest if (si == sn - 1 and pn == hh) else resize(f_rest, (pn, pn), "area")
            idx, h = self._code_map(rest, si, sn, (hh, ww))
            f_hat = f_hat + h
            f_rest = f_rest - h
            out.append(f_hat if to_fhat else idx.reshape(b, pn * pn))
        return out

    def _scale_codes(self, idx: torch.Tensor, si: int) -> torch.Tensor:
        return self.indices_to_bits(idx, si)

    # VAR's teacher-forcing input and decode stage: the multi-scale VQ's, on
    # the codes' +-scaler(si) values
    idxBl_to_var_input = MultiScaleVQ.idxBl_to_var_input
    get_next_autoregressive_input = MultiScaleVQ.get_next_autoregressive_input

    def embed(self, idx: torch.Tensor, si: Optional[int] = None) -> torch.Tensor:
        """Codes -> their +-``scaler(si)`` values (the last scale's by default)."""
        return self.indices_to_bits(idx, len(self.v_patch_nums) - 1 if si is None else si)


def _nearest_code(flat_NC: torch.Tensor, emb_VC: torch.Tensor) -> torch.Tensor:
    """``SingleVQ``'s search: the argmin of the fp32 |z|^2 + |e|^2 - 2 z.e
    over the (normalised) rows, first occurrence on ties."""
    d = (flat_NC.square().sum(dim=-1, keepdim=True) + emb_VC.square().sum(dim=-1)
         - 2.0 * flat_NC @ emb_VC.T)
    return torch.argmin(d, dim=-1)


class SingleVQ(nn.Module):
    """The single-scale VQ (reference VectorQuantizer, xqgan_model.py:722):
    a cosine codebook when ``codebook_norm``, straight-through on the
    (normalised) latent. State dict: ``embedding.weight`` (V, C) and the
    upstream flat (V,) ``ema_vocab_hit_SV`` usage buffer."""

    def __init__(self, vocab_size: int, z_channels: int, codebook_norm: bool = True, *,
                 beta: float = 0.25, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.z_channels = vocab_size, z_channels
        self.codebook_norm, self.beta = codebook_norm, beta
        self.embedding = skip_init(nn.Embedding, vocab_size, z_channels)
        with torch.no_grad():
            w = uniform_(self.embedding.weight, -1.0 / vocab_size, 1.0 / vocab_size,
                         generator)
            if codebook_norm:
                w.copy_(_l2n(w))
        self.register_buffer("ema_vocab_hit_SV", torch.zeros(vocab_size))

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding.weight

    def _normed_codebook(self) -> torch.Tensor:
        w = self.embedding.weight.float()
        return _l2n(w) if self.codebook_norm else w

    def _nearest(self, flat: torch.Tensor) -> torch.Tensor:
        return _nearest_code(flat.detach(), self._normed_codebook().detach())

    def forward(self, z_BHWC: torch.Tensor, *, dropout_n: Optional[torch.Tensor] = None,
                train: bool = False) -> QuantOut:
        """Training call: the nearest codes of the (normalised) fp32
        latents, commit_loss = beta * mean((sg(z_q) - z)^2) (gradient to the
        encoder), vq_loss = mean((z_q - sg(z))^2) (gradient to the codebook),
        ``f_hat`` = z + sg(z_q - z) in the input's dtype, and this batch's
        hits as a (1, V) row. ``dropout_n`` and ``train`` change nothing (one
        scale has nothing to drop)."""
        z = z_BHWC.float()
        if self.codebook_norm:
            z = _l2n(z)
        idx = self._nearest(z.reshape(-1, self.z_channels))
        hits = torch.bincount(idx, minlength=self.vocab_size).float()[None]
        z_q = self.embed(idx).reshape(z.shape)
        commit = self.beta * (z_q.detach() - z).square().mean()
        vq = (z_q - z.detach()).square().mean()
        z_q = z + (z_q - z).detach()
        return QuantOut(z_q.to(z_BHWC.dtype), vq, commit, torch.zeros((), device=z.device), hits)

    def f_to_idxBl_or_fhat(self, z_BHWC: torch.Tensor, to_fhat: bool,
                           v_patch_nums: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
        """(B, h, w, C) latents -> [quantized (B, h, w, C)] when ``to_fhat``,
        else [indices (B, h*w)]. ``v_patch_nums`` is ignored (single scale)."""
        z = z_BHWC.detach().float()
        if self.codebook_norm:
            z = _l2n(z)
        idx = self._nearest(z.reshape(-1, self.z_channels))
        if not to_fhat:
            return [idx.reshape(z.shape[0], -1)]
        return [self.embed(idx).reshape(z.shape)]

    def embed(self, idx: torch.Tensor, si: Optional[int] = None) -> torch.Tensor:
        """Codes -> their (normalised) codebook rows; ``si`` is ignored."""
        z_q = self.embedding.weight.float()[idx]
        return _l2n(z_q) if self.codebook_norm else z_q
