"""XQ-GAN tokenizer, inference (counterpart of
``imagefolder_tpu/models/tokenizer.py``).

encoder -> quant_conv (1x1) -> P quantizer branches -> post_quant_conv (1x1)
-> decoder, with DINOv2 ViT encoder and decoder. A single ``v_patch_nums``
entry builds the single-scale VQ (the round trip); more build the
multi-scale residual VQ that VAR's tokenizers use, with the VAR interface
(``img_to_idxBl``, ``idxBl_to_var_input``, ``get_next_autoregressive_input``,
``embed_branch``, ``soft_embed_branch``, ``fhat_to_img``). ``product_quant``
> 1 splits the latents into P branches, each with its own quantizer
(``quantizes.{i}`` in the upstream state dict; ``quantize`` when P = 1).
NHWC images in [-1, 1] and token-major latents at the public functions, as
in the JAX package. ``quant_conv`` and ``post_quant_conv`` are 1x1 convs in
the upstream state dict and are applied as channel-last linear maps in fp32.

Outside the ported slice (raise ``NotImplementedError``): cnn encoders and
decoders, LFQ/BSQ quantizers, the semantic and detail teachers (they feed
only training losses; run a published config with ``semantic_guide="none"``
at inference, as ``bench.py`` does), LoRA, RoPE, learned latent pos embeds
and non-linear ToPixel heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.models.vit import LatentDecoder, LatentEncoder
from imagefolder_tpu_torch.ops.quantize import MultiScaleVQ, SingleVQ
from imagefolder_tpu_torch.utils.init import linear_kaiming_uniform_

__all__ = ["ModelArgs", "VQModel", "check_slice"]


@dataclasses.dataclass
class ModelArgs:
    """Mirror of the JAX package's ModelArgs: same fields, same defaults."""

    codebook_size: int = 16384
    codebook_embed_dim: int = 8
    codebook_l2_norm: bool = True
    codebook_show_usage: bool = True
    commit_loss_beta: float = 0.25
    entropy_loss_ratio: float = 0.0

    encoder_ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    decoder_ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    z_channels: int = 256
    dropout_p: float = 0.0

    v_patch_nums: Sequence[int] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    enc_type: str = "cnn"
    dec_type: str = "cnn"
    semantic_guide: str = "dinov2"
    detail_guide: str = "clip"
    num_latent_tokens: int = 256
    encoder_model: str = "vit_small_patch14_dinov2.lvd142m"
    decoder_model: str = "vit_small_patch14_dinov2.lvd142m"
    abs_pos_embed: bool = False
    share_quant_resi: int = 4
    product_quant: int = 1
    codebook_drop: float = 0.0
    half_sem: bool = False
    start_drop: int = 1
    sem_loss_weight: float = 0.1
    detail_loss_weight: float = 0.1
    clip_norm: bool = False
    sem_loss_scale: float = 1.0
    detail_loss_scale: float = 1.0
    guide_type_1: str = "class"
    guide_type_2: str = "class"

    lfq: bool = False
    scale: float = 1.0
    soft_entropy: bool = True

    dependency_loss_weight: float = 0.0

    test_model: bool = False

    image_size: int = 256
    enc_tuning_method: str = "full"
    dec_tuning_method: str = "full"
    lora_rank: int = 8
    enc_use_attn_mask: bool = False
    to_pixel: str = "linear"
    perturb_delta_max: int = 0
    remat: bool = False
    dtype_str: str = "float32"  # activation dtype: float32 | bfloat16

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32

    @property
    def total_latent_tokens(self) -> int:
        return self.num_latent_tokens * self.product_quant


def check_slice(cfg: ModelArgs):
    """Raise NotImplementedError for a configuration outside the port."""
    unported = {
        "cnn encoder/decoder": cfg.enc_type != "dinov2" or cfg.dec_type != "dinov2",
        "LFQ quantizer": cfg.lfq,
        "semantic/detail teachers": (cfg.semantic_guide != "none"
                                     or cfg.detail_guide != "none"),
        "abs_pos_embed=False": not cfg.abs_pos_embed,
        "LoRA tuning": {cfg.enc_tuning_method, cfg.dec_tuning_method} - {"full", "frozen"},
        f"to_pixel={cfg.to_pixel!r}": cfg.to_pixel != "linear",
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported")


class Conv1x1(nn.Module):
    """A 1x1 conv of the upstream state dict (weight (out, in, 1, 1)),
    applied to channel-last input as an fp32 linear map (the flax Dense's
    promotion of activations to its fp32 params)."""

    def __init__(self, din: int, dout: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            linear_kaiming_uniform_(torch.empty(dout, din, 1, 1), din, generator))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.flatten(1), self.bias)


class VQModel(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so that every
    device gets the same weights) and then moved to ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, config: ModelArgs, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        check_slice(config)
        cfg = self.config = config
        self.grid = math.isqrt(cfg.num_latent_tokens)
        dt = cfg.dtype
        self.encoder = LatentEncoder(
            cfg.encoder_model, cfg.image_size, 16, cfg.total_latent_tokens,
            cfg.product_quant, cfg.abs_pos_embed, cfg.enc_tuning_method,
            cfg.enc_use_attn_mask, dt, generator=generator)
        self.quant_conv = Conv1x1(self.encoder.embed_dim, cfg.codebook_embed_dim, generator)
        self.decoder = LatentDecoder(
            cfg.decoder_model, cfg.image_size, 16, cfg.num_latent_tokens,
            cfg.abs_pos_embed, cfg.to_pixel, cfg.dec_tuning_method,
            dtype=dt, generator=generator)
        self.post_quant_conv = Conv1x1(cfg.codebook_embed_dim * cfg.product_quant,
                                       self.decoder.embed_dim, generator)
        quantizers = [self._make_quantizer(generator) for _ in range(cfg.product_quant)]
        if cfg.product_quant > 1:
            self.quantizes = nn.ModuleList(quantizers)
        else:
            self.quantize = quantizers[0]
        self.to(device)

    def _make_quantizer(self, generator):
        cfg = self.config
        if len(cfg.v_patch_nums) == 1:
            return SingleVQ(cfg.codebook_size, cfg.codebook_embed_dim,
                            cfg.codebook_l2_norm, generator=generator)
        # the JAX package builds the multi-scale VQ with a cosine search always
        return MultiScaleVQ(cfg.codebook_size, cfg.codebook_embed_dim,
                            tuple(cfg.v_patch_nums), using_znorm=True,
                            share_quant_resi=cfg.share_quant_resi, generator=generator)

    @property
    def quantizers(self):
        return tuple(self.quantizes) if self.config.product_quant > 1 else (self.quantize,)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> pre-quant latent grids (B, P, g, g, C_codebook), fp32."""
        cfg = self.config
        h = self.quant_conv(self.encoder(x))  # (B, P*g*g, C)
        g = self.grid
        return h.reshape(h.shape[0], cfg.product_quant, g, g, cfg.codebook_embed_dim)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Quantized latents (B, g, g, P*C) -> image NHWC (unclamped)."""
        q = self.post_quant_conv(quant)
        b, g1, g2, d = q.shape
        return self.decoder(q.reshape(b, g1 * g2, d))

    def _branch_fhats(self, x, v_patch_nums=None) -> List[List[torch.Tensor]]:
        h_P = self.encode(x)
        return [qz.f_to_idxBl_or_fhat(h_P[:, i], True, v_patch_nums)
                for i, qz in enumerate(self.quantizers)]

    def img_to_reconstructed_img(self, x: torch.Tensor, last_one: bool = True):
        """Greedy encode + decode, clamped to [-1, 1]; with ``last_one=False``
        one image per scale."""
        per_scale = [torch.cat(fs, dim=-1) for fs in zip(*self._branch_fhats(x))]
        if last_one:
            return self.fhat_to_img(per_scale[-1])
        return [self.fhat_to_img(f) for f in per_scale]

    def img_to_idxBl(self, x: torch.Tensor, v_patch_nums=None) -> List[List[torch.Tensor]]:
        """Per-branch, per-scale token indices [P][S] of (B, pn*pn)."""
        h_P = self.encode(x)
        return [qz.f_to_idxBl_or_fhat(h_P[:, i], False, v_patch_nums)
                for i, qz in enumerate(self.quantizers)]

    def idxBl_to_var_input(self, gt_idx_Bl_P: Sequence[Sequence[torch.Tensor]],
                           prog_si: int = -1) -> Optional[torch.Tensor]:
        """Per-branch teacher-forcing inputs concatenated on channels,
        (B, L - first_l, P*C); None for ``prog_si == 0`` (sos only)."""
        if prog_si == 0:
            return None
        return torch.cat([qz.idxBl_to_var_input(gt_idx_Bl_P[i], prog_si)
                          for i, qz in enumerate(self.quantizers)], dim=-1)

    def get_next_autoregressive_input(self, si: int, sn: int, f_hat: torch.Tensor,
                                      h_BHWC: torch.Tensor):
        """One VAR decode stage, branch by branch on channel chunks of
        C_codebook. Returns (f_hat, next token map), both (B, ., ., P*C)."""
        c = self.config.codebook_embed_dim
        f_outs, n_outs = [], []
        for i, qz in enumerate(self.quantizers):
            fo, no = qz.get_next_autoregressive_input(
                si, sn, f_hat[..., i * c:(i + 1) * c], h_BHWC[..., i * c:(i + 1) * c])
            f_outs.append(fo)
            n_outs.append(no)
        return torch.cat(f_outs, dim=-1), torch.cat(n_outs, dim=-1)

    def fhat_to_img(self, f_hat: torch.Tensor) -> torch.Tensor:
        return self.decode(f_hat).clamp(-1.0, 1.0)

    def embed_branch(self, i: int, idx: torch.Tensor, si: Optional[int] = None):
        """Codes of branch i -> their embeddings (``si`` matters to LFQ only)."""
        return self.quantizers[i].embed(idx)

    def soft_embed_branch(self, i: int, probs: torch.Tensor) -> torch.Tensor:
        """``more_smooth`` mixture embedding: a (B, l, V) code distribution
        times branch i's codebook (L2-normalised for a normed single-scale
        VQ) instead of a hard lookup."""
        qz = self.quantizers[i]
        cb = qz.embedding.weight.float()
        if getattr(qz, "codebook_norm", False):
            cb = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)
        return probs.float() @ cb

    def encode_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> flat (B, P*g*g) final-scale indices."""
        return torch.cat([branch[-1] for branch in self.img_to_idxBl(x)], dim=1)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Flat final-scale indices -> image NHWC in [-1, 1]."""
        b, g = tokens.shape[0], self.grid
        quants = [self.embed_branch(i, t.reshape(b, g, g))
                  for i, t in enumerate(tokens.chunk(self.config.product_quant, dim=1))]
        return self.fhat_to_img(torch.cat(quants, dim=-1))
