"""XQ-GAN tokenizer, inference round trip (counterpart of
``imagefolder_tpu/models/tokenizer.py``).

encoder -> quant_conv (1x1) -> single-scale VQ -> post_quant_conv (1x1) ->
decoder, with DINOv2 ViT encoder and decoder. NHWC images in [-1, 1] and
token-major latents at the public functions, as in the JAX package.
``quant_conv`` and ``post_quant_conv`` are 1x1 convs in the upstream state
dict and are applied as channel-last linear maps in fp32.

Outside the ported slice (raise ``NotImplementedError``): cnn encoders and
decoders, multi-scale and LFQ quantizers, product quantization, the semantic
and detail teachers, LoRA, RoPE, non-linear ToPixel heads, and latent grids
other than the patch grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.models.vit import LatentDecoder, LatentEncoder
from imagefolder_tpu_torch.ops.quantize import SingleVQ
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
        "multi-scale quantizer": len(cfg.v_patch_nums) != 1,
        "LFQ quantizer": cfg.lfq,
        "product quantization": cfg.product_quant != 1,
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
    def __init__(self, config: ModelArgs, *, generator: Optional[torch.Generator] = None):
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
        self.post_quant_conv = Conv1x1(cfg.codebook_embed_dim, self.decoder.embed_dim,
                                       generator)
        self.quantize = SingleVQ(cfg.codebook_size, cfg.codebook_embed_dim,
                                 cfg.codebook_l2_norm, generator=generator)

    @property
    def quantizers(self):
        return (self.quantize,)

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
        """Greedy encode + decode, clamped to [-1, 1]."""
        per_scale = [torch.cat(fs, dim=-1) for fs in zip(*self._branch_fhats(x))]
        if last_one:
            return self.fhat_to_img(per_scale[-1])
        return [self.fhat_to_img(f) for f in per_scale]

    def img_to_idxBl(self, x: torch.Tensor, v_patch_nums=None) -> List[List[torch.Tensor]]:
        """Per-branch, per-scale token indices."""
        h_P = self.encode(x)
        return [qz.f_to_idxBl_or_fhat(h_P[:, i], False, v_patch_nums)
                for i, qz in enumerate(self.quantizers)]

    def fhat_to_img(self, f_hat: torch.Tensor) -> torch.Tensor:
        return self.decode(f_hat).clamp(-1.0, 1.0)

    def embed_branch(self, i: int, idx: torch.Tensor, si: Optional[int] = None):
        return self.quantizers[i].embed(idx)

    def encode_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> flat (B, P*g*g) final-scale indices."""
        return torch.cat([branch[-1] for branch in self.img_to_idxBl(x)], dim=1)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Flat final-scale indices -> image NHWC in [-1, 1]."""
        b, g = tokens.shape[0], self.grid
        quants = [self.embed_branch(i, t.reshape(b, g, g))
                  for i, t in enumerate(tokens.chunk(self.config.product_quant, dim=1))]
        return self.fhat_to_img(torch.cat(quants, dim=-1))
