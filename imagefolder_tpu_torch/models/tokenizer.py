"""XQ-GAN tokenizer (counterpart of ``imagefolder_tpu/models/tokenizer.py``).

encoder -> quant_conv (1x1) -> P quantizer branches -> post_quant_conv (1x1)
-> decoder, with DINOv2 ViT or VQGAN CNN encoders and decoders, in any pair
(``enc_type``, ``dec_type``; ``models/cnn.py``). A single ``v_patch_nums``
entry builds the single-scale VQ (the round trip); more build the
multi-scale residual VQ that VAR's tokenizers use or, with ``lfq``, the
multi-scale LFQ/BSQ quantizer of the MSBR recipes, with the VAR interface
(``img_to_idxBl``, ``idxBl_to_var_input``, ``get_next_autoregressive_input``,
``embed_branch``, ``soft_embed_branch``, ``fhat_to_img``). ``product_quant``
> 1 splits the latents into P branches, each with its own quantizer
(``quantizes.{i}`` in the upstream state dict; ``quantize`` when P = 1).
NHWC images in [-1, 1] and token-major latents at the public functions, as
in the JAX package. ``quant_conv`` and ``post_quant_conv`` are 1x1 convs in
the upstream state dict and are applied as channel-last linear maps in fp32.

The training forward (``forward``, xqgan_model.py:268-365) runs the
quantizers' training calls (the multi-scale ones with quantizer dropout;
losses, hits), applies RobustTok's latent perturbation to a single branch
(``perturb_delta_max`` > 0, after the vq and commit losses), decodes with
the pre-last activation for the adaptive GAN weight, and adds the InfoNCE
``sem_loss`` against the frozen DINOv2 teacher (``semantic_model``, the
encoder's preset; ``semantic_guide="dinov2"``) and ``detail_loss`` against
the frozen CLIP ViT-B/16 teacher (``detail_model``; any ``detail_guide``
but ``"none"``), each run under ``torch.no_grad``, as ``TokenizerOut``. A
CNN encoder's semantic guide projects the teacher's feature through
``sem_linear`` and holds it against the pre-quant latents, as the JAX
package does. LoRA and lat_lora finetuning (``enc_tuning_method``,
``dec_tuning_method``, ``lora_rank``), learned latent pos embeds
(``abs_pos_embed=False``) and the ``conv``, ``siren`` and ``identity``
ToPixel heads are the ViT's (``models/vit.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.losses.clip_loss import clip_loss
from imagefolder_tpu_torch.models.cnn import Decoder as CNNDecoder
from imagefolder_tpu_torch.models.cnn import Encoder as CNNEncoder
from imagefolder_tpu_torch.models.vit import (
    LatentDecoder,
    LatentEncoder,
    ViTBackbone,
    _backbone_kwargs,
)
from imagefolder_tpu_torch.ops.perturb import add_perturbation
from imagefolder_tpu_torch.ops.quantize import MultiScaleLFQ, MultiScaleVQ, QuantOut, SingleVQ
from imagefolder_tpu_torch.parallel.dist import all_gather_batch, global_batch_rows
from imagefolder_tpu_torch.utils.init import linear, linear_kaiming_uniform_

__all__ = ["ModelArgs", "VQModel", "TokenizerOut", "check_slice"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


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
    """Raise NotImplementedError for a configuration the port does not
    build: an encoder, decoder, tuning method or ToPixel head that the JAX
    package does not have either, or a semantic guide it does not run."""
    unported = {
        f"enc_type={cfg.enc_type!r}": cfg.enc_type not in ("cnn", "dinov2"),
        f"dec_type={cfg.dec_type!r}": cfg.dec_type not in ("cnn", "dinov2"),
        f"semantic_guide={cfg.semantic_guide!r}": cfg.semantic_guide not in ("none", "dinov2"),
        "tuning method": {cfg.enc_tuning_method, cfg.dec_tuning_method}
        - {"full", "frozen", "lora", "lat_lora"},
        f"to_pixel={cfg.to_pixel!r}": cfg.to_pixel not in ("linear", "conv", "siren",
                                                           "identity"),
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported")


@dataclasses.dataclass
class TokenizerOut:
    """Training-forward outputs (the reference forward's tuple,
    xqgan_model.py:365)."""

    dec: torch.Tensor                       # reconstruction, NHWC fp32
    vq_loss: torch.Tensor
    commit_loss: torch.Tensor
    entropy_loss: torch.Tensor
    sem_loss: torch.Tensor
    detail_loss: torch.Tensor
    dependency_loss: torch.Tensor
    hits_PSV: torch.Tensor                  # (P, S, V) codebook hits, fp32
    pre_last: Optional[torch.Tensor] = None  # decoder pre-last activation (train)


def _orthogonal_cosine_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Decorrelate PQ branches (xqgan_model.py:836-840)."""
    a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-12)
    return (a * b).sum(dim=1).mean()


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
        if cfg.enc_type == "cnn":
            self.encoder = CNNEncoder(ch_mult=tuple(cfg.encoder_ch_mult),
                                      z_channels=cfg.z_channels, dropout=cfg.dropout_p,
                                      dtype=dt, generator=generator)
            enc_dim = cfg.z_channels
        else:
            self.encoder = LatentEncoder(
                cfg.encoder_model, cfg.image_size, 16, cfg.total_latent_tokens,
                cfg.product_quant, cfg.abs_pos_embed, cfg.enc_tuning_method,
                cfg.enc_use_attn_mask, dt, remat=cfg.remat, lora_rank=cfg.lora_rank,
                generator=generator)
            enc_dim = self.encoder.embed_dim
        self.quant_conv = Conv1x1(enc_dim, cfg.codebook_embed_dim, generator)
        if cfg.dec_type == "cnn":
            self.decoder = CNNDecoder(ch_mult=tuple(cfg.decoder_ch_mult),
                                      z_channels=cfg.z_channels, dropout=cfg.dropout_p,
                                      dtype=dt, generator=generator)
            dec_dim = cfg.z_channels
        else:
            self.decoder = LatentDecoder(
                cfg.decoder_model, cfg.image_size, 16, cfg.num_latent_tokens,
                cfg.abs_pos_embed, cfg.to_pixel, cfg.dec_tuning_method,
                dtype=dt, remat=cfg.remat, lora_rank=cfg.lora_rank, generator=generator)
            dec_dim = self.decoder.embed_dim
        self.post_quant_conv = Conv1x1(cfg.codebook_embed_dim * cfg.product_quant, dec_dim,
                                       generator)
        quantizers = [self._make_quantizer(generator) for _ in range(cfg.product_quant)]
        if cfg.product_quant > 1:
            self.quantizes = nn.ModuleList(quantizers)
        else:
            self.quantize = quantizers[0]
        if cfg.semantic_guide == "dinov2":  # the frozen teacher: the encoder's preset
            self.semantic_model = ViTBackbone(
                **_backbone_kwargs(cfg.encoder_model, cfg.image_size, 16, dt),
                generator=generator).requires_grad_(False)
            if cfg.enc_type == "cnn":  # its feature to the latent width
                self.sem_linear = linear(self.semantic_model.embed_dim,
                                         cfg.codebook_embed_dim, generator)
        if cfg.detail_guide != "none":
            # the reference builds a CLIP-B/16 teacher for any value but
            # 'none' (xqgan_model.py:209) and projects its 768-wide feature
            # through the shared quant_conv, so the encoder must be 768 wide
            if enc_dim != 768:
                raise ValueError("detail_guide requires a 768-dim encoder (vit_base_*): the "
                                 "shared quant_conv projects both encoder tokens and CLIP "
                                 "teacher features (reference xqgan_model.py:344)")
            self.detail_model = ViTBackbone(
                **_backbone_kwargs("vit_base_patch16_clip_224.openai", cfg.image_size, 16, dt),
                generator=generator).requires_grad_(False)
        self.to(device)

    def _make_quantizer(self, generator):
        cfg = self.config
        if len(cfg.v_patch_nums) == 1:
            return SingleVQ(cfg.codebook_size, cfg.codebook_embed_dim,
                            cfg.codebook_l2_norm, beta=cfg.commit_loss_beta,
                            generator=generator)
        if cfg.lfq:  # BSQ when the codebook is l2-normed
            return MultiScaleLFQ(cfg.codebook_size, cfg.codebook_embed_dim,
                                 tuple(cfg.v_patch_nums), using_znorm=cfg.codebook_l2_norm,
                                 share_quant_resi=cfg.share_quant_resi,
                                 codebook_drop=cfg.codebook_drop, scale=cfg.scale,
                                 entropy_weight=cfg.entropy_loss_ratio,
                                 soft_entropy=cfg.soft_entropy, generator=generator)
        # the JAX package builds the multi-scale VQ with a cosine search always
        return MultiScaleVQ(cfg.codebook_size, cfg.codebook_embed_dim,
                            tuple(cfg.v_patch_nums), using_znorm=True,
                            share_quant_resi=cfg.share_quant_resi,
                            codebook_drop=cfg.codebook_drop, generator=generator)

    @property
    def quantizers(self):
        return tuple(self.quantizes) if self.config.product_quant > 1 else (self.quantize,)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> pre-quant latent grids (B, P, g, g, C_codebook), fp32."""
        cfg = self.config
        g = self.grid
        if cfg.enc_type == "cnn":
            h = self.encoder(x)  # (B, g, g, z)
            if h.shape[1] != g:
                raise ValueError(
                    f"encoder output grid {h.shape[1]}x{h.shape[2]} != "
                    f"sqrt(num_latent_tokens)={g}: check image_size ({cfg.image_size}) "
                    f"against encoder_ch_mult's downsampling "
                    f"(f{2 ** (len(cfg.encoder_ch_mult) - 1)})")
            # one latent: the JAX package's CNN encode has one branch, which its
            # quantizers index as h_P[:, i], clamped to branch 0 (JAX clamps an
            # index past the end), so with product_quant > 1 every branch
            # quantizes the same latent
            return self.quant_conv(h)[:, None].expand(-1, cfg.product_quant, -1, -1, -1)
        h = self.quant_conv(self.encoder(x))  # (B, P*g*g, C)
        return h.reshape(h.shape[0], cfg.product_quant, g, g, cfg.codebook_embed_dim)

    def decode(self, quant: torch.Tensor, return_prelast: bool = False):
        """Quantized latents (B, g, g, P*C) -> image NHWC (unclamped); with
        ``return_prelast`` also the decoder's pre-last activation."""
        q = self.post_quant_conv(quant)
        if self.config.dec_type == "cnn":
            return self.decoder(q, return_prelast=return_prelast)
        b, g1, g2, d = q.shape
        return self.decoder(q.reshape(b, g1 * g2, d), return_prelast=return_prelast)

    @property
    def last_layer(self) -> torch.Tensor:
        """The decoder's last-layer weight, the adaptive GAN weight's anchor
        (reference ``get_last_layer``): the CNN decoder's ``conv_out``, or the
        ToPixel head's; the ``identity`` head has none and raises."""
        w = self.decoder.last_layer if self.config.dec_type == "cnn" \
            else self.decoder.to_pixel.last_layer
        if w is None:
            raise NotImplementedError(
                f"adaptive disc weight needs a last layer; to_pixel="
                f"{self.config.to_pixel!r} has none")
        return w

    def _teacher_input(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] -> ImageNet-normalised (xqgan_model.py:172-173, 304)."""
        mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
        std = torch.tensor(_IMAGENET_STD, device=x.device)
        return ((x.float() * 0.5 + 0.5) - mean) / std

    def _guide_loss(self, feat_t: torch.Tensor, feat_q: torch.Tensor, scale: float,
                    epoch: int) -> torch.Tensor:
        """ClipLoss, with the clip_norm-annealed logit scale
        (xqgan_model.py:321-331); ``epoch`` is a host int."""
        f1, f2 = feat_t.float(), feat_q.float()
        if self.config.clip_norm:
            f1 = f1 / (torch.linalg.vector_norm(f1, dim=1, keepdim=True) + 1e-12)
            f2 = f2 / (torch.linalg.vector_norm(f2, dim=1, keepdim=True) + 1e-12)
            scale = (epoch % 200) / 200.0 * (100.0 - scale) + scale if epoch < 200 else 100.0
        return clip_loss(f1, f2, scale)

    def forward(self, x: torch.Tensor, *, train: bool = False, epoch: int = 0,
                alpha: float = 0.0, beta: float = 0.0, delta_ratio: float = 1.0,
                generator: Optional[torch.Generator] = None,
                dropout_n: Optional[torch.Tensor] = None,
                perturb: Optional[tuple] = None) -> TokenizerOut:
        """Training forward (xqgan_model.py:268-365) of NHWC images in
        [-1, 1]. With ``train``: a multi-scale quantizer's dropout draws one
        randint(start_drop, S + 1) per sample from ``generator`` (on the
        images' device), unless ``dropout_n`` (B,) gives it (one scale draws
        nothing); with ``perturb_delta_max`` > 0 and one branch, RobustTok's
        perturbation (``alpha``, ``beta``, and the top-k budget annealed to
        ``delta_ratio * perturb_delta_max``) replaces the branch's quantized
        latents after its vq and commit losses, before the decoder and both
        guide losses read them, with its two uniform draws from
        ``generator`` unless ``perturb`` gives them (``ops/perturb.py``);
        and the decoder also returns its pre-last activation."""
        cfg = self.config
        b = x.shape[0]
        h_P = self.encode(x)
        sn = len(cfg.v_patch_nums)
        if train and dropout_n is None and sn > 1:
            dropout_n = torch.randint(cfg.start_drop, sn + 1, (b,), generator=generator,
                                      device=x.device)
        outs: List[QuantOut] = [qz(h_P[:, i], dropout_n=dropout_n, train=train)
                                for i, qz in enumerate(self.quantizers)]
        p = cfg.product_quant
        zero = torch.zeros((), device=x.device)
        quant_list = [o.f_hat for o in outs]
        dependency_loss = zero
        if p > 1:
            dependency_loss = cfg.dependency_loss_weight * _orthogonal_cosine_loss(
                quant_list[0].mean(dim=(1, 2)), quant_list[-1].mean(dim=(1, 2)))
        elif cfg.perturb_delta_max > 0 and train:
            # the annealed budget in fp32, as the JAX step's traced product
            delta_eff = float(np.float32(delta_ratio) * np.float32(cfg.perturb_delta_max))
            quant_list[0] = add_perturbation(
                h_P[:, 0], quant_list[0], self.quantizers[0].codebook, alpha=alpha,
                beta=beta, delta=cfg.perturb_delta_max, delta_eff=delta_eff,
                generator=generator, codebook_norm=cfg.codebook_l2_norm, draws=perturb)
        quant = torch.cat(quant_list, dim=-1)
        dec, pre_last = self.decode(quant, return_prelast=True) if train else (
            self.decode(quant), None)
        # the guides' InfoNCE contrasts the global batch (the reference
        # all-gathers its features), less its first int(B codebook_drop)
        n_drop = int(global_batch_rows(b)[1] * cfg.codebook_drop)
        sem_loss = detail_loss = zero
        if cfg.semantic_guide == "dinov2":
            with torch.no_grad():
                tokens = self.semantic_model(self._teacher_input(x))
            z_s = tokens[:, 0] if cfg.guide_type_1 == "class" else tokens[:, 1:].mean(dim=1)
            if cfg.enc_type == "cnn":
                z_s = F.linear(z_s.float(), self.sem_linear.weight, self.sem_linear.bias)
                z_q = h_P[:, 0].mean(dim=(1, 2))
            else:
                z_s = self.quant_conv(z_s)
                z_q = quant_list[-1].mean(dim=(1, 2))
            z_s, z_q = all_gather_batch(z_s), all_gather_batch(z_q)
            sem_loss = self._guide_loss(z_s[n_drop:], z_q[n_drop:], cfg.sem_loss_scale,
                                        epoch) * cfg.sem_loss_weight
        if cfg.detail_guide != "none":
            # the reference asserts guide_type_2 == 'patch' (xqgan_model.py:336):
            # the mean of the patch tokens
            with torch.no_grad():
                tokens = self.detail_model(self._teacher_input(x))
            z_d = self.quant_conv(tokens[:, 1:].mean(dim=1))
            z_q = quant_list[0].mean(dim=(1, 2))
            z_d, z_q = all_gather_batch(z_d), all_gather_batch(z_q)
            detail_loss = self._guide_loss(z_d[n_drop:], z_q[n_drop:], cfg.detail_loss_scale,
                                           epoch) * cfg.detail_loss_weight
        return TokenizerOut(
            dec=dec, vq_loss=sum(o.vq_loss for o in outs) / p,
            commit_loss=sum(o.commit_loss for o in outs) / p,
            entropy_loss=sum(o.entropy_loss for o in outs) / p, sem_loss=sem_loss,
            detail_loss=detail_loss, dependency_loss=dependency_loss,
            hits_PSV=torch.stack([o.hits_SV for o in outs]), pre_last=pre_last)

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

    def img_to_sem_feat(self, x: torch.Tensor) -> torch.Tensor:
        """The semantic (last) branch's final-scale quantized feature f_hat,
        (B, g, g, C) (xqgan_model.py:405-426): the linear probe's input."""
        return self._branch_fhats(x)[-1][-1]

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
        """Codes of branch i -> their embeddings (``si``, the scale, matters
        to LFQ only: its codes are +-scale**si bits)."""
        return self.quantizers[i].embed(idx, si)

    def soft_embed_branch(self, i: int, probs: torch.Tensor) -> torch.Tensor:
        """``more_smooth`` mixture embedding: a (B, l, V) code distribution
        times branch i's codebook (L2-normalised for a normed single-scale
        VQ) instead of a hard lookup. LFQ/BSQ has no dense codebook and
        raises, as in the JAX package."""
        qz = self.quantizers[i]
        if isinstance(qz, MultiScaleLFQ):
            raise NotImplementedError("more_smooth requires a dense VQ codebook; LFQ/BSQ "
                                      "has none")
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
