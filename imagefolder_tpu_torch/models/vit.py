"""DINOv2-style ViT encoder/decoder with learned latent tokens
(counterpart of ``imagefolder_tpu/models/vit.py``).

Ported: the ``Block`` with LayerScale (DINOv2: the sublayer path, fp32
residual, composed or, after ``set_fused_sublayers``, fused) and without
it (DinoDisc's ViT-S trunk and the CLIP ViT-B/16 detail teacher: the
composed path, the residual in the activation dtype), with LoRA adapters
(``LoRALinear``: XQ-GAN's ``lora`` finetuning on the MLP, ``lat_lora`` also
on qkv and proj with latent-only deltas; such a block never fuses),
``ViTBackbone`` (with CLIP's ``norm_pre`` when ``pre_norm``) with its pos
embed resampled to any square latent grid (``bicubic_aa``, as timm) and
optional per-block activation checkpointing (``remat``), the ``ToPixel``
heads (``linear``, ``conv``, ``siren``, ``identity``), and
``LatentEncoder`` (product quantization included; the attention mask that
``lat_lora`` forces) / ``LatentDecoder`` (with the pre-last activation for
the adaptive GAN weight), with absolute position embeddings or, with
``abs_pos_embed=False``, learned ``latent_pos_embed``. Module and parameter
names follow the upstream torch layout that
``imagefolder_tpu/utils/convert_torch.py::export_vqmodel`` writes, so its
state dicts load with ``strict=True``; the LoRA adapters and the conv and
siren heads, which it does not export, are named after their flax modules
(``lora_a``, ``lora_b``, ``deconv``, ``sine1``, ``sine2``). Public functions
keep the JAX package's NHWC / token-major layouts. The decoder's RoPE blocks
(``use_rope``: ``RoPEAttention``, a mixed-2D rotary on the image tokens and a
1D rotary on the latents, ``freqs`` and ``freqs_1d`` per block) and its
pooled-latent conditioning of the mask tokens (``cond_latent``: upstream's
``cl_mlp1``, ``cl_mlp2`` and ``cl_norm1``) are ported; no ``ModelArgs`` field
reaches either, as in the JAX package.

The decoder keeps the reference quirk: with absolute position embeddings
its latent stream gets an extra cls token, so its block input length is
``num_patches + 1 + num_latent + 1``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from imagefolder_tpu_torch.ops import rope
from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda.attention import attention_qkv, dot_product_attention
from imagefolder_tpu_torch.ops.cuda.block import attn_sublayer, dense, mlp_sublayer, row_dense
from imagefolder_tpu_torch.ops.resize import resize
from imagefolder_tpu_torch.utils.init import (lecun_normal_, linear, normal_, trunc_normal_,
                                              uniform_)

__all__ = ["ViTBackbone", "LatentEncoder", "LatentDecoder", "ToPixel", "LoRALinear",
           "RoPEAttention", "VIT_PRESETS", "set_fused_sublayers"]

# timm dinov2 model presets (vision_transformer.py:2895-2925)
VIT_PRESETS = {
    "vit_small_patch14_dinov2.lvd142m": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch14_dinov2.lvd142m": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch14_dinov2.lvd142m": dict(embed_dim=1024, depth=24, num_heads=16),
    "vit_giant_patch14_dinov2.lvd142m": dict(embed_dim=1536, depth=40, num_heads=24),
    "vit_base_patch16_clip_224.openai": dict(
        embed_dim=768, depth=12, num_heads=12, init_values=None, pre_norm=True
    ),
}


class LayerNorm(nn.LayerNorm):
    """timm LayerNorm (eps 1e-6) with fp32 math; output in the activation dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.out_dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


_LORA_ALPHA = 8.0  # LoRADense's lora_alpha


class LoRALinear(nn.Module):
    """The JAX package's ``LoRADense``: the frozen base Linear (``weight``,
    ``bias``, the flax Dense init) plus, with ``rank`` > 0, a low-rank
    adapter y += (x A^T) B^T * (_LORA_ALPHA / rank), A (``lora_a``,
    N(0, 0.02)) and B (``lora_b``, zeros) fp32 parameters used in the
    activation dtype, as a flax Dense(dtype) uses them. ``latent_tokens`` > 0
    keeps the delta on the last ``latent_tokens`` sequence positions only
    (``lat_lora``: the image tokens stay the frozen trunk's)."""

    def __init__(self, din: int, dout: int, rank: int = 0, latent_tokens: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        base = linear(din, dout, generator)
        self.weight, self.bias = base.weight, base.bias
        self.rank, self.latent_tokens = rank, latent_tokens
        if rank > 0:
            self.lora_a = skip_init(nn.Linear, din, rank, bias=False)
            normal_(self.lora_a.weight, 0.02, generator)
            self.lora_b = skip_init(nn.Linear, rank, dout, bias=False)
            nn.init.zeros_(self.lora_b.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dense(x, self.weight, self.bias)
        if self.rank == 0:
            return y
        act = x.dtype
        delta = F.linear(F.linear(x, self.lora_a.weight.to(act)), self.lora_b.weight.to(act))
        delta = delta * (_LORA_ALPHA / self.rank)
        if self.latent_tokens > 0:
            n = x.shape[-2]
            pos = torch.arange(n, device=x.device)[:, None]
            delta = torch.where(pos >= n - self.latent_tokens, delta, torch.zeros_like(delta))
        return y + delta


class Attention(nn.Module):
    """Parameters of the fused-qkv attention; the math is ``attn_sublayer``
    (or, with adapters or no LayerScale, ``Block._composed``). ``rank`` > 0 puts LoRA
    adapters on qkv and proj (``lat_lora``).

    ``tp``: under tensor parallelism (``parallel/mesh.py::tp_shard_params``)
    this rank's share of the heads: ``qkv`` holds the q, k and v rows of its
    heads (and their bias entries), ``proj`` the matching input columns."""

    tp = None

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None,
                 rank: int = 0, latent_tokens: int = 0):
        super().__init__()
        self.qkv = LoRALinear(dim, 3 * dim, rank, latent_tokens=latent_tokens,
                              generator=generator)
        self.proj = LoRALinear(dim, dim, rank, latent_tokens=latent_tokens,
                               generator=generator)


_ROPE_THETA = 10.0  # the mixed-2D rotary's base (RoPEAttention.rope_theta)


class RoPEAttention(nn.Module):
    """Attention with rotary embeddings (the JAX package's ``RoPEAttention``,
    vendored from vision_transformer.py:200-278): qkv, then a learnable
    mixed-2D rotary (``freqs``, (2, H, hd/2)) on the ``num_image_tokens``
    image tokens and a learnable 1D rotary (``freqs_1d``, (nl, hd/2, 2)) on
    the trailing ``num_latent_tokens`` latents, the one prefix token (cls)
    left as it is, then ``dot_product_attention`` (#3, or #4 past the
    single-block budget) and proj.

    ``tp``: under tensor parallelism this rank's share of the heads, as in
    ``Attention``; it reads its heads' slice of ``freqs`` and the whole
    ``freqs_1d`` through f, so that their gradients sum every rank's."""

    tp = None

    def __init__(self, dim: int, num_heads: int, num_latent_tokens: int,
                 num_image_tokens: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        hd = dim // num_heads
        self.num_heads, self.num_latent_tokens = num_heads, num_latent_tokens
        self.qkv = LoRALinear(dim, 3 * dim, generator=generator)
        self.proj = LoRALinear(dim, dim, generator=generator)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
        self.freqs = nn.Parameter(torch.from_numpy(
            rope.init_2d_freqs(hd, num_heads, _ROPE_THETA, seed=seed)))
        self.freqs_1d = nn.Parameter(torch.from_numpy(rope.init_1d_freqs(hd, num_latent_tokens)))
        g = math.isqrt(num_image_tokens)
        t_x, t_y = rope.init_t_xy(g, g)
        self.register_buffer("t_x", torch.from_numpy(t_x), persistent=False)
        self.register_buffer("t_y", torch.from_numpy(t_y), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        tp, freqs, freqs_1d = self.tp, self.freqs, self.freqs_1d
        if tp is not None:
            x, freqs, freqs_1d = tp.enter(x), tp.heads(freqs, 1), tp.enter(freqs_1d)
        heads = freqs.shape[1]
        q, k, v = self.qkv(x).reshape(b, n, 3, heads, c // self.num_heads).unbind(2)
        cis2d = rope.compute_mixed_cis(freqs, self.t_x, self.t_y)
        nl = self.num_latent_tokens

        def rot(t):
            return torch.cat([t[:, :1], rope.apply_rotary(t[:, 1:n - nl], cis2d),
                              rope.apply_rotary(t[:, n - nl:], freqs_1d)], dim=1)

        out = dot_product_attention(rot(q), rot(k), v, bias=mask)
        return row_dense(out.reshape(b, n, -1), self.proj.weight, self.proj.bias, tp)


class Mlp(nn.Module):
    """Parameters of the MLP; the math is ``mlp_sublayer`` (or, with
    adapters or no LayerScale, ``Block._composed``). ``rank`` > 0 puts LoRA adapters on
    fc1 and fc2."""

    def __init__(self, dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None, rank: int = 0,
                 latent_tokens: int = 0):
        super().__init__()
        self.fc1 = LoRALinear(dim, hidden, rank, latent_tokens=latent_tokens,
                              generator=generator)
        self.fc2 = LoRALinear(hidden, dim, rank, latent_tokens=latent_tokens,
                              generator=generator)


class Block(nn.Module):
    """Pre-norm ViT block. With LayerScale (``init_values``, DINOv2) the
    residual stream enters in the activation dtype and leaves in fp32, as in
    the JAX sublayers, and ``fuse_attn`` / ``fuse_mlp`` route the sublayers
    to the fused kernels (#7, #8; see ``set_fused_sublayers``); without it
    (``init_values=None``, DinoDisc's trunk) it is the JAX composed path,
    ``x + h`` in the activation dtype, the block has no ``ls1``/``ls2``, and
    it never fuses. ``lora_rank`` > 0 adds LoRA adapters to the MLP (and,
    with ``lat_lora``, to qkv and proj, their deltas on the last
    ``lora_latent_tokens`` positions only); such a block runs the JAX
    package's composed module path and never fuses either. ``use_rope``
    gives it ``RoPEAttention`` over ``num_image_tokens`` image and
    ``num_latent_tokens`` latent tokens (no adapters on it), on the composed
    path too (the JAX ``Block`` takes it under rope, ``vit.py:265``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 1e-5,
                 dtype: torch.dtype = torch.float32, *,
                 fuse_attn: bool = False, fuse_mlp: bool = False, lora_rank: int = 0,
                 lat_lora: bool = False, lora_latent_tokens: int = 0,
                 use_rope: bool = False, num_latent_tokens: int = 0,
                 num_image_tokens: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (init_values is None or lora_rank > 0 or use_rope) and (fuse_attn or fuse_mlp):
            raise ValueError("a Block without LayerScale, with LoRA or with RoPE never fuses "
                             "its sublayers")
        self.num_heads = num_heads
        self.lora_rank = lora_rank
        self.use_rope = use_rope
        self.fuse_attn, self.fuse_mlp = fuse_attn, fuse_mlp
        lat = lora_latent_tokens if lat_lora else 0
        self.norm1 = LayerNorm(dim, dtype)
        if use_rope:
            self.attn = RoPEAttention(dim, num_heads, num_latent_tokens, num_image_tokens,
                                      generator=generator)
        else:
            self.attn = Attention(dim, generator, lora_rank if lat_lora else 0, lat)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator, lora_rank, lat)
        if init_values is None:
            self.ls1 = self.ls2 = None
        else:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)

    def _heads(self) -> int:
        """The heads this rank computes: all of them, or under tensor
        parallelism its share."""
        tp = self.attn.tp
        return self.num_heads if tp is None else self.num_heads // tp.size

    def _composed(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The JAX package's composed module path (``Attention``, ``Mlp`` of
        ``LoRADense``s): each sublayer's output, times its LayerScale when
        the block has one (fp32), added to the residual stream; under rope
        the attention is ``RoPEAttention``. Under tensor parallelism the
        attention runs this rank's heads (``attn.tp``: f before qkv, g after
        proj's partial products); the MLP, which the rule leaves whole, runs
        whole."""
        a, tp = self.attn, self.attn.tp
        if self.use_rope:
            h = a(self.norm1(x), mask)
        elif tp is None:
            h = a.proj(attention_qkv(a.qkv(self.norm1(x)), self.num_heads, bias=mask))
        else:
            o = attention_qkv(a.qkv(tp.enter(self.norm1(x))), self._heads(), bias=mask)
            h = row_dense(o, a.proj.weight, a.proj.bias, tp)
        x = x + (h if self.ls1 is None else h * self.ls1.gamma)
        h = self.mlp.fc2(gelu_exact(self.mlp.fc1(self.norm2(x))))
        return x + (h if self.ls2 is None else h * self.ls2.gamma)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.lora_rank > 0 or self.ls1 is None or self.use_rope:
            return self._composed(x, mask)
        a, m = self.attn, self.mlp
        x = attn_sublayer(self.norm1(x), x, a.qkv.weight, a.qkv.bias,
                          a.proj.weight, a.proj.bias, self.ls1.gamma,
                          self._heads(), mask=mask, fused=self.fuse_attn, tp=a.tp)
        return mlp_sublayer(self.norm2(x), x, m.fc1.weight, m.fc1.bias,
                            m.fc2.weight, m.fc2.bias, self.ls2.gamma, fused=self.fuse_mlp)


def set_fused_sublayers(module: nn.Module, attn: bool, mlp: bool) -> int:
    """Route every LayerScale ``Block`` under ``module`` through the fused
    sublayer kernels (#7 for attention, #8 for the MLP) or back to the
    composed path: the explicit, per-model counterpart of the JAX package's
    ``IMGF_FUSE_ATTN`` / ``IMGF_FUSE_MLP`` (off by default, as there). The
    attention fuses only where the JAX router would: no mask and N * N within
    the single-block budget. Blocks without LayerScale, with LoRA adapters
    or with RoPE never fuse (as in the JAX package). Returns the number of
    blocks set."""
    blocks = [b for b in module.modules() if isinstance(b, Block) and b.ls1 is not None
              and b.lora_rank == 0 and not b.use_rope]
    for b in blocks:
        b.fuse_attn, b.fuse_mlp = bool(attn), bool(mlp)
    return len(blocks)


class PatchEmbed(nn.Module):
    """Holds the upstream ``patch_embed.proj`` conv weight (D, 3, p, p)."""

    def __init__(self, patch_size: int, dim: int, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = skip_init(nn.Conv2d, channels, dim, patch_size, patch_size)
        lecun_normal_(self.proj.weight, channels * patch_size * patch_size, generator)
        nn.init.zeros_(self.proj.bias)


class ViTBackbone(nn.Module):
    """Patch embed + cls token + pos embed + pre-norm blocks + final norm;
    ``pre_norm`` adds CLIP's ``norm_pre`` after the pos embed, in the
    activation dtype.

    ``patch_embed=False`` builds the decoder's backbone, which never embeds
    patches and so has no ``patch_embed`` parameters (as in flax).
    ``use_rope`` builds RoPE blocks over the patches and the trailing
    ``num_latent_tokens`` latents."""

    def __init__(self, img_size: int = 256, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, init_values: Optional[float] = 1e-5,
                 pre_norm: bool = False, dtype: torch.dtype = torch.float32, *,
                 patch_embed: bool = True, remat: bool = False, lora_rank: int = 0,
                 lat_lora: bool = False, lora_latent_tokens: int = 0,
                 use_rope: bool = False, num_latent_tokens: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.grid = img_size // patch_size
        self.num_patches = self.grid * self.grid
        if patch_embed:
            self.patch_embed = PatchEmbed(patch_size, embed_dim, generator=generator)
        else:
            self.patch_embed = None
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            trunc_normal_(torch.empty(1, 1 + self.num_patches, embed_dim), 0.02, generator))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, init_values, dtype, lora_rank=lora_rank,
                  lat_lora=lat_lora, lora_latent_tokens=lora_latent_tokens,
                  use_rope=use_rope, num_latent_tokens=num_latent_tokens,
                  num_image_tokens=self.num_patches, generator=generator)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, dtype)
        # CLIP's LayerNorm before the blocks (timm norm_pre)
        self.norm_pre = LayerNorm(embed_dim, dtype) if pre_norm else None

    def patchify(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC image -> (B, N, D) patch tokens in the activation dtype. The
        stride-p conv is a matmul over flattened (c, i, j) patches."""
        p = self.patch_size
        b, hh, ww, ch = img.shape
        gh, gw = hh // p, ww // p
        x = img[:, :gh * p, :gw * p].to(self.dtype)
        x = x.reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, gh * gw, ch * p * p)
        proj = self.patch_embed.proj
        return F.linear(x, proj.weight.to(self.dtype).flatten(1)) + proj.bias.to(self.dtype)

    def resampled_pos_embed(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """timm resample_abs_pos_embed parity: the patch part of the pos embed
        resized to ``grid_hw`` with antialiased bicubic, the cls entry kept
        as it is. (1, 1 + h*w, D) fp32."""
        pe = self.pos_embed.float()
        g = self.grid
        if tuple(grid_hw) == (g, g):
            return pe
        patch = resize(pe[:, 1:].reshape(1, g, g, -1), grid_hw, "bicubic_aa")
        return torch.cat([pe[:, :1], patch.reshape(1, grid_hw[0] * grid_hw[1], -1)], dim=1)

    def pos_embed_tokens(self, x: torch.Tensor, grid_hw: Optional[tuple[int, int]] = None,
                         keep_cls: bool = True) -> torch.Tensor:
        """Prepend the cls token and add the pos embed, resampled to
        ``grid_hw`` when given (else the native grid). fp32."""
        pe = self.pos_embed.float() if grid_hw is None else self.resampled_pos_embed(grid_hw)
        if x.shape[1] + 1 != pe.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens for a pos embed of {pe.shape[1] - 1}")
        cls = self.cls_token.float().expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x.float()], dim=1) + pe
        return x if keep_cls else x[:, 1:]

    def run_blocks(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``norm_pre`` (when the backbone has one), the blocks and the final
        norm. With ``remat`` and gradients on, each block keeps only its
        input and recomputes its activations in the backward (the JAX
        package's ``nn.remat`` per block)."""
        x = x.to(self.dtype)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        recompute = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, mask, use_reentrant=False) if recompute else blk(x, mask)
        return self.norm(x)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """Plain ViT forward_features: (B, H, W, 3) -> (B, 1+N, D) normed tokens."""
        return self.run_blocks(self.pos_embed_tokens(self.patchify(img)))


def _backbone_kwargs(model_name: str, img_size: int, patch_size: int,
                     dtype: torch.dtype) -> dict:
    preset = VIT_PRESETS[model_name]
    return dict(img_size=img_size, patch_size=patch_size,
                embed_dim=preset["embed_dim"], depth=preset["depth"],
                num_heads=preset["num_heads"],
                init_values=preset.get("init_values", 1e-5),
                pre_norm=preset.get("pre_norm", False), dtype=dtype)


def _latent_grid(num_latent_tokens: int) -> int:
    g = math.isqrt(num_latent_tokens)
    if g * g != num_latent_tokens:
        raise ValueError(f"{num_latent_tokens} latent tokens do not make a square grid")
    return g


def _lora_rank(tuning_method: str, lora_rank: int) -> int:
    """The adapters' rank under a tuning method (0: none)."""
    if tuning_method not in ("full", "frozen", "lora", "lat_lora"):
        raise NotImplementedError(f"tuning_method={tuning_method!r}")
    return lora_rank if tuning_method in ("lora", "lat_lora") else 0


class LatentEncoder(nn.Module):
    """ViT over [cls, patches, latent tokens]; returns the trailing latent
    tokens (B, nl, D) in the activation dtype. ``num_latent_tokens`` is the
    total over the ``product_quant`` branches. With ``abs_pos_embed`` each
    branch's latents get the pos embed resampled to their own square grid
    and a level embedding of their own (ids 1..P; 0 for cls and patches);
    without it the latents get the learned ``latent_pos_embed`` instead.
    ``use_attn_mask`` (forced by ``lat_lora``) adds the shared -inf bias that
    keeps prefix and image tokens from attending to the latents.
    ``tuning_method`` 'lora' or 'lat_lora' gives the trunk's blocks LoRA
    adapters of ``lora_rank`` (what gets trained is the optimizer's
    labels' business, as in the JAX package)."""

    def __init__(self, model_name: str = "vit_base_patch14_dinov2.lvd142m",
                 img_size: int = 256, patch_size: int = 16,
                 num_latent_tokens: int = 256, product_quant: int = 1,
                 abs_pos_embed: bool = True, tuning_method: str = "full",
                 use_attn_mask: bool = False, dtype: torch.dtype = torch.float32, *,
                 remat: bool = False, lora_rank: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rank = _lora_rank(tuning_method, lora_rank)
        if num_latent_tokens % product_quant:
            raise ValueError(f"{num_latent_tokens} latents over {product_quant} branches")
        self.branch_grid = _latent_grid(num_latent_tokens // product_quant)
        self.num_latent_tokens = num_latent_tokens
        self.product_quant = product_quant
        self.abs_pos_embed = abs_pos_embed
        self.use_attn_mask = use_attn_mask or tuning_method == "lat_lora"
        self.model = ViTBackbone(**_backbone_kwargs(model_name, img_size, patch_size, dtype),
                                 remat=remat, lora_rank=rank,
                                 lat_lora=tuning_method == "lat_lora",
                                 lora_latent_tokens=num_latent_tokens, generator=generator)
        d = self.embed_dim = self.model.embed_dim
        self.latent_tokens = nn.Parameter(
            normal_(torch.empty(1, num_latent_tokens, d), 1e-6, generator))
        if abs_pos_embed:
            self.lvl_embed = skip_init(nn.Embedding, 1 + product_quant, d)
            trunc_normal_(self.lvl_embed.weight, math.sqrt(1 / d / 3), generator)
        else:
            self.latent_pos_embed = nn.Parameter(
                trunc_normal_(torch.empty(1, num_latent_tokens, d), 0.02, generator))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        m = self.model
        nl = self.num_latent_tokens
        g = self.branch_grid
        x = m.pos_embed_tokens(m.patchify(img))  # (B, 1+N, D) fp32
        z = self.latent_tokens.float().expand(img.shape[0], -1, -1)
        if self.abs_pos_embed:
            lvl = self.lvl_embed.weight.float()
            pieces = [x + lvl[0]]
            for i, zi in enumerate(z.chunk(self.product_quant, dim=1)):
                pieces.append(m.pos_embed_tokens(zi, grid_hw=(g, g), keep_cls=False)
                              + lvl[i + 1])
            x = torch.cat(pieces, dim=1)
        else:
            x = torch.cat([x, z + self.latent_pos_embed.float()], dim=1)
        mask = None
        if self.use_attn_mask:
            total = x.shape[1]
            idx = torch.arange(total, device=x.device)
            blocked = (idx[:, None] < total - nl) & (idx[None, :] >= total - nl)
            mask = torch.zeros(total, total, device=x.device).masked_fill(
                blocked, float("-inf"))[None, None]
        return m.run_blocks(x, mask)[:, -nl:]


class ToPixel(nn.Module):
    """Patch -> pixel head (dino_enc/to_pixel.py:36-94), NHWC fp32 out:
    - ``linear``: Linear(D, C p p) in fp32, then unpatchify;
    - ``conv``: ConvTranspose2d(D, C, p, stride p), which with stride equal
      to its kernel is a per-patch projection: one einsum on the torch-layout
      (D, C, p, p) weight (``deconv``), fp32;
    - ``siren``: two SineLayers with omega 30 (``sine1`` D -> 2D, ``sine2``
      2D -> (img / p) p C), with the reference's raw channel-major
      ``view(B, C, S, S)`` of the output, not a patchwise one;
    - ``identity``: the tokens unchanged.
    ``last_layer`` is the weight that anchors the adaptive GAN weight
    (reference ``get_last_layer``); ``identity`` has none.

    ``tp``: under tensor parallelism (``parallel/mesh.py::tp_shard_params``)
    the linear head's weight holds this rank's input columns (the JAX rule
    splits ``proj`` as a row layer): the whole input enters through f and is
    narrowed to them, and the partial products are summed over the model
    group (g) before the bias."""

    tp = None

    def __init__(self, embed_dim: int, img_size: int = 256, patch_size: int = 16,
                 channels: int = 3, mode: str = "linear", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("linear", "conv", "siren", "identity"):
            raise NotImplementedError(f"to_pixel mode {mode!r}")
        self.mode = mode
        self.img_size, self.patch_size, self.channels = img_size, patch_size, channels
        d, p = embed_dim, patch_size
        if mode == "linear":
            self.model = linear(d, channels * p * p, generator)
        elif mode == "conv":  # torch ConvTranspose2d's default init, fan_in = C p p
            bound = 1.0 / math.sqrt(channels * p * p)
            self.deconv = nn.Module()
            self.deconv.weight = nn.Parameter(
                uniform_(torch.empty(d, channels, p, p), -bound, bound, generator))
            self.deconv.bias = nn.Parameter(
                uniform_(torch.empty(channels), -bound, bound, generator))
        elif mode == "siren":
            f2 = (img_size // p) * p * channels
            self.sine1 = skip_init(nn.Linear, d, 2 * d)
            uniform_(self.sine1.weight, -1.0 / d, 1.0 / d, generator)
            uniform_(self.sine1.bias, -1.0 / math.sqrt(d), 1.0 / math.sqrt(d), generator)
            self.sine2 = skip_init(nn.Linear, 2 * d, f2)
            w_bound = math.sqrt(6.0 / (2 * d)) / 30.0
            uniform_(self.sine2.weight, -w_bound, w_bound, generator)
            uniform_(self.sine2.bias, -1.0 / math.sqrt(2 * d), 1.0 / math.sqrt(2 * d), generator)

    @property
    def last_layer(self) -> Optional[torch.Tensor]:
        return {"linear": lambda: self.model.weight, "conv": lambda: self.deconv.weight,
                "siren": lambda: self.sine2.weight, "identity": lambda: None}[self.mode]()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, D)
        p = self.patch_size
        hw = self.img_size // p
        b, l, d = x.shape
        if self.mode == "identity":
            return x
        if self.mode == "conv":
            y = torch.einsum("bhwd,dcij->bhiwjc", x.float().reshape(b, hw, hw, d),
                             self.deconv.weight.float())
            return y.reshape(b, hw * p, hw * p, self.channels) + self.deconv.bias.float()
        if self.mode == "siren":
            h = torch.sin(30.0 * F.linear(x.float(), self.sine1.weight, self.sine1.bias))
            y = torch.sin(30.0 * F.linear(h, self.sine2.weight, self.sine2.bias))
            s = p * math.isqrt(l)
            return y.reshape(b, self.channels, s, s).permute(0, 2, 3, 1)
        tp = self.tp
        if tp is None:
            x = F.linear(x.float(), self.model.weight, self.model.bias)
        else:
            x = row_dense(tp.heads(x.float(), -1), self.model.weight, self.model.bias, tp)
        x = x.reshape(b, hw, hw, p, p, self.channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hw * p, hw * p, self.channels)


class _CondMlp(nn.Module):
    """timm ``Mlp(d, d, norm_layer=LayerNorm)``: fc1, exact GELU, LayerNorm
    (eps 1e-6), fc2, in fp32."""

    def __init__(self, d: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(d, d, generator)
        self.norm = LayerNorm(d)
        self.fc2 = linear(d, d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.norm(gelu_exact(self.fc1(x))))


class LatentDecoder(nn.Module):
    """Mask tokens at the image positions + quantized latents (B, nl, D);
    returns the ``to_pixel`` head's output (unpatchified pixels (B, H, W, C)
    in fp32, or the tokens for ``identity``), and with ``return_prelast``
    also the pre-last activation (the head's input, (B, N, D) in the
    activation dtype). With ``abs_pos_embed`` the latents get the pos embed
    resampled to their grid (with the extra cls token) and the level
    embeddings; without it, the learned ``latent_pos_embed``. 'lora' and
    'lat_lora' tuning give the trunk's blocks adapters of ``lora_rank``,
    latent-only under 'lat_lora' (the latent stream and, with absolute
    position embeddings, its cls token).

    ``use_rope`` (``dinov2.py:333-342``): RoPE blocks, and the sequence is
    cls, the mask tokens and the raw latents, with no positional adds (no
    ``lvl_embed`` or ``latent_pos_embed``). ``cond_latent``
    (``dinov2.py:323-325``; not with rope, whose path never reaches it, so
    that flax creates no parameters for it there): the mask tokens (and cls)
    after their pos embed are conditioned on the latents' mean through two
    timm MLPs: x + cl_mlp2(cl_norm1(x + cl_mlp1(mean z)))."""

    def __init__(self, model_name: str = "vit_base_patch14_dinov2.lvd142m",
                 img_size: int = 256, patch_size: int = 16,
                 num_latent_tokens: int = 256, abs_pos_embed: bool = True,
                 to_pixel: str = "linear", tuning_method: str = "full",
                 out_channels: int = 3, dtype: torch.dtype = torch.float32, *,
                 remat: bool = False, lora_rank: int = 0, use_rope: bool = False,
                 cond_latent: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        rank = _lora_rank(tuning_method, lora_rank)
        self.grid = _latent_grid(num_latent_tokens)
        self.num_latent_tokens = num_latent_tokens
        self.abs_pos_embed = abs_pos_embed
        self.use_rope = use_rope
        self.cond_latent = cond_latent and not use_rope
        self.model = ViTBackbone(**_backbone_kwargs(model_name, img_size, patch_size, dtype),
                                 patch_embed=False, remat=remat, lora_rank=rank,
                                 lat_lora=tuning_method == "lat_lora",
                                 lora_latent_tokens=num_latent_tokens
                                 + int(abs_pos_embed and not use_rope),
                                 use_rope=use_rope,
                                 num_latent_tokens=num_latent_tokens if use_rope else 0,
                                 generator=generator)
        d = self.embed_dim = self.model.embed_dim
        self.mask_token = nn.Parameter(normal_(torch.empty(1, 1, d), 1e-6, generator))
        if use_rope:
            pass  # rope replaces absolute positions
        elif abs_pos_embed:
            self.lvl_embed = skip_init(nn.Embedding, 2, d)
            trunc_normal_(self.lvl_embed.weight, math.sqrt(1 / d / 3), generator)
        else:
            self.latent_pos_embed = nn.Parameter(
                trunc_normal_(torch.empty(1, num_latent_tokens, d), 0.02, generator))
        self.to_pixel = ToPixel(d, img_size, patch_size, out_channels, to_pixel,
                                generator=generator)
        if self.cond_latent:
            self.cl_mlp1 = _CondMlp(d, generator)
            self.cl_mlp2 = _CondMlp(d, generator)
            self.cl_norm1 = LayerNorm(d)

    def forward(self, z: torch.Tensor, return_prelast: bool = False):
        m = self.model
        x = self.mask_token.float().expand(z.shape[0], m.num_patches, -1)
        if self.use_rope:
            cls = m.cls_token.float().expand(z.shape[0], 1, -1)
            x = m.run_blocks(torch.cat([cls, x, z.float()], dim=1))[:, 1:m.num_patches + 1]
            out = self.to_pixel(x)
            return (out, x) if return_prelast else out
        x = m.pos_embed_tokens(x)  # (B, 1+N, D)
        if self.cond_latent:
            ffn = x + self.cl_mlp1(z.float().mean(dim=1, keepdim=True))
            x = x + self.cl_mlp2(self.cl_norm1(ffn))
        if self.abs_pos_embed:
            # reference quirk: cls is prepended to the latent stream and kept
            z = m.pos_embed_tokens(z.float(), grid_hw=(self.grid, self.grid), keep_cls=True)
            lvl = self.lvl_embed.weight.float()
            x = torch.cat([x + lvl[0], z + lvl[1]], dim=1)
        else:
            x = torch.cat([x, z.float() + self.latent_pos_embed.float()], dim=1)
        x = m.run_blocks(x)[:, 1:m.num_patches + 1]  # image-position outputs
        out = self.to_pixel(x)
        return (out, x) if return_prelast else out
