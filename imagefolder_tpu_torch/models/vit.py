"""DINOv2-style ViT encoder/decoder with learned latent tokens
(counterpart of ``imagefolder_tpu/models/vit.py``).

Ported: the ``Block`` with LayerScale (DINOv2: the sublayer path, fp32
residual) and without it (DinoDisc's ViT-S trunk: the composed path, the
residual in the activation dtype), ``ViTBackbone`` with its pos embed
resampled to any square latent grid (``bicubic_aa``, as timm) and optional
per-block activation checkpointing (``remat``), the ``linear`` ``ToPixel``
head, and ``LatentEncoder`` (product quantization included) /
``LatentDecoder`` (with the pre-last activation for the adaptive GAN weight)
with absolute position embeddings. Module and parameter names follow the upstream torch layout that
``imagefolder_tpu/utils/convert_torch.py::export_vqmodel`` writes, so its
state dicts load with ``strict=True``. Public functions keep the JAX
package's NHWC / token-major layouts.

The decoder keeps the reference quirk: its latent stream gets an extra cls
token, so its block input length is ``num_patches + 1 + num_latent + 1``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda.attention import attention_qkv
from imagefolder_tpu_torch.ops.cuda.block import attn_sublayer, dense, mlp_sublayer
from imagefolder_tpu_torch.ops.resize import resize
from imagefolder_tpu_torch.utils.init import lecun_normal_, linear, normal_, trunc_normal_

__all__ = ["ViTBackbone", "LatentEncoder", "LatentDecoder", "ToPixel",
           "VIT_PRESETS"]

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


class Attention(nn.Module):
    """Parameters of the fused-qkv attention; the math is ``attn_sublayer``."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.qkv = linear(dim, 3 * dim, generator)
        self.proj = linear(dim, dim, generator)


class Mlp(nn.Module):
    """Parameters of the MLP; the math is ``mlp_sublayer``."""

    def __init__(self, dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(dim, hidden, generator)
        self.fc2 = linear(hidden, dim, generator)


class Block(nn.Module):
    """Pre-norm ViT block. With LayerScale (``init_values``, DINOv2) the
    residual stream enters in the activation dtype and leaves in fp32, as in
    the JAX sublayers; without it (``init_values=None``, DinoDisc's trunk)
    it is the JAX composed path, ``x + h`` in the activation dtype, and the
    block has no ``ls1``/``ls2``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 1e-5,
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, generator)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)
        if init_values is None:
            self.ls1 = self.ls2 = None
        else:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a, m = self.attn, self.mlp
        if self.ls1 is None:
            o = attention_qkv(dense(self.norm1(x), a.qkv.weight, a.qkv.bias), self.num_heads,
                              bias=mask)
            x = x + dense(o, a.proj.weight, a.proj.bias)
            h = gelu_exact(dense(self.norm2(x), m.fc1.weight, m.fc1.bias))
            return x + dense(h, m.fc2.weight, m.fc2.bias)
        x = attn_sublayer(self.norm1(x), x, a.qkv.weight, a.qkv.bias,
                          a.proj.weight, a.proj.bias, self.ls1.gamma,
                          self.num_heads, mask=mask)
        return mlp_sublayer(self.norm2(x), x, m.fc1.weight, m.fc1.bias,
                            m.fc2.weight, m.fc2.bias, self.ls2.gamma)


class PatchEmbed(nn.Module):
    """Holds the upstream ``patch_embed.proj`` conv weight (D, 3, p, p)."""

    def __init__(self, patch_size: int, dim: int, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = skip_init(nn.Conv2d, channels, dim, patch_size, patch_size)
        lecun_normal_(self.proj.weight, channels * patch_size * patch_size, generator)
        nn.init.zeros_(self.proj.bias)


class ViTBackbone(nn.Module):
    """Patch embed + cls token + pos embed + pre-norm blocks + final norm.

    ``patch_embed=False`` builds the decoder's backbone, which never embeds
    patches and so has no ``patch_embed`` parameters (as in flax)."""

    def __init__(self, img_size: int = 256, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, init_values: Optional[float] = 1e-5,
                 pre_norm: bool = False, dtype: torch.dtype = torch.float32, *,
                 patch_embed: bool = True, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pre_norm:
            raise NotImplementedError("pre_norm backbones (the CLIP teacher) are not ported")
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
            Block(embed_dim, num_heads, mlp_ratio, init_values, dtype, generator=generator)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, dtype)

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
        """The blocks and the final norm. With ``remat`` and gradients on,
        each block keeps only its input and recomputes its activations in
        the backward (the JAX package's ``nn.remat`` per block)."""
        x = x.to(self.dtype)
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


def _check_tuning(tuning_method: str):
    if tuning_method not in ("full", "frozen"):
        raise NotImplementedError(f"tuning_method={tuning_method!r} (LoRA) is not ported")


class LatentEncoder(nn.Module):
    """ViT over [cls, patches, latent tokens]; returns the trailing latent
    tokens (B, nl, D) in the activation dtype. ``num_latent_tokens`` is the
    total over the ``product_quant`` branches: each branch's latents get the
    pos embed resampled to their own square grid and a level embedding of
    their own (ids 1..P; 0 for cls and patches). ``use_attn_mask`` adds the
    shared -inf bias that keeps prefix and image tokens from attending to the
    latents."""

    def __init__(self, model_name: str = "vit_base_patch14_dinov2.lvd142m",
                 img_size: int = 256, patch_size: int = 16,
                 num_latent_tokens: int = 256, product_quant: int = 1,
                 abs_pos_embed: bool = True, tuning_method: str = "full",
                 use_attn_mask: bool = False, dtype: torch.dtype = torch.float32, *,
                 remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not abs_pos_embed:
            raise NotImplementedError("abs_pos_embed=False is not ported")
        _check_tuning(tuning_method)
        if num_latent_tokens % product_quant:
            raise ValueError(f"{num_latent_tokens} latents over {product_quant} branches")
        self.branch_grid = _latent_grid(num_latent_tokens // product_quant)
        self.num_latent_tokens = num_latent_tokens
        self.product_quant = product_quant
        self.use_attn_mask = use_attn_mask
        self.model = ViTBackbone(**_backbone_kwargs(model_name, img_size, patch_size, dtype),
                                 remat=remat, generator=generator)
        d = self.embed_dim = self.model.embed_dim
        self.latent_tokens = nn.Parameter(
            normal_(torch.empty(1, num_latent_tokens, d), 1e-6, generator))
        self.lvl_embed = skip_init(nn.Embedding, 1 + product_quant, d)
        trunc_normal_(self.lvl_embed.weight, math.sqrt(1 / d / 3), generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        m = self.model
        nl = self.num_latent_tokens
        g = self.branch_grid
        lvl = self.lvl_embed.weight.float()
        x = m.pos_embed_tokens(m.patchify(img)) + lvl[0]  # (B, 1+N, D) fp32
        z = self.latent_tokens.float().expand(img.shape[0], -1, -1)
        pieces = [x]
        for i, zi in enumerate(z.chunk(self.product_quant, dim=1)):
            pieces.append(m.pos_embed_tokens(zi, grid_hw=(g, g), keep_cls=False) + lvl[i + 1])
        x = torch.cat(pieces, dim=1)
        mask = None
        if self.use_attn_mask:
            total = x.shape[1]
            idx = torch.arange(total, device=x.device)
            blocked = (idx[:, None] < total - nl) & (idx[None, :] >= total - nl)
            mask = torch.zeros(total, total, device=x.device).masked_fill(
                blocked, float("-inf"))[None, None]
        return m.run_blocks(x, mask)[:, -nl:]


class ToPixel(nn.Module):
    """``linear`` patch->pixel head: Linear(D, C*p*p) in fp32, then
    unpatchify to NHWC."""

    def __init__(self, embed_dim: int, img_size: int = 256, patch_size: int = 16,
                 channels: int = 3, mode: str = "linear", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode != "linear":
            raise NotImplementedError(f"to_pixel mode {mode!r} is not ported")
        self.img_size, self.patch_size, self.channels = img_size, patch_size, channels
        self.model = linear(embed_dim, channels * patch_size * patch_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, D)
        p = self.patch_size
        hw = self.img_size // p
        b = x.shape[0]
        x = F.linear(x.float(), self.model.weight, self.model.bias)
        x = x.reshape(b, hw, hw, p, p, self.channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hw * p, hw * p, self.channels)


class LatentDecoder(nn.Module):
    """Mask tokens at the image positions + quantized latents (B, nl, D);
    returns unpatchified pixels (B, H, W, C) in fp32, and with
    ``return_prelast`` also the pre-last activation (the ToPixel head's
    input, (B, N, D) in the activation dtype)."""

    def __init__(self, model_name: str = "vit_base_patch14_dinov2.lvd142m",
                 img_size: int = 256, patch_size: int = 16,
                 num_latent_tokens: int = 256, abs_pos_embed: bool = True,
                 to_pixel: str = "linear", tuning_method: str = "full",
                 out_channels: int = 3, dtype: torch.dtype = torch.float32, *,
                 remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not abs_pos_embed:
            raise NotImplementedError("abs_pos_embed=False is not ported")
        _check_tuning(tuning_method)
        self.grid = _latent_grid(num_latent_tokens)
        self.num_latent_tokens = num_latent_tokens
        self.model = ViTBackbone(**_backbone_kwargs(model_name, img_size, patch_size, dtype),
                                 patch_embed=False, remat=remat, generator=generator)
        d = self.embed_dim = self.model.embed_dim
        self.mask_token = nn.Parameter(normal_(torch.empty(1, 1, d), 1e-6, generator))
        self.lvl_embed = skip_init(nn.Embedding, 2, d)
        trunc_normal_(self.lvl_embed.weight, math.sqrt(1 / d / 3), generator)
        self.to_pixel = ToPixel(d, img_size, patch_size, out_channels, to_pixel,
                                generator=generator)

    def forward(self, z: torch.Tensor, return_prelast: bool = False):
        m = self.model
        x = self.mask_token.float().expand(z.shape[0], m.num_patches, -1)
        x = m.pos_embed_tokens(x)  # (B, 1+N, D)
        # reference quirk: cls is prepended to the latent stream and kept
        z = m.pos_embed_tokens(z.float(), grid_hw=(self.grid, self.grid), keep_cls=True)
        lvl = self.lvl_embed.weight.float()
        x = torch.cat([x + lvl[0], z + lvl[1]], dim=1)
        x = m.run_blocks(x)[:, 1:m.num_patches + 1]  # image-position outputs
        out = self.to_pixel(x)
        return (out, x) if return_prelast else out
