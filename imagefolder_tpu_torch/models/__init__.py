"""Models (counterpart of ``imagefolder_tpu/models``): the tokenizer
(``VQModel``), the VAR, RAR and MaskGIT generators, and the package-level
assembly factories (reference ``models/__init__.py:14-82`` ``build_vae_var``,
``build_rar``, ``build_maskgit``)."""

from __future__ import annotations

from typing import Optional

import torch

from imagefolder_tpu_torch.models.maskgit import MaskGIT, MaskGITConfig
from imagefolder_tpu_torch.models.rar import RAR, RARConfig
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import VAR, VARConfig

__all__ = ["ModelArgs", "VQModel", "VAR", "VARConfig", "RAR", "RARConfig", "MaskGIT",
           "MaskGITConfig", "build_vae_var", "build_rar", "build_maskgit"]


def build_vae_var(model_args: ModelArgs, depth: int = 16, *,
                  shared_aln: bool = False, attn_l2_norm: bool = True,
                  cond_drop_rate: float = 0.1, num_classes: int = 1000,
                  dtype_str: str = "float32",
                  generator: Optional[torch.Generator] = None,
                  device: torch.device | str = "cuda"):
    """Tokenizer + VAR assembly (reference ``models/__init__.py:14-65``):
    width = 64*depth, heads = depth, drop_path = 0.1 * depth/24, vocab and
    Cvae folded over the PQ branches (xqgan_model.py:123). Both models are
    drawn from ``generator`` on the CPU (tokenizer first) and moved to
    ``device``, the card unless the caller asks for the CPU."""
    vae = VQModel(model_args, generator=generator, device=device)
    var_cfg = VARConfig(
        vocab_size=model_args.codebook_size * model_args.product_quant,
        Cvae=model_args.codebook_embed_dim * model_args.product_quant,
        product_quant=model_args.product_quant,
        num_classes=num_classes,
        depth=depth, embed_dim=depth * 64, num_heads=depth,
        shared_aln=shared_aln, attn_l2_norm=attn_l2_norm,
        cond_drop_rate=cond_drop_rate,
        drop_path_rate=0.1 * depth / 24,
        patch_nums=tuple(model_args.v_patch_nums),
        dtype_str=dtype_str,
    )
    return vae, VAR(var_cfg, generator=generator, device=device)


def build_rar(model_args: Optional[ModelArgs] = None, *, seq_len: Optional[int] = None,
              codebook_size: Optional[int] = None, hidden: int = 768, depth: int = 24,
              heads: int = 16, num_classes: int = 1000, dtype_str: str = "float32",
              remat: bool = False, generator: Optional[torch.Generator] = None,
              device: torch.device | str = "cuda") -> RAR:
    """RAR over a tokenizer's flat final-scale tokens (reference
    ``utils/train_utils.py:101-143`` and ``configs/generator/robustTok-rar.yaml``'s
    model keys; RAR-B by default). Pass the tokenizer's ``model_args``, or
    explicit ``seq_len``/``codebook_size``. Drawn from ``generator`` on the
    CPU and moved to ``device``, the card unless the caller asks for the CPU."""
    return RAR(RARConfig(
        embed_dim=hidden, depth=depth, num_heads=heads,
        image_seq_len=_seq_len(seq_len, model_args),
        codebook_size=codebook_size or model_args.codebook_size,
        condition_num_classes=num_classes, dtype_str=dtype_str, remat=remat),
        generator=generator, device=device)


def build_maskgit(model_args: Optional[ModelArgs] = None, *, seq_len: Optional[int] = None,
                  codebook_size: Optional[int] = None, hidden: int = 768, depth: int = 24,
                  heads: int = 16, num_classes: int = 1000, dtype_str: str = "float32",
                  arch: str = "bert", generator: Optional[torch.Generator] = None,
                  device: torch.device | str = "cuda") -> MaskGIT:
    """MaskGIT over the same token layout as RAR (reference
    ``utils/train_utils.py`` model_type='maskgit' -> ``RAR/maskgit.py:40``;
    MaskGIT-B by default: 768 wide, 24 deep, 16 heads of 48). ``arch='uvit'``
    selects the UViTBert trunk (``RAR/maskgit.py:209``). Pass the
    tokenizer's ``model_args``, or explicit ``seq_len``/``codebook_size``.
    Drawn from ``generator`` on the CPU and moved to ``device``, the card
    unless the caller asks for the CPU."""
    return MaskGIT(MaskGITConfig(
        embed_dim=hidden, depth=depth, num_heads=heads,
        image_seq_len=_seq_len(seq_len, model_args),
        codebook_size=codebook_size or model_args.codebook_size,
        condition_num_classes=num_classes, dtype_str=dtype_str, arch=arch),
        generator=generator, device=device)


def _seq_len(seq_len: Optional[int], model_args: Optional[ModelArgs]) -> int:
    """``seq_len``, or the tokenizer's flat final-scale token count."""
    if seq_len is not None:
        return seq_len
    return model_args.num_latent_tokens * model_args.product_quant
