"""Models (counterpart of ``imagefolder_tpu/models``): the tokenizer
(``VQModel``), the VAR and RAR generators, and the package-level assembly
factories (reference ``models/__init__.py:14-68`` ``build_vae_var``,
``build_rar``)."""

from __future__ import annotations

from typing import Optional

import torch

from imagefolder_tpu_torch.models.rar import RAR, RARConfig
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import VAR, VARConfig

__all__ = ["ModelArgs", "VQModel", "VAR", "VARConfig", "RAR", "RARConfig", "build_vae_var",
           "build_rar"]


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
    if seq_len is None:  # the tokenizer's flat final-scale token count
        seq_len = model_args.num_latent_tokens * model_args.product_quant
    return RAR(RARConfig(
        embed_dim=hidden, depth=depth, num_heads=heads, image_seq_len=seq_len,
        codebook_size=codebook_size or model_args.codebook_size,
        condition_num_classes=num_classes, dtype_str=dtype_str, remat=remat),
        generator=generator, device=device)
