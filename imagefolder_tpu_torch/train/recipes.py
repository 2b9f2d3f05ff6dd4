"""The flagship GAN recipe (counterpart of
``imagefolder_tpu/train/recipes.py:23-49``).

The VQ-4096-class tokenizer under full GAN training (reference
``configs/VQ-4096.yaml`` + ``xqgan_train.py`` defaults): DINOv2 ViT-B
encoder and decoder, PQ2, the ten-scale MSVQ pyramid of MSVR10P2-4096,
DinoDisc + LPIPS + the frozen DINOv2 semantic teacher, adaptive disc weight,
LeCam. ``chained_gan_step_fns`` is TPU timing machinery and is not ported.
"""

from __future__ import annotations

from typing import Optional

from imagefolder_tpu_torch.models.tokenizer import ModelArgs
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainConfig

__all__ = ["flagship_gan_recipe"]


def flagship_gan_recipe(batch: int, *, remat: bool = True,
                        margs_overrides: Optional[dict] = None,
                        tcfg_overrides: Optional[dict] = None):
    """(ModelArgs, TokenizerTrainConfig) of the flagship GAN train step;
    ``*_overrides`` replace fields of either."""
    mkw = dict(
        codebook_size=4096, codebook_embed_dim=32,
        v_patch_nums=(1, 1, 2, 3, 3, 4, 5, 6, 8, 11),
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_base_patch14_dinov2.lvd142m",
        decoder_model="vit_base_patch14_dinov2.lvd142m",
        semantic_guide="dinov2", detail_guide="none",
        num_latent_tokens=121, product_quant=2, abs_pos_embed=True,
        codebook_drop=0.1, start_drop=3, image_size=256,
        dtype_str="bfloat16", remat=remat)
    mkw.update(margs_overrides or {})
    tkw = dict(
        disc_type="dinodisc", disc_start=0, disc_adaptive_weight=True,
        lecam_loss_weight=0.001, epochs=1, steps_per_epoch=1000,
        image_size=256, ema=True, global_batch_size=batch)
    tkw.update(tcfg_overrides or {})
    return ModelArgs(**mkw), TokenizerTrainConfig(**tkw)
