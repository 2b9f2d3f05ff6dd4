"""JAX-package parameters -> the port's state dict, with numpy only.

``vqmodel_state_dict_from_flax`` takes the JAX package's ``VQModel`` params
(a nested dict of arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``)
and returns the upstream torch layout that
``imagefolder_tpu/utils/convert_torch.py::export_vqmodel`` writes, so the
port's ``VQModel`` loads it with ``load_state_dict(strict=True)``. It covers
the ported slice only.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from imagefolder_tpu_torch.models.tokenizer import ModelArgs, check_slice

__all__ = ["vqmodel_state_dict_from_flax"]


def _put_linear(sd: dict, key: str, p: Mapping):
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_ln(sd: dict, key: str, p: Mapping):
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_vit_backbone(sd: dict, p: Mapping, prefix: str):
    if "patch_embed" in p:  # flax never creates it for the decoder
        k = np.asarray(p["patch_embed"]["kernel"])  # (p, p, Cin, D)
        sd[f"{prefix}patch_embed.proj.weight"] = k.transpose(3, 2, 0, 1)
        sd[f"{prefix}patch_embed.proj.bias"] = np.asarray(p["patch_embed"]["bias"])
    sd[f"{prefix}cls_token"] = np.asarray(p["cls_token"])
    sd[f"{prefix}pos_embed"] = np.asarray(p["pos_embed"])
    _put_ln(sd, f"{prefix}norm", p["norm"])
    i = 0
    while f"block_{i}" in p:
        b = p[f"block_{i}"]
        g = f"{prefix}blocks.{i}."
        _put_ln(sd, g + "norm1", b["norm1"])
        _put_ln(sd, g + "norm2", b["norm2"])
        _put_linear(sd, g + "attn.qkv", b["attn"]["qkv"])
        _put_linear(sd, g + "attn.proj", b["attn"]["proj"])
        _put_linear(sd, g + "mlp.fc1", b["mlp"]["fc1"]["base"])
        _put_linear(sd, g + "mlp.fc2", b["mlp"]["fc2"]["base"])
        sd[g + "ls1.gamma"] = np.asarray(b["ls1"])
        sd[g + "ls2.gamma"] = np.asarray(b["ls2"])
        i += 1


def vqmodel_state_dict_from_flax(params: Mapping, margs: ModelArgs) -> dict:
    """flax VQModel params -> {name: fp32 CPU tensor} for the port's VQModel."""
    check_slice(margs)
    sd: dict = {}
    for name in ("quant_conv", "post_quant_conv"):  # Dense -> 1x1 conv
        sd[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T[:, :, None, None]
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    enc, dec = params["encoder"], params["decoder"]
    _put_vit_backbone(sd, enc["model"], "encoder.model.")
    sd["encoder.latent_tokens"] = np.asarray(enc["latent_tokens"])
    sd["encoder.lvl_embed.weight"] = np.asarray(enc["lvl_embed"])
    _put_vit_backbone(sd, dec["model"], "decoder.model.")
    sd["decoder.mask_token"] = np.asarray(dec["mask_token"])
    sd["decoder.lvl_embed.weight"] = np.asarray(dec["lvl_embed"])
    _put_linear(sd, "decoder.to_pixel.model", dec["to_pixel"]["proj"])
    sd["quantize.embedding.weight"] = np.asarray(params["quantize"]["codebook"])
    sd["quantize.ema_vocab_hit_SV"] = np.zeros((margs.codebook_size,), np.float32)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
