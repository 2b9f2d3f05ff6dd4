"""JAX-package parameters -> the port's state dicts, with numpy only.

``vqmodel_state_dict_from_flax`` takes the JAX package's ``VQModel`` params
and ``var_state_dict_from_flax`` its ``VAR`` params (nested dicts of arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, params)``) and return the upstream
torch layout that ``imagefolder_tpu/utils/convert_torch.py::export_vqmodel``
and ``export_var`` write, so the port's ``VQModel`` and ``VAR`` load them
with ``load_state_dict(strict=True)``. They cover the ported slice only.

One gap is filled: a Phi that the nearest-tick mapping never picks (e.g.
``phi_2`` of K = 4 with ``v_patch_nums=(1, 2, 3)``) was never called in flax
and has no params, while the port's Phi bank, like upstream's, holds all K.
Such a Phi gets zeros. It is never applied, so its values change no result
(``export_vqmodel`` leaves it out, and upstream keeps its torch init).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from imagefolder_tpu_torch.models.tokenizer import ModelArgs, check_slice
from imagefolder_tpu_torch.models.var import VARConfig

__all__ = ["vqmodel_state_dict_from_flax", "multiscale_vq_state_dict_from_flax",
           "var_state_dict_from_flax", "to_torch"]


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


def multiscale_vq_state_dict_from_flax(params: Mapping, num_scales: int,
                                       share_quant_resi: int, prefix: str = "") -> dict:
    """One flax ``MultiScaleVQ``'s params (``codebook``, ``phi_bank``) under
    the upstream names of ``imagefolder_tpu_torch/ops/quantize.py``
    (``embedding.weight``, the Phi convs under ``quant_resi.*``, a zero (S, V)
    ``ema_vocab_hit_SV``), as numpy arrays. Phis without flax params get
    zeros (see the module note)."""
    cb = np.asarray(params["codebook"])
    sd = {f"{prefix}embedding.weight": cb,
          f"{prefix}ema_vocab_hit_SV": np.zeros((num_scales, cb.shape[0]), np.float32)}
    share, c = share_quant_resi, cb.shape[1]
    k = {0: num_scales, 1: 1}.get(share, share)
    bank = params.get("phi_bank", {})
    for i in range(k):
        name = {0: f"quant_resi.{i}", 1: "quant_resi.qresi"}.get(share, f"quant_resi.qresi_ls.{i}")
        conv = bank.get(f"phi_{i}", {}).get("Conv_0")
        if conv is None:
            sd[f"{prefix}{name}.weight"] = np.zeros((c, c, 3, 3), np.float32)
            sd[f"{prefix}{name}.bias"] = np.zeros((c,), np.float32)
        else:
            sd[f"{prefix}{name}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{prefix}{name}.bias"] = np.asarray(conv["bias"])
    return sd


def to_torch(sd: dict) -> dict:
    """{name: numpy array} -> {name: fp32 CPU tensor}."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


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
    n_scales = len(margs.v_patch_nums)
    pq = margs.product_quant
    for i in range(pq):
        q = params[f"quantize_{i}" if pq > 1 else "quantize"]
        prefix = f"quantizes.{i}." if pq > 1 else "quantize."
        if n_scales > 1:
            sd.update(multiscale_vq_state_dict_from_flax(q, n_scales, margs.share_quant_resi,
                                                         prefix))
        else:  # single-scale VQ keeps a flat (V,) hit buffer
            sd[f"{prefix}embedding.weight"] = np.asarray(q["codebook"])
            sd[f"{prefix}ema_vocab_hit_SV"] = np.zeros(margs.codebook_size, np.float32)
    return to_torch(sd)


def var_state_dict_from_flax(params: Mapping, cfg: VARConfig) -> dict:
    """flax VAR params -> {name: fp32 CPU tensor} for the port's VAR."""
    sd: dict = {}
    _put_linear(sd, "word_embed", params["word_embed"])
    sd["class_emb.weight"] = np.asarray(params["class_emb"])
    sd["pos_start"] = np.asarray(params["pos_start"])
    sd["pos_1LC"] = np.asarray(params["pos_1LC"])
    sd["lvl_embed.weight"] = np.asarray(params["lvl_embed"])
    _put_linear(sd, "head_nm.ada_lin.1", params["head_nm"]["ada_lin"])
    _put_linear(sd, "head", params["head"])
    if cfg.p_drop > 0:
        sd["empty_emb.weight"] = np.asarray(params["empty_emb"])
    if cfg.shared_aln:
        _put_linear(sd, "shared_ada_lin.1", params["shared_ada_lin"])
    for i in range(cfg.depth):
        b = params[f"block_{i}"]
        a = b["attn"]
        g = f"blocks.{i}."
        sd[g + "attn.mat_qkv.weight"] = np.asarray(a["mat_qkv"]["kernel"]).T
        sd[g + "attn.q_bias"] = np.asarray(a["q_bias"])
        sd[g + "attn.v_bias"] = np.asarray(a["v_bias"])
        _put_linear(sd, g + "attn.proj", a["proj"])
        _put_linear(sd, g + "ffn.fc1", b["ffn"]["fc1"])
        _put_linear(sd, g + "ffn.fc2", b["ffn"]["fc2"])
        if cfg.attn_l2_norm:
            sd[g + "attn.scale_mul_1H11"] = np.asarray(a["scale_mul"])
        if cfg.shared_aln:
            sd[g + "ada_gss"] = np.asarray(b["ada_gss"])
        else:
            _put_linear(sd, g + "ada_lin.1", b["ada_lin"])
    return to_torch(sd)
