"""JAX-package parameters -> the port's state dicts, with numpy only.

``vqmodel_state_dict_from_flax`` takes the JAX package's ``VQModel`` params
(the frozen ``semantic_model`` teacher included) and
``var_state_dict_from_flax`` its ``VAR`` params (nested dicts of arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, params)``) and return the upstream
torch layout that ``imagefolder_tpu/utils/convert_torch.py::export_vqmodel``
and ``export_var`` write, so the port's ``VQModel`` and ``VAR`` load them
with ``load_state_dict(strict=True)``. ``lpips_state_dict_from_flax`` is
the inverse of the JAX package's ``convert_lpips_checkpoint`` (the taming
layout), and ``dinodisc_state_dict_from_flax`` mirrors the flax DinoDisc
tree (the JAX package exports no discriminator): ``dino.*`` in the ViT
layout, the heads, and the ``spectral`` collection's ``u`` and ``sigma`` as
buffers. ``flax_path`` names the flax path of a port parameter, which the
trainers' optimizer labels read. They cover the ported slice only.

One gap is filled: a Phi that the nearest-tick mapping never picks (e.g.
``phi_2`` of K = 4 with ``v_patch_nums=(1, 2, 3)``) was never called in flax
and has no params, while the port's Phi bank, like upstream's, holds all K.
Such a Phi gets zeros. It is never applied, so its values change no result
(``export_vqmodel`` leaves it out, and upstream keeps its torch init).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import re

import numpy as np
import torch

from imagefolder_tpu_torch.models.tokenizer import ModelArgs, check_slice
from imagefolder_tpu_torch.models.var import VARConfig

__all__ = ["vqmodel_state_dict_from_flax", "multiscale_vq_state_dict_from_flax",
           "lpips_state_dict_from_flax", "dinodisc_state_dict_from_flax", "flax_path",
           "var_key_map", "var_state_dict_from_flax", "to_torch"]


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
    if "norm" in p:  # DinoDisc's trunk never applies (or creates) it
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
        if "ls1" in b:  # blocks without LayerScale have none
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
    if "semantic_model" in params:
        _put_vit_backbone(sd, params["semantic_model"], "semantic_model.")
    return to_torch(sd)


# VGG16 conv index -> taming's slice (features[0:4], [4:9], [9:16], [16:23], [23:30])
_LPIPS_SLICE_ENDS = (4, 9, 16, 23, 30)


def lpips_state_dict_from_flax(params: Mapping) -> dict:
    """flax LPIPS params -> {name: fp32 CPU tensor} in the taming layout of
    the port's ``LPIPS``: the inverse of ``convert_lpips_checkpoint``."""
    sd: dict = {}
    for name, p in params.items():
        if name.startswith("conv_"):
            idx = int(name[5:])
            k = 1 + sum(idx >= end for end in _LPIPS_SLICE_ENDS)
            sd[f"net.slice{k}.{idx}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
            sd[f"net.slice{k}.{idx}.bias"] = np.asarray(p["bias"])
        elif name.startswith("lin_"):
            sd[f"lin{name[4:]}.model.1.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    return to_torch(sd)


def dinodisc_state_dict_from_flax(params: Mapping, disc_vars: Mapping) -> dict:
    """flax DinoDisc params and its ``{"spectral": ...}`` variables ->
    {name: fp32 CPU tensor} for the port's ``DinoDisc``."""
    sd: dict = {}
    _put_vit_backbone(sd, params["dino"], "dino.")
    spectral = disc_vars["spectral"]
    i = 0
    while f"head_{i}" in params:
        hp, hs = params[f"head_{i}"], spectral[f"head_{i}"]
        # flax names the state "<conv>/kernel/u" and "<conv>/kernel/sigma"
        convs = [(f"heads.{i}.{b}.conv", hp[b][f"{b}_conv"], hs[b]["SpectralNorm_0"],
                  f"{b}_conv") for b in ("b0", "b1")]
        convs.append((f"heads.{i}.out", hp["out_conv"], hs["SpectralNorm_0"], "out_conv"))
        for name, conv, state, flax_name in convs:
            sd[f"{name}.weight"] = np.asarray(conv["kernel"]).transpose(2, 1, 0)  # (out, in, k)
            sd[f"{name}.bias"] = np.asarray(conv["bias"])
            sd[f"{name}.u"] = np.asarray(state[f"{flax_name}/kernel/u"])
            sd[f"{name}.sigma"] = np.asarray(state[f"{flax_name}/kernel/sigma"])
        for b in ("b0", "b1"):
            _put_ln(sd, f"heads.{i}.{b}.bn", hp[b][f"{b}_bn"])
        i += 1
    return to_torch(sd)


# port parameter name -> flax path, applied in order; then "." -> "/" and a
# trailing "weight" -> "scale" under a norm, else "kernel"
_PATH_RULES = [
    (r"^quantizes\.(\d+)\.", r"quantize_\1."),
    (r"embedding\.weight$", "codebook"),
    (r"quant_resi\.qresi_ls\.(\d+)\.", r"phi_bank.phi_\1.Conv_0."),
    (r"quant_resi\.qresi\.", "phi_bank.phi_0.Conv_0."),
    (r"quant_resi\.(\d+)\.", r"phi_bank.phi_\1.Conv_0."),
    (r"blocks\.(\d+)\.", r"block_\1."),
    (r"mlp\.(fc\d)\.", r"mlp.\1.base."),
    (r"(ls\d)\.gamma$", r"\1"),
    (r"patch_embed\.proj\.", "patch_embed."),
    (r"to_pixel\.model\.", "to_pixel.proj."),
    (r"lvl_embed\.weight$", "lvl_embed"),
    (r"^heads\.(\d+)\.", r"head_\1."),
    (r"\b(b\d)\.conv\.", r"\1.\1_conv."),
    (r"\b(b\d)\.bn\.", r"\1.\1_bn."),
    (r"\bout\.(weight|bias)$", r"out_conv.\1"),
]


def flax_path(name: str) -> str:
    """The flax path ("a/b/leaf") of a port parameter of ``VQModel`` or
    ``DinoDisc``, as its converter above reads it."""
    for pat, rep in _PATH_RULES:
        name = re.sub(pat, rep, name)
    parts = name.split(".")
    if parts[-1] == "weight":
        parent = parts[-2] if len(parts) > 1 else ""
        parts[-1] = "scale" if "norm" in parent or parent.endswith("_bn") else "kernel"
    return "/".join(parts)


def var_key_map(cfg: VARConfig) -> Dict[str, Tuple[str, bool]]:
    """Each parameter of the port's VAR -> (its flax path "a/b/leaf", whether
    the flax array is the transpose: Dense kernels are (in, out))."""
    m: Dict[str, Tuple[str, bool]] = {}

    def linear(key: str, path: str):
        m[f"{key}.weight"] = (f"{path}/kernel", True)
        m[f"{key}.bias"] = (f"{path}/bias", False)

    linear("word_embed", "word_embed")
    for key in ("class_emb", "lvl_embed"):
        m[f"{key}.weight"] = (key, False)
    m["pos_start"] = ("pos_start", False)
    m["pos_1LC"] = ("pos_1LC", False)
    linear("head_nm.ada_lin.1", "head_nm/ada_lin")
    linear("head", "head")
    if cfg.p_drop > 0:
        m["empty_emb.weight"] = ("empty_emb", False)
    if cfg.shared_aln:
        linear("shared_ada_lin.1", "shared_ada_lin")
    for i in range(cfg.depth):
        g, f = f"blocks.{i}.", f"block_{i}/"
        m[g + "attn.mat_qkv.weight"] = (f + "attn/mat_qkv/kernel", True)
        m[g + "attn.q_bias"] = (f + "attn/q_bias", False)
        m[g + "attn.v_bias"] = (f + "attn/v_bias", False)
        linear(g + "attn.proj", f + "attn/proj")
        linear(g + "ffn.fc1", f + "ffn/fc1")
        linear(g + "ffn.fc2", f + "ffn/fc2")
        if cfg.attn_l2_norm:
            m[g + "attn.scale_mul_1H11"] = (f + "attn/scale_mul", False)
        if cfg.shared_aln:
            m[g + "ada_gss"] = (f + "ada_gss", False)
        else:
            linear(g + "ada_lin.1", f + "ada_lin")
    return m


def var_state_dict_from_flax(params: Mapping, cfg: VARConfig) -> dict:
    """flax VAR params -> {name: fp32 CPU tensor} for the port's VAR."""
    sd: dict = {}
    for key, (path, transposed) in var_key_map(cfg).items():
        leaf = params
        for part in path.split("/"):
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        sd[key] = leaf.T if transposed else leaf
    return to_torch(sd)
