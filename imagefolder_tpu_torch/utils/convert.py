"""JAX-package parameters -> the port's state dicts, with numpy only.

``vqmodel_state_dict_from_flax`` takes the JAX package's ``VQModel`` params
(the frozen ``semantic_model`` and ``detail_model`` teachers included) and
``var_state_dict_from_flax`` its ``VAR`` params (nested dicts of arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, params)``) and return the upstream
torch layout that ``imagefolder_tpu/utils/convert_torch.py::export_vqmodel``
and ``export_var`` write, so the port's ``VQModel`` and ``VAR`` load them
with ``load_state_dict(strict=True)``. ``lpips_state_dict_from_flax`` is
the inverse of the JAX package's ``convert_lpips_checkpoint`` (the taming
layout), and ``dinodisc_state_dict_from_flax`` mirrors the flax DinoDisc
tree (the JAX package exports no discriminator): ``dino.*`` in the ViT
layout, the heads, and the ``spectral`` collection's ``u`` and ``sigma`` as
buffers. ``rar_state_dict_from_flax`` writes the reference RAR layout of
``export_rar``; ``maskgit_state_dict_from_flax`` upstream UViTBert's layout
for the ``uvit`` trunk (the inverse of ``convert_maskgit_uvit``) and the
same block layout for ``bert``. ``flax_path`` names the flax path of a port
parameter, and ``var_key_map``, ``rar_key_map`` and ``maskgit_key_map`` map
each parameter to its flax path, which the trainers' optimizer labels read.
They cover the ported slice only.

The tokenizer converter covers every ``ModelArgs`` the port builds: the
CNN encoder and decoder in the layout of ``export_cnn_encoder`` /
``export_cnn_decoder``, the LFQ/BSQ quantizer's Phi bank (its only state,
as ``convert_lfq`` reads it; no usage buffer), learned ``latent_pos_embed``
and a CNN encoder's ``sem_linear``. LoRA adapters and the ``conv`` and
``siren`` ToPixel heads have no JAX exporter; their flax parameters are
carried by the port's tests. ``latent_decoder_state_dict_from_flax`` takes
a flax ``LatentDecoder`` alone, with its RoPE blocks' ``freqs`` and
``freqs_1d`` (the (cos, sin) pairs, under the block's ``attn``) and the
``cond_latent`` MLPs under upstream's names (``cl_mlp1.fc1``,
``cl_mlp1.norm``, ..., ``cl_norm1``), which no ``ModelArgs`` reaches and
the JAX package exports nowhere.

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

from imagefolder_tpu_torch.models.maskgit import MaskGITConfig
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, check_slice
from imagefolder_tpu_torch.models.var import VARConfig

__all__ = ["vqmodel_state_dict_from_flax", "multiscale_vq_state_dict_from_flax",
           "latent_decoder_state_dict_from_flax",
           "phi_bank_state_dict_from_flax", "cnn_encoder_state_dict_from_flax",
           "cnn_decoder_state_dict_from_flax",
           "lpips_state_dict_from_flax", "dinodisc_state_dict_from_flax", "flax_path",
           "var_key_map", "var_state_dict_from_flax", "rar_key_map", "rar_state_dict_from_flax",
           "maskgit_key_map", "maskgit_state_dict_from_flax", "to_torch"]


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
    if "norm_pre" in p:  # CLIP's
        _put_ln(sd, f"{prefix}norm_pre", p["norm_pre"])
    i = 0
    while f"block_{i}" in p:
        b = p[f"block_{i}"]
        g = f"{prefix}blocks.{i}."
        _put_ln(sd, g + "norm1", b["norm1"])
        _put_ln(sd, g + "norm2", b["norm2"])
        for name in ("qkv", "proj"):  # under lat_lora a LoRADense: its base Dense
            dense = b["attn"][name]
            _put_linear(sd, g + f"attn.{name}", dense.get("base", dense))
        for name in ("freqs", "freqs_1d"):  # RoPEAttention's
            if name in b["attn"]:
                sd[g + f"attn.{name}"] = np.asarray(b["attn"][name])
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
    sd.update(phi_bank_state_dict_from_flax(params, num_scales, share_quant_resi, cb.shape[1],
                                            prefix))
    return sd


def phi_bank_state_dict_from_flax(params: Mapping, num_scales: int, share_quant_resi: int,
                                  c: int, prefix: str = "") -> dict:
    """A multi-scale quantizer's flax ``phi_bank`` as the port's Phi convs
    under ``quant_resi.*``: all of a ``MultiScaleLFQ``'s state. Phis without
    flax params get zeros (see the module note)."""
    sd: dict = {}
    share = share_quant_resi
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


def _put_conv(sd: dict, key: str, p: Mapping):
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_gn(sd: dict, key: str, p: Mapping):
    _put_ln(sd, key, p["norm"])


def _put_res_block(sd: dict, key: str, p: Mapping):
    _put_gn(sd, f"{key}.norm1", p["norm1"])
    _put_conv(sd, f"{key}.conv1", p["conv1"])
    _put_gn(sd, f"{key}.norm2", p["norm2"])
    _put_conv(sd, f"{key}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _put_conv(sd, f"{key}.nin_shortcut", p["nin_shortcut"])


def _put_attn_block(sd: dict, key: str, p: Mapping):
    _put_gn(sd, f"{key}.norm", p["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _put_conv(sd, f"{key}.{n}", p[n])


def cnn_encoder_state_dict_from_flax(p: Mapping, prefix: str = "encoder.",
                                     ch_mult=(1, 1, 2, 2, 4), num_res_blocks: int = 2) -> dict:
    """The flax CNN ``Encoder``'s params in the layout of the JAX package's
    ``export_cnn_encoder`` (numpy arrays)."""
    sd: dict = {}
    n = len(ch_mult)
    _put_conv(sd, f"{prefix}conv_in", p["conv_in"])
    for i in range(n):
        for j in range(num_res_blocks):
            _put_res_block(sd, f"{prefix}conv_blocks.{i}.res.{j}", p[f"res_{i}_{j}"])
            if i == n - 1:
                _put_attn_block(sd, f"{prefix}conv_blocks.{i}.attn.{j}", p[f"attn_{i}_{j}"])
        if i != n - 1:
            _put_conv(sd, f"{prefix}conv_blocks.{i}.downsample.conv", p[f"down_{i}"]["conv"])
    _put_res_block(sd, f"{prefix}mid.0", p["mid_res_0"])
    _put_attn_block(sd, f"{prefix}mid.1", p["mid_attn"])
    _put_res_block(sd, f"{prefix}mid.2", p["mid_res_1"])
    _put_gn(sd, f"{prefix}norm_out", p["norm_out"])
    _put_conv(sd, f"{prefix}conv_out", p["conv_out"])
    return sd


def cnn_decoder_state_dict_from_flax(p: Mapping, prefix: str = "decoder.",
                                     ch_mult=(1, 1, 2, 2, 4), num_res_blocks: int = 2) -> dict:
    """The flax CNN ``Decoder``'s params in the layout of the JAX package's
    ``export_cnn_decoder`` (numpy arrays)."""
    sd: dict = {}
    n = len(ch_mult)
    _put_conv(sd, f"{prefix}conv_in", p["conv_in"])
    _put_res_block(sd, f"{prefix}mid.0", p["mid_res_0"])
    _put_attn_block(sd, f"{prefix}mid.1", p["mid_attn"])
    _put_res_block(sd, f"{prefix}mid.2", p["mid_res_1"])
    for li, i_level in enumerate(reversed(range(n))):
        for j in range(num_res_blocks + 1):
            _put_res_block(sd, f"{prefix}conv_blocks.{li}.res.{j}", p[f"res_{li}_{j}"])
            if i_level == n - 1:
                _put_attn_block(sd, f"{prefix}conv_blocks.{li}.attn.{j}", p[f"attn_{li}_{j}"])
        if li != n - 1:
            _put_conv(sd, f"{prefix}conv_blocks.{li}.upsample.conv", p[f"up_{li}"]["conv"])
    _put_gn(sd, f"{prefix}norm_out", p["norm_out"])
    _put_conv(sd, f"{prefix}conv_out", p["conv_out"])
    return sd


def _put_latent_decoder(sd: dict, dec: Mapping, prefix: str):
    _put_vit_backbone(sd, dec["model"], f"{prefix}model.")
    sd[f"{prefix}mask_token"] = np.asarray(dec["mask_token"])
    for name in ("lvl_embed", "latent_pos_embed"):
        if name in dec:
            sd[f"{prefix}{name}" + (".weight" if name == "lvl_embed" else "")] = \
                np.asarray(dec[name])
    if "proj" in dec["to_pixel"]:
        _put_linear(sd, f"{prefix}to_pixel.model", dec["to_pixel"]["proj"])
    for i in (1, 2):  # cond_latent's timm Mlps
        if f"cl_mlp{i}_fc1" in dec:
            _put_linear(sd, f"{prefix}cl_mlp{i}.fc1", dec[f"cl_mlp{i}_fc1"])
            _put_ln(sd, f"{prefix}cl_mlp{i}.norm", dec[f"cl_mlp{i}_norm"])
            _put_linear(sd, f"{prefix}cl_mlp{i}.fc2", dec[f"cl_mlp{i}_fc2"])
    if "cl_norm1" in dec:
        _put_ln(sd, f"{prefix}cl_norm1", dec["cl_norm1"])


def latent_decoder_state_dict_from_flax(params: Mapping) -> dict:
    """flax ``LatentDecoder`` params (a ViT decoder alone, RoPE blocks and
    ``cond_latent`` included) -> {name: fp32 CPU tensor} for the port's
    ``LatentDecoder`` built with the same options (its linear head carried;
    the conv and siren heads are not)."""
    sd: dict = {}
    _put_latent_decoder(sd, params, "")
    return to_torch(sd)


def vqmodel_state_dict_from_flax(params: Mapping, margs: ModelArgs) -> dict:
    """flax VQModel params -> {name: fp32 CPU tensor} for the port's VQModel.
    A ViT's LoRA adapters and ``conv``/``siren`` ToPixel heads are not
    carried (the JAX package exports none): their port state comes from
    elsewhere."""
    check_slice(margs)
    sd: dict = {}
    for name in ("quant_conv", "post_quant_conv"):  # Dense -> 1x1 conv
        sd[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T[:, :, None, None]
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    enc, dec = params["encoder"], params["decoder"]
    if margs.enc_type == "cnn":
        sd.update(cnn_encoder_state_dict_from_flax(enc, "encoder.",
                                                   tuple(margs.encoder_ch_mult)))
    else:
        _put_vit_backbone(sd, enc["model"], "encoder.model.")
        sd["encoder.latent_tokens"] = np.asarray(enc["latent_tokens"])
        for name in ("lvl_embed", "latent_pos_embed"):
            if name in enc:
                sd[f"encoder.{name}" + (".weight" if name == "lvl_embed" else "")] = \
                    np.asarray(enc[name])
    if margs.dec_type == "cnn":
        sd.update(cnn_decoder_state_dict_from_flax(dec, "decoder.",
                                                   tuple(margs.decoder_ch_mult)))
    else:
        _put_latent_decoder(sd, dec, "decoder.")
    n_scales = len(margs.v_patch_nums)
    pq = margs.product_quant
    for i in range(pq):
        q = params[f"quantize_{i}" if pq > 1 else "quantize"]
        prefix = f"quantizes.{i}." if pq > 1 else "quantize."
        if margs.lfq and n_scales > 1:
            sd.update(phi_bank_state_dict_from_flax(q, n_scales, margs.share_quant_resi,
                                                    margs.codebook_embed_dim, prefix))
        elif n_scales > 1:
            sd.update(multiscale_vq_state_dict_from_flax(q, n_scales, margs.share_quant_resi,
                                                         prefix))
        else:  # single-scale VQ keeps a flat (V,) hit buffer
            sd[f"{prefix}embedding.weight"] = np.asarray(q["codebook"])
            sd[f"{prefix}ema_vocab_hit_SV"] = np.zeros(margs.codebook_size, np.float32)
    for teacher in ("semantic_model", "detail_model"):
        if teacher in params:
            _put_vit_backbone(sd, params[teacher], f"{teacher}.")
    if "sem_linear" in params:
        _put_linear(sd, "sem_linear", params["sem_linear"])
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
    (r"\bblocks\.(\d+)\.", r"block_\1."),
    (r"mlp\.(fc\d)\.", r"mlp.\1.base."),
    (r"(ls\d)\.gamma$", r"\1"),
    (r"patch_embed\.proj\.", "patch_embed."),
    (r"to_pixel\.model\.", "to_pixel.proj."),
    (r"lvl_embed\.weight$", "lvl_embed"),
    (r"^heads\.(\d+)\.", r"head_\1."),
    (r"\b(b\d)\.conv\.", r"\1.\1_conv."),
    (r"\b(b\d)\.bn\.", r"\1.\1_bn."),
    (r"\bout\.(weight|bias)$", r"out_conv.\1"),
    (r"\.base\.lora_", ".lora_"),  # a LoRA adapter sits beside its base Dense
    (r"\bcl_mlp(\d)\.(fc\d|norm)\.", r"cl_mlp\1_\2."),
]


def flax_path(name: str) -> str:
    """The flax path ("a/b/leaf") of a port parameter of ``VQModel`` or a
    discriminator, as its converter reads it."""
    for pat, rep in _PATH_RULES:
        name = re.sub(pat, rep, name)
    parts = name.split(".")
    if parts[-1] == "weight":
        parent = parts[-2] if len(parts) > 1 else ""
        bn = parent.endswith("_bn") or re.fullmatch(r"bn\d+", parent)  # DinoDisc's, PatchGAN's
        parts[-1] = "scale" if "norm" in parent or bn else "kernel"
    return "/".join(parts)


def _map_linear(m: dict, key: str, path: str, bias: bool = True):
    m[f"{key}.weight"] = (f"{path}/kernel", True)
    if bias:
        m[f"{key}.bias"] = (f"{path}/bias", False)


def _map_ln(m: dict, key: str, path: str):
    m[f"{key}.weight"] = (f"{path}/scale", False)
    m[f"{key}.bias"] = (f"{path}/bias", False)


def var_key_map(cfg: VARConfig) -> Dict[str, Tuple[str, bool]]:
    """Each parameter of the port's VAR -> (its flax path "a/b/leaf", whether
    the flax array is the transpose: Dense kernels are (in, out))."""
    m: Dict[str, Tuple[str, bool]] = {}
    _map_linear(m, "word_embed", "word_embed")
    for key in ("class_emb", "lvl_embed"):
        m[f"{key}.weight"] = (key, False)
    m["pos_start"] = ("pos_start", False)
    m["pos_1LC"] = ("pos_1LC", False)
    _map_linear(m, "head_nm.ada_lin.1", "head_nm/ada_lin")
    _map_linear(m, "head", "head")
    if cfg.p_drop > 0:
        m["empty_emb.weight"] = ("empty_emb", False)
    if cfg.shared_aln:
        _map_linear(m, "shared_ada_lin.1", "shared_ada_lin")
    for i in range(cfg.depth):
        g, f = f"blocks.{i}.", f"block_{i}/"
        m[g + "attn.mat_qkv.weight"] = (f + "attn/mat_qkv/kernel", True)
        m[g + "attn.q_bias"] = (f + "attn/q_bias", False)
        m[g + "attn.v_bias"] = (f + "attn/v_bias", False)
        _map_linear(m, g + "attn.proj", f + "attn/proj")
        _map_linear(m, g + "ffn.fc1", f + "ffn/fc1")
        _map_linear(m, g + "ffn.fc2", f + "ffn/fc2")
        if cfg.attn_l2_norm:
            m[g + "attn.scale_mul_1H11"] = (f + "attn/scale_mul", False)
        if cfg.shared_aln:
            m[g + "ada_gss"] = (f + "ada_gss", False)
        else:
            _map_linear(m, g + "ada_lin.1", f + "ada_lin")
    return m


def _from_key_map(params: Mapping, key_map: Dict[str, Tuple[str, bool]]) -> dict:
    """flax params -> {name: fp32 CPU tensor} through a key map (port name
    -> (flax path, transposed))."""
    sd: dict = {}
    for key, (path, transposed) in key_map.items():
        leaf = params
        for part in path.split("/"):
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        sd[key] = leaf.T if transposed else leaf
    return to_torch(sd)


def var_state_dict_from_flax(params: Mapping, cfg: VARConfig) -> dict:
    """flax VAR params -> {name: fp32 CPU tensor} for the port's VAR."""
    return _from_key_map(params, var_key_map(cfg))


def rar_key_map(depth: int) -> Dict[str, Tuple[str, bool]]:
    """Each parameter of the port's RAR (the reference layout,
    ``BaseModel.save_pretrained_weight``, RAR/modules/base_model.py:52-81,
    that ``export_rar`` writes) -> (its flax path, transposed)."""
    m: Dict[str, Tuple[str, bool]] = {
        name: (name, False)
        for name in ("cls_token", "pos_embed", "target_aware_pos_embed", "timesteps_embeddings")}
    m["embeddings.weight"] = ("embeddings", False)
    _map_linear(m, "adaln_before_head.adaLN_modulation.1", "final_ada")
    _map_linear(m, "lm_head", "lm_head")
    for i in range(depth):
        g, f = f"blocks.{i}.", f"block_{i}/"
        _map_linear(m, g + "adaLN_modulation.1", f + "adaLN")
        _map_ln(m, g + "norm1", f + "norm1")
        _map_ln(m, g + "norm2", f + "norm2")
        for name in ("qkv", "proj"):
            _map_linear(m, f"{g}attn.{name}", f"{f}attn/{name}")
        for name in ("q_norm", "k_norm"):
            _map_ln(m, f"{g}attn.{name}", f"{f}attn/{name}")
        for name in ("fc1", "fc2"):
            _map_linear(m, f"{g}mlp.{name}", f + name)
    return m


def rar_state_dict_from_flax(params: Mapping) -> dict:
    """flax RAR params -> {name: fp32 CPU tensor} in the reference RAR layout,
    the layout ``export_rar`` writes, for the port's ``RAR``."""
    depth = sum(1 for key in params if key.startswith("block_"))
    return _from_key_map(params, rar_key_map(depth))


def maskgit_key_map(cfg: MaskGITConfig) -> Dict[str, Tuple[str, bool]]:
    """Each parameter of the port's MaskGIT -> (its flax path, transposed).
    ``uvit``: upstream UViTBert's layout, the inverse of
    ``imagefolder_tpu/utils/convert_torch.py::convert_maskgit_uvit``;
    ``bert``: the same block layout under ``blocks.{i}``, from the flax
    paths of the JAX package's ImageBert stack."""
    m: Dict[str, Tuple[str, bool]] = {"embeddings.weight": ("embeddings", False),
                                      "pos_embed": ("pos_embed", False)}
    _map_ln(m, "norm", "final_norm")
    _map_linear(m, "lm_head", "lm_head")
    uvit = cfg.arch == "uvit"

    def block(key: str, path: str, skip: bool = False):
        if skip:
            _map_linear(m, f"{key}.skip_linear", f"{path}/skip_linear")
        _map_ln(m, f"{key}.norm1", f"{path}/norm1")
        _map_ln(m, f"{key}.norm2", f"{path}/norm2")
        _map_linear(m, f"{key}.attn.qkv", f"{path}/qkv", bias=not uvit)
        _map_linear(m, f"{key}.attn.proj", f"{path}/proj")
        _map_linear(m, f"{key}.mlp.fc1", f"{path}/fc1")
        _map_linear(m, f"{key}.mlp.fc2", f"{path}/fc2")

    if uvit:
        for i in range(cfg.depth // 2):
            block(f"in_blocks.{i}", f"in_block_{i}")
        block("mid_block", "mid_block")
        for i in range(cfg.depth // 2):
            block(f"out_blocks.{i}", f"out_block_{i}", skip=True)
    else:
        for i in range(cfg.depth):
            block(f"blocks.{i}", f"block_{i}")
    return m


def maskgit_state_dict_from_flax(params: Mapping, cfg: MaskGITConfig) -> dict:
    """flax MaskGIT params -> {name: fp32 CPU tensor} for the port's
    ``MaskGIT`` of config ``cfg``, loaded with ``strict=True``."""
    return _from_key_map(params, maskgit_key_map(cfg))
