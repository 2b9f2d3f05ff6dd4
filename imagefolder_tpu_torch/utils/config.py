"""The tokenizer config loader (counterpart of ``imagefolder_tpu/utils/
config.py``): the reference YAML schema (``configs/*.yaml``) plus dotted CLI
overrides -> the port's (ModelArgs, TokenizerTrainConfig, RunConfig), with
the same key routing and derived fields: the ``vq_model`` channel
multipliers, ``delta`` -> ``perturb_delta_max``, ``mixed_precision`` ->
``dtype_str`` and ``loss_dtype``, and the lr scaled by global batch / 128.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import yaml

from imagefolder_tpu_torch.models.tokenizer import ModelArgs
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainConfig

__all__ = ["RunConfig", "load_tokenizer_config", "parse_overrides"]


@dataclasses.dataclass
class RunConfig:
    """Run-level knobs (paths, cadence, RobustTok annealing) from the
    reference YAML keys not owned by the model/trainer configs."""

    data_path: str = ""
    val_data_path: str = ""
    cloud_save_path: str = "output/exp"
    save_best: bool = True
    ckpt_every: int = 10000
    log_every: int = 100
    vis_every: int = 5000
    epochs: int = 200
    global_batch_size: int = 1024
    vq_model: str = "VQ-16"
    disc_epoch_start: int = 56
    aug_fade_steps: int = 0
    disc_reinit: int = 0
    # RobustTok perturbation annealing (RobustTok.yaml)
    anneal_start: int = 0
    anneal_end: int = 0
    end_ratio: float = 0.5
    alpha: float = 0.0
    beta: float = 0.0
    delta: int = 0
    seed: int = 0
    mixed_precision: str = "bf16"


_CH_MULTS = {"VQ-16": (1, 1, 2, 2, 4), "VQ-8": (1, 2, 2, 4)}

# YAML key -> (target, field)
_MODEL_KEYS = {
    "encoder_ch_mult", "decoder_ch_mult",
    "codebook_size", "codebook_embed_dim", "codebook_l2_norm",
    "commit_loss_beta", "entropy_loss_ratio", "z_channels", "v_patch_nums",
    "enc_type", "dec_type", "semantic_guide", "detail_guide",
    "num_latent_tokens", "encoder_model", "decoder_model", "abs_pos_embed",
    "share_quant_resi", "product_quant", "codebook_drop", "half_sem",
    "start_drop", "sem_loss_weight", "detail_loss_weight", "clip_norm",
    "sem_loss_scale", "detail_loss_scale", "guide_type_1", "guide_type_2",
    "lfq", "scale", "soft_entropy", "dependency_loss_weight", "image_size",
    "enc_tuning_method", "dec_tuning_method", "lora_rank", "dtype_str",
    "remat",
}
_TRAIN_KEYS = {
    "lr", "disc_lr", "epochs", "lr_scheduler", "weight_decay",
    "disc_weight_decay", "max_grad_norm", "disc_type", "disc_adaptive_weight",
    "lecam_loss_weight", "ema", "global_batch_size", "image_size",
    "rec_weight", "perceptual_weight", "codebook_weight", "disc_weight",
    "disc_loss", "gen_loss", "aug_prob",
}
_RUN_KEYS = {f.name for f in dataclasses.fields(RunConfig)}


def parse_overrides(argv: Sequence[str]) -> Dict[str, Any]:
    """'key=value' dotted CLI overrides (OmegaConf-style)."""
    out: Dict[str, Any] = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"override must be key=value: {a!r}")
        k, v = a.split("=", 1)
        out[k.strip()] = yaml.safe_load(v)
    return out


def load_tokenizer_config(
    path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None
):
    """Read a reference-format YAML and return (ModelArgs,
    TokenizerTrainConfig, RunConfig)."""
    raw: Dict[str, Any] = {}
    if path:
        raw.update(yaml.safe_load(Path(path).read_text()) or {})
    raw.update(overrides or {})
    # normalize key case (reference YAMLs mix True/true already via yaml)
    model_kwargs: Dict[str, Any] = {}
    train_kwargs: Dict[str, Any] = {}
    run_kwargs: Dict[str, Any] = {}
    unknown = []
    for k, v in raw.items():
        hit = False
        if k in _MODEL_KEYS:
            model_kwargs[k] = tuple(v) if isinstance(v, list) else v
            hit = True
        if k in _TRAIN_KEYS:
            train_kwargs[k] = v
            hit = True
        if k in _RUN_KEYS:
            run_kwargs[k] = v
            hit = True
        if not hit:
            unknown.append(k)

    run = RunConfig(**run_kwargs)
    if run.vq_model in _CH_MULTS and "encoder_ch_mult" not in model_kwargs:
        model_kwargs["encoder_ch_mult"] = _CH_MULTS[run.vq_model]
        model_kwargs["decoder_ch_mult"] = _CH_MULTS[run.vq_model]
    if run.delta > 0:
        model_kwargs.setdefault("perturb_delta_max", int(run.delta))
    # mixed_precision (reference --mixed-precision, default bf16: the whole
    # generator/disc pass runs under autocast(bf16), xqgan_train.py:419,449)
    # maps to the activation dtype; params stay fp32 either way. fp16 maps
    # to bf16, which needs no GradScaler: it has fp32's exponent range.
    mp_dtype = {
        "bf16": "bfloat16", "fp16": "bfloat16", "none": "float32",
    }.get(str(run.mixed_precision), "float32")
    if "dtype_str" not in model_kwargs:
        model_kwargs["dtype_str"] = mp_dtype
    # the reference autocast also covers the VQLoss stack (LPIPS + disc
    # trunk, xqgan_train.py:449,467) — mirror it in the loss compute dtype
    train_kwargs.setdefault("loss_dtype", mp_dtype)
    margs = ModelArgs(**model_kwargs)

    train_kwargs.setdefault("disc_lr", train_kwargs.get("lr", 1e-4))
    # reference scales lr by global_batch/128 (xqgan_train.py:338-339)
    gbs = train_kwargs.get("global_batch_size", run.global_batch_size)
    for key in ("lr", "disc_lr"):
        if key in train_kwargs:
            train_kwargs[key] = float(train_kwargs[key]) * gbs / 128.0
    train_kwargs.pop("global_batch_size", None)
    tcfg = TokenizerTrainConfig(**train_kwargs)
    if unknown:
        print(f"[config] ignoring unknown keys: {sorted(unknown)}")
    return margs, tcfg, run
