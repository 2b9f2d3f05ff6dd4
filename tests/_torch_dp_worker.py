"""Worker for the data-parallel test of the port's trainers
(test_torch_data_parallel.py).

Run as: python tests/_torch_dp_worker.py <host:port> <num_procs> <rank> <out_dir>

Each process joins a gloo group of ``num_procs`` (none for one process),
builds every case's trainer from the same seed, takes its own rows of the
case's global batch (rank r holds rows [r b, (r + 1) b)), runs one
``train_step`` with its generator seeded as every other process's, and
saves what the step left (parameters, their averaged gradients, Adam's
moments, the EMA, the usage and LeCam EMAs, the metrics) to
``<out_dir>/<case>_<num_procs>_<rank>.pt``. One process on the whole batch
and two processes on halves must leave the same state.
"""

import sys
from pathlib import Path

import numpy as np
import torch

TINY = "tiny_dp_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=1)
B = 4  # the global batch of every case


def _rows(x: np.ndarray, nproc: int, rank: int) -> torch.Tensor:
    b = x.shape[0] // nproc
    return torch.from_numpy(np.ascontiguousarray(x[rank * b:(rank + 1) * b]))


def _opt_state(prefix: str, opt) -> dict:
    out = {}
    for i, p in enumerate(opt.params):
        st = opt.opt.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out[f"{prefix}.{i}.{k}"] = st[k]
        if p.grad is not None:
            out[f"{prefix}.{i}.grad"] = p.grad
    return out


def _params(prefix: str, module) -> dict:
    return {f"{prefix}.{n}": p for n, p in module.state_dict().items()}


def _metrics(m: dict) -> dict:
    return {f"metric.{k}": v for k, v in m.items()}


def case_tokenizer(nproc, rank, lfq: bool):
    """The flagship GAN step at the tiny preset (DINOv2 semantic teacher,
    DinoDisc with LeCam and the adaptive weight, PQ2 over scales (1, 2) with
    half the global batch under quantizer dropout), or the MSBR (BSQ) YAML
    at the tiny preset with both its teachers off."""
    from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
    from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer
    from imagefolder_tpu_torch.utils.config import load_tokenizer_config

    px = 32
    margs_over = dict(encoder_model=TINY, decoder_model=TINY, codebook_size=16,
                      codebook_embed_dim=8, v_patch_nums=(1, 2), num_latent_tokens=4,
                      image_size=px, dtype_str="float32", codebook_drop=0.5, start_drop=1)
    tcfg_over = dict(image_size=px, dino_depth=2, steps_per_epoch=2, aug_prob=1.0)
    margs, tcfg = flagship_gan_recipe(B, margs_overrides=margs_over, tcfg_overrides=tcfg_over)
    if lfq:
        margs, tcfg, _ = load_tokenizer_config(
            str(Path(__file__).resolve().parents[1] / "configs" / "MSBR10P2-4096.yaml"),
            {"encoder_model": TINY, "decoder_model": TINY, "image_size": px,
             "num_latent_tokens": 4, "v_patch_nums": [1, 2], "codebook_embed_dim": 6,
             "codebook_size": 64, "semantic_guide": "none", "detail_guide": "none",
             "dtype_str": "float32", "codebook_drop": 0.5, "start_drop": 1})
        import dataclasses
        # PyYAML reads the YAML's 5e-5 as a string
        tcfg = dataclasses.replace(tcfg, image_size=px, dino_depth=2, steps_per_epoch=2,
                                   disc_start=0, epochs=1, loss_dtype="float32",
                                   weight_decay=float(tcfg.weight_decay),
                                   disc_weight_decay=float(tcfg.disc_weight_decay))
    tr = TokenizerTrainer(margs, tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(1).uniform(-1, 1, (B, px, px, 3)).astype(np.float32)
    m = tr.train_step(_rows(x, nproc, rank), epoch=0)
    out = {**_params("model", tr.model), **_params("disc", tr.disc),
           **_opt_state("gen_opt", tr.gen_opt), **_opt_state("disc_opt", tr.disc_opt),
           **{f"ema.{i}": e for i, e in enumerate(tr.ema_params)},
           "usage_ema": tr.usage_ema, "lecam.real": tr.lecam.logits_real_ema,
           "lecam.fake": tr.lecam.logits_fake_ema, **_metrics(m)}
    return out


def case_var(nproc, rank):
    """One ``VARTrainer`` step (EMA on) of VAR-d2 on a tiny multi-scale
    tokenizer's codes, with class dropout and drop path drawn."""
    from imagefolder_tpu_torch.models import build_vae_var
    from imagefolder_tpu_torch.models.tokenizer import ModelArgs
    from imagefolder_tpu_torch.train.var_train import VARTrainConfig, VARTrainer

    margs = ModelArgs(encoder_model=TINY, decoder_model=TINY, codebook_size=16,
                      codebook_embed_dim=8, v_patch_nums=(1, 2), num_latent_tokens=4,
                      product_quant=2, image_size=32, semantic_guide="none",
                      detail_guide="none", enc_type="dinov2", dec_type="dinov2",
                      abs_pos_embed=True, dtype_str="float32")
    vae, var = build_vae_var(margs, depth=2, num_classes=10,
                             generator=torch.Generator().manual_seed(0), device="cpu")
    tr = VARTrainer(vae, var, VARTrainConfig(warmup_steps=2, total_steps=10, ema=True),
                    generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (B,))
    m = tr.train_step(_rows(x, nproc, rank), _rows(y, nproc, rank))
    return {**_params("model", tr.var), **_params("ema", tr.ema_var),
            **_opt_state("opt", tr.opt), **_metrics(m)}


def case_rar(nproc, rank):
    """One ``RARTrainer`` step of a tiny RAR (width 64, 2 blocks) with the
    condition drop and random orders drawn."""
    from imagefolder_tpu_torch.models import build_rar
    from imagefolder_tpu_torch.train.rar_train import RARTrainConfig, RARTrainer

    rar = build_rar(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=2, num_classes=10,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tr = RARTrainer(rar, RARTrainConfig(warmup_steps=2, total_steps=10,
                                        class_label_dropout=0.5))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 32, (B, 16))
    y = rng.integers(0, 10, (B,))
    m = tr.train_step(_rows(toks, nproc, rank), _rows(y, nproc, rank), 0.5,
                      torch.Generator().manual_seed(4))
    return {**_params("model", tr.rar), **{f"ema.{i}": e for i, e in enumerate(tr.ema)},
            **_opt_state("opt", tr.opt), **_metrics(m)}


def case_maskgit(nproc, rank):
    """One ``MaskGITTrainer`` step of a tiny MaskGIT (bert trunk, width 64,
    2 blocks): the masking and the condition drop drawn."""
    from imagefolder_tpu_torch.models import build_maskgit
    from imagefolder_tpu_torch.train.rar_train import MaskGITTrainer

    model = build_maskgit(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=2,
                          num_classes=10, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tr = MaskGITTrainer(model, 20)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 32, (B, 16))
    y = rng.integers(0, 10, (B,))
    m = tr.train_step(_rows(toks, nproc, rank), _rows(y, nproc, rank),
                      torch.Generator().manual_seed(6))
    return {**_params("model", tr.model), **_opt_state("opt", tr.opt), **_metrics(m)}


CASES = {"tokenizer": lambda n, r: case_tokenizer(n, r, False),
         "tokenizer_bsq": lambda n, r: case_tokenizer(n, r, True),
         "var": case_var, "rar": case_rar, "maskgit": case_maskgit}


def main():
    coordinator, nproc, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from imagefolder_tpu_torch.models import vit
    from imagefolder_tpu_torch.parallel import dist

    vit.VIT_PRESETS[TINY] = TINY_PRESET
    if nproc > 1:
        assert dist.init_distributed(coordinator, nproc, rank, device="cpu")
    for name, case in CASES.items():
        state = {k: v.detach().clone() for k, v in case(nproc, rank).items()}
        torch.save(state, Path(out) / f"{name}_{nproc}_{rank}.pt")
    dist.sync_global_devices("done")
    print("dp ok")


if __name__ == "__main__":
    main()
