"""Tokenizer (XQ-GAN) training CLI (counterpart of
``scripts/train_tokenizer.py``; reference
``tokenizer/tokenizer_image/xqgan_train.py``).

Usage:
    python -m imagefolder_tpu_torch.scripts.train_tokenizer \
        --config configs/RobustTok.yaml data_path=<dir> val_data_path=<dir> \
        cloud_save_path=<dir> [key=value overrides ...] [--device cpu]

One YAML schema (the reference's keys), one ``TokenizerTrainer.train_step``
a batch, the ImageFolder loader with exact-resume state, checkpoints with
the best kept by a validation metric, and RobustTok's annealing of the
perturbation by epoch. Validation runs on the live parameters, not the EMA
(the reference's ``vq_model.module``): with ``--inception_ckpt`` (a
pytorch-fid checkpoint) the val split's rFID under the uint8 clamp protocol
gates the best checkpoint (``xqgan_train.py:516-569``), without it the mean
PSNR. A per-scale recon grid goes to ``<cloud_save_path>/vis`` (and
tensorboard or wandb where installed) every ``vis_every`` steps.

Every step runs on ``--device`` (the card by default; a run asked to use
the card on a machine without one stops). ``main`` returns the trainer and
each step's schedule values and metrics for a caller in the same process.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.data.imagenet import device_prefetch, list_image_folder, make_dataloader
from imagefolder_tpu_torch.eval.inception import load_inception, uint8_feature_fn
from imagefolder_tpu_torch.eval.validation import tokenizer_val_psnr, tokenizer_val_rfid
from imagefolder_tpu_torch.parallel.dist import (
    add_distributed_args,
    init_from_args,
    is_primary,
    process_count,
    process_index,
)
from imagefolder_tpu_torch.scripts._cli import resolve_device
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer, get_random_ratio
from imagefolder_tpu_torch.utils.ckpt import CheckpointManager
from imagefolder_tpu_torch.utils.config import load_tokenizer_config, parse_overrides
from imagefolder_tpu_torch.utils.logging import (
    MetricLogger,
    Tracker,
    create_logger,
    flatten_metrics,
    profile_trace,
)
from imagefolder_tpu_torch.utils.viz import save_png, scale_recon_grid

__all__ = ["main", "fade_blur", "validate"]


def fade_blur(step: int, disc_start: int, aug_fade_steps: int) -> float:
    """DiffAug's blur fade (the JAX CLI's): 1 until the discriminator
    starts, then down to 0 over ``aug_fade_steps + 1`` steps, rounded to 3
    places; 0 throughout when ``aug_fade_steps`` < 0."""
    if aug_fade_steps < 0:
        return 0.0
    fade = 0 if step < disc_start else min(1.0, (step - disc_start) / (aug_fade_steps + 1))
    return round(1 - fade, 3)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.train_tokenizer")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--inception_ckpt", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--profile_steps", type=int, default=0,
                    help="a torch.profiler trace of N steps from step 2")
    ap.add_argument("--val_batch_size", type=int, default=32,
                    help="per-process val batch for the rFID/PSNR loop")
    ap.add_argument("--val_batches", type=int, default=0,
                    help="cap on val batches (0: the whole val split, the reference protocol)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("overrides", nargs="*")
    return add_distributed_args(ap)


def _numpy_batch_fn(fn, device: torch.device):
    """``fn`` of an image tensor on ``device``, called on a numpy batch,
    without gradients."""
    def run(model, x):
        with torch.no_grad():
            return fn(model, torch.as_tensor(np.asarray(x), device=device))
    return run


def validate(trainer: TokenizerTrainer, run, margs, logger, device, feat_fn=None,
             val_batch: int = 32, max_batches: Optional[int] = None, gt_cache=None):
    """The val split's rFID (xqgan_train.py:516-567, uint8 clamp protocol)
    with Inception, its mean PSNR without; the live parameters. Returns
    (metric name, value, objective), lower objective better."""
    loader = make_dataloader(run.val_data_path, val_batch, margs.image_size, train=False,
                             num_epochs=1, drop_remainder=process_count() > 1,
                             shard_index=process_index(), shard_count=process_count())
    rec_fn = _numpy_batch_fn(lambda m, x: m.img_to_reconstructed_img(x).float(), device)
    if feat_fn is not None:
        fid = tokenizer_val_rfid(rec_fn, trainer.model, loader, feat_fn, val_batch,
                                 max_batches, log=logger.info, gt_cache=gt_cache)
        logger.info(f"val rFID: {fid:.4f}")
        return "val_rfid", fid, fid
    m = tokenizer_val_psnr(rec_fn, trainer.model, loader, val_batch, max_batches)
    logger.info(f"val PSNR: {m:.3f} (no --inception_ckpt: PSNR gates best-ckpt)")
    return "val_psnr", m, -m


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)

    margs, tcfg, run = load_tokenizer_config(args.config, parse_overrides(args.overrides))
    logger = create_logger(run.cloud_save_path)
    logger.info(f"model: {margs}")
    logger.info(f"train: {tcfg}")

    batch = run.global_batch_size
    if batch % process_count():
        raise ValueError(f"global_batch_size {batch} is not a multiple of the "
                         f"{process_count()} processes")
    loader = make_dataloader(run.data_path, batch // process_count(), margs.image_size,
                             train=True, seed=run.seed, shard_index=process_index(),
                             shard_count=process_count())
    n_train = len(list_image_folder(run.data_path)[0])
    tcfg.steps_per_epoch = max(n_train // batch, 1)
    tcfg.disc_start = run.disc_epoch_start * tcfg.steps_per_epoch
    tcfg.epochs = run.epochs

    trainer = TokenizerTrainer(margs, tcfg, generator=torch.Generator().manual_seed(run.seed),
                               device=dev)
    ckpt = CheckpointManager(run.cloud_save_path)
    start_step = 0
    if args.resume:
        restored, start_step = ckpt.restore()
        if restored is not None:
            trainer.load_state_dict(restored)
            logger.info(f"resumed from step {start_step}")

    tracker = Tracker(use_wandb=args.wandb, log_dir=run.cloud_save_path, use_tb=True)
    mlog = MetricLogger(logger, run.log_every)
    total_steps = tcfg.epochs * tcfg.steps_per_epoch
    feat_fn = None
    if args.inception_ckpt:
        feat_fn = uint8_feature_fn(load_inception(args.inception_ckpt, device=dev), dev)
        logger.info(f"val rFID enabled (Inception: {args.inception_ckpt})")

    step = start_step
    val_gt_cache: dict = {}  # the ground truth's Inception statistics, once a run
    history, vals = [], []
    data_raw = iter(loader)
    if start_step and ckpt.apply_data_state(start_step, data_raw, log=logger.info):
        logger.info("restored data-stream state (exact batch-order resume)")
    data_it = device_prefetch(data_raw, device=dev)
    profiling = contextlib.ExitStack()
    t0 = time.time()
    metrics: dict = {}
    for epoch in range(start_step // tcfg.steps_per_epoch, run.epochs):
        ratio = get_random_ratio(run.anneal_start, run.anneal_end, run.end_ratio, epoch)
        alpha = run.alpha * ratio
        # at the epoch's first step only: a run resumed mid-epoch keeps the
        # heads it saved, so that it continues as the straight run does
        if run.disc_reinit and epoch and epoch % run.disc_reinit == 0 \
                and step == epoch * tcfg.steps_per_epoch:
            trainer.reinit_disc_heads(torch.Generator().manual_seed(
                run.seed * 1_000_003 + 10_000_000 + epoch))
            logger.info(f"discriminator heads re-initialized at epoch {epoch}")
        for _ in range(step - epoch * tcfg.steps_per_epoch, tcfg.steps_per_epoch):
            try:
                b = next(data_it)
            except StopIteration:
                data_it = device_prefetch(iter(loader), device=dev)
                b = next(data_it)
            fade = fade_blur(step, tcfg.disc_start, run.aug_fade_steps)
            if args.profile_steps and step == 2:
                profiling.enter_context(profile_trace(f"{run.cloud_save_path}/profile"))
            metrics = trainer.train_step(b["image"], epoch=epoch, alpha=alpha, beta=run.beta,
                                         delta_ratio=ratio, fade_blur=fade)
            if args.profile_steps and step == 1 + args.profile_steps:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                profiling.close()
            history.append(dict(step=step, epoch=epoch, alpha=alpha, beta=run.beta,
                                delta_ratio=ratio, fade_blur=fade, disc_start=tcfg.disc_start))
            step += 1
            if step % run.log_every == 0:
                host = flatten_metrics(metrics)
                mlog.update(**{k: v for k, v in host.items() if "/" not in k})
                mlog.log(step, total_steps)
                tracker.log(host, step)
            if run.vis_every and step % run.vis_every == 0 and is_primary():
                # per-scale recon grid (xqgan_train.py:504-513)
                x4 = b["image"][:4]
                with torch.no_grad():
                    recons = trainer.model.img_to_reconstructed_img(x4, last_one=False)
                grid = scale_recon_grid(x4, recons)
                save_png(grid, Path(run.cloud_save_path) / "vis" / f"recon_{step:07d}.png")
                tracker.log_image("recon_images", grid, step)
            if step % run.ckpt_every == 0:
                ckpt.save(step, trainer.state_dict())
                ckpt.save_data_state(step, data_it.state)
                if run.save_best and run.val_data_path:
                    name, value, objective = validate(
                        trainer, run, margs, logger, dev, feat_fn,
                        val_batch=args.val_batch_size, max_batches=args.val_batches or None,
                        gt_cache=val_gt_cache)
                    vals.append((step, name, value))
                    tracker.log({name: value}, step)
                    ckpt.save_best(trainer.state_dict(), objective)
    profiling.close()
    ckpt.save(step, trainer.state_dict())
    ckpt.wait()
    tracker.close()
    logger.info(f"done in {(time.time() - t0) / 3600:.2f}h, {step} steps")
    return {"trainer": trainer, "step": step, "history": history, "metrics": metrics,
            "val": vals, "ckpt": ckpt}


if __name__ == "__main__":
    main()
