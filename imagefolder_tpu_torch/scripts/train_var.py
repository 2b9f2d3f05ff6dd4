"""VAR generator training CLI (counterpart of ``scripts/train_var.py``;
reference ``train.py``): the frozen multi-scale tokenizer's codes, VAR's
teacher-forced CE over the pyramid.

Usage:
    python -m imagefolder_tpu_torch.scripts.train_var --config configs/MSVR10P2-4096.yaml \
        --vq_ckpt <tokenizer checkpoint or weight file> --depth 16 [--device cpu]

The data and val splits are the YAML's ``data_path`` and ``val_data_path``
(``--val_data_path`` overrides the latter). lr = ``--tblr`` * batch / 256,
on the ``lin0`` schedule, or ``lin{pg}`` with progressive training
(``--pg``: ``ProgressiveController`` from stage ``--pg0`` with
``--pgwp`` epochs of warm-up a stage, arg_util.py:309-312), warmed up over
the first epoch. Every ``--eval_every`` steps (default 10 epochs,
train.py:230) and at the end: ``var_eval_ep`` over the val split (val CE
and accuracy, mean and tail, trainer.py:58-101), an 8-class CFG preview
(cfg 5, top-k 900, top-p 0.95, trainer.py:85-93) to
``<output>/preview/gen_<step>.png``, and ``best.pt`` by ``val_L_tail``
(train.py:249-261). A checkpoint every ``--ckpt_every`` steps holds the
trainer (``VARTrainer.state_dict``), the loader's state and the
progressive controller's (aux), from which a rerun of the same command
resumes exactly.

Draws: VAR is drawn from the YAML's seed (``torch.Generator``), and step s
draws its training masks from a generator seeded from (seed, s) on the
device (``_cli.step_generator``: the JAX script's ``fold_in(key, step)``;
the streams differ from ``jax.random``'s). The preview draws from seed 0.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.parallel.dist import (
    add_distributed_args,
    init_from_args,
    is_primary,
    process_count,
    process_index,
)
from imagefolder_tpu_torch.scripts._cli import (
    checkpoint_weights,
    resolve_device,
    step_generator,
)

__all__ = ["main", "build_schedule"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.train_var")
    ap.add_argument("--config", required=True)
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--tblr", type=float, default=1e-4,
                    help="base lr per 256 batch (reference arg_util tblr)")
    ap.add_argument("--pg", type=float, default=0.0,
                    help="progressive training over [0%%, pg] of the run "
                         "(reference arg_util pg; also forces sche=lin{pg})")
    ap.add_argument("--pg0", type=int, default=4,
                    help="initial progressive stage (reference pg0)")
    ap.add_argument("--pgwp", type=float, default=0.0,
                    help="warmup epochs per progressive stage (reference "
                         "pgwp; 0 -> epochs/300)")
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--output", default="output/var")
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--ckpt_every", type=int, default=5000)
    ap.add_argument("--val_data_path", default=None,
                    help="val split (defaults to the config's val_data_path)")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="steps between eval_ep + preview + best-ckpt "
                         "(0 -> every 10 epochs, reference train.py:230)")
    ap.add_argument("--val_batches", type=int, default=0,
                    help="cap eval_ep batches (0 = full val split)")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    return add_distributed_args(ap)


def build_schedule(args, num_scales: int, n_train: int):
    """(VARTrainConfig, ProgressiveController, steps per epoch) of the JAX
    script: lr = tblr * batch / 256, warm-up over one epoch, ``lin{pg}``
    when pg > 0 (arg_util.py:311-312), the controller's per-stage warm-up
    ``pgwp`` (or epochs / 300) epochs."""
    from imagefolder_tpu_torch.train.var_train import ProgressiveController, VARTrainConfig

    steps_per_epoch = max(n_train // args.batch_size, 1)
    total = args.epochs * steps_per_epoch
    sched = f"lin{args.pg:g}" if args.pg > 0 else VARTrainConfig.sched
    tcfg = VARTrainConfig(lr=args.tblr * args.batch_size / 256.0, sched=sched,
                          warmup_steps=steps_per_epoch, total_steps=total)
    pgwp = args.pgwp or args.epochs / 300.0
    prog = ProgressiveController(num_scales, pg=args.pg, pg0=args.pg0,
                                 prog_wp_it=pgwp * steps_per_epoch)
    return tcfg, prog, steps_per_epoch


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"trainer", "prog", "tcfg", "step", "metrics" (the last
    step's), "evals" ((step, var_eval_ep's dict) each), "previews",
    "ckpt"}."""
    from imagefolder_tpu_torch.data.imagenet import (
        device_prefetch,
        list_image_folder,
        make_dataloader,
    )
    from imagefolder_tpu_torch.eval.validation import var_eval_ep
    from imagefolder_tpu_torch.models import build_vae_var
    from imagefolder_tpu_torch.train.var_train import VARTrainer, var_sample
    from imagefolder_tpu_torch.utils.ckpt import CheckpointManager
    from imagefolder_tpu_torch.utils.config import load_tokenizer_config
    from imagefolder_tpu_torch.utils.logging import MetricLogger, Tracker, create_logger
    from imagefolder_tpu_torch.utils.viz import generation_grid, save_png

    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)
    logger = create_logger(args.output)
    margs, _, run = load_tokenizer_config(args.config)
    vae, var = build_vae_var(margs, depth=args.depth, num_classes=args.num_classes,
                             dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(run.seed), device=dev)
    vae.load_state_dict(checkpoint_weights(args.vq_ckpt), strict=True)

    n_train = len(list_image_folder(run.data_path)[0])
    tcfg, prog, steps_per_epoch = build_schedule(args, len(margs.v_patch_nums), n_train)
    total = tcfg.total_steps
    trainer = VARTrainer(vae, var, tcfg)
    ckpt = CheckpointManager(args.output)
    restored, start = ckpt.restore()
    if restored is not None:
        trainer.load_state_dict(restored)
        logger.info(f"resumed at step {start}")
        aux = ckpt.restore_aux(start)
        if aux and "prog" in aux:
            # mid-stage warmup counters survive the restart (the reference
            # keeps prog_it/last_prog_si in trainer.state_dict)
            prog.load_state_dict(aux["prog"])
            logger.info("restored progressive-training state")

    if args.batch_size % process_count():
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of the "
                         f"{process_count()} processes")
    local_bs = args.batch_size // process_count()
    loader = make_dataloader(run.data_path, local_bs, margs.image_size, train=True,
                             seed=run.seed, shard_index=process_index(),
                             shard_count=process_count())
    mlog = MetricLogger(logger, args.log_every)
    tracker = Tracker(use_wandb=args.wandb, log_dir=args.output, use_tb=True)
    val_path = args.val_data_path if args.val_data_path is not None else run.val_data_path
    eval_every = args.eval_every or 10 * steps_per_epoch
    val_bs = min(local_bs, 32)
    evals, previews = [], []

    def run_eval(step: int) -> dict:
        """eval_ep, the CFG preview, best by val loss tail (train.py:230-261)."""
        vloader = make_dataloader(val_path, val_bs, margs.image_size, train=False,
                                  num_epochs=1, drop_remainder=process_count() > 1,
                                  shard_index=process_index(), shard_count=process_count())

        def eval_step(x, y):
            return trainer.eval_step(torch.as_tensor(x, device=dev),
                                     torch.as_tensor(y, dtype=torch.long, device=dev))

        ev = var_eval_ep(eval_step, vloader, val_bs, args.val_batches or None)
        logger.info(f"[eval step {step}] (val {ev['val_tot']}) "
                    f"Lm: {ev['val_L_mean']:.4f}, Lt: {ev['val_L_tail']:.4f}, "
                    f"Acc m&t: {ev['val_acc_mean']:.2f} {ev['val_acc_tail']:.2f}")
        tracker.log({k: v for k, v in ev.items() if k != "val_tot"}, step)
        if is_primary():
            lbls = torch.from_numpy(np.random.default_rng(0).choice(args.num_classes, 8)
                                    .astype(np.int64)).to(dev)
            imgs01 = var_sample(var, vae, lbls, torch.Generator(device=dev).manual_seed(0),
                                cfg_scale=5.0, top_k=900, top_p=0.95)
            grid = generation_grid(imgs01.float().cpu().numpy() * 2.0 - 1.0, ncol=8)
            out = Path(args.output) / "preview" / f"gen_{step:07d}.png"
            save_png(grid, out)
            tracker.log_image("generated_images", grid, step)
            previews.append(out)
        ckpt.save_best(trainer.state_dict(), ev["val_L_tail"])
        evals.append((step, ev))
        return ev

    raw = iter(loader)
    if start and ckpt.apply_data_state(start, raw, log=logger.info):
        logger.info("restored data-stream state")
    it = device_prefetch(raw, device=dev)
    metrics: dict = {}
    for step in range(start, total):
        try:
            b = next(it)
        except StopIteration:
            it = device_prefetch(iter(loader), device=dev)
            b = next(it)
        prog_si, prog_wp = prog.step(prog.stage(step, tcfg.warmup_steps, total))
        trainer.generator = step_generator(dev, run.seed, step)
        metrics = trainer.train_step(b["image"], b["label"].long(), prog_si=prog_si,
                                     prog_wp=prog_wp)
        if (step + 1) % args.log_every == 0:
            host = {k: float(v) for k, v in metrics.items()}
            mlog.update(**host)
            mlog.log(step + 1, total)
            tracker.log(host, step + 1)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, trainer.state_dict())
            ckpt.save_data_state(step + 1, it.state)
            ckpt.save_aux(step + 1, {"prog": prog.state_dict()})
        if val_path and (step + 1) % eval_every == 0:
            run_eval(step + 1)
    ckpt.save(total, trainer.state_dict())
    # the final epoch's eval (reference `or (ep+1) == args.ep`, train.py:230)
    if val_path and total > start and total % eval_every != 0:
        run_eval(total)
    ckpt.wait()
    tracker.close()
    return {"trainer": trainer, "prog": prog, "tcfg": tcfg, "step": total, "metrics": metrics,
            "evals": evals, "previews": previews, "ckpt": ckpt}


if __name__ == "__main__":
    main()
