"""RAR / MaskGIT generator training CLI (counterpart of
``scripts/train_rar.py``; reference ``scripts/train_rar.py`` and
``utils/train_utils.py:641``, model_type rar|maskgit).

Usage:
    python -m imagefolder_tpu_torch.scripts.train_rar --jsonl pretokenized.jsonl \
        [--model rar|maskgit] [--config <tokenizer yaml> --vq_ckpt <file>] [--device cpu]
    python -m imagefolder_tpu_torch.scripts.train_rar --config configs/RobustTok.yaml \
        --vq_ckpt <file> --data_path /data/train --model maskgit

The fast path reads ``pretokenize``'s JSONL (``JsonlTokens``: an
epoch-seeded permutation, strided by process, with exact-resume state);
with ``--config``, ``--vq_ckpt`` and ``--data_path`` instead the frozen
tokenizer encodes the ImageFolder batches on the fly (train_utils.py:
676-686). Every ``--generate_every`` steps the EMA weights (MaskGIT: the
live ones) sample an 8-image class grid, decoded by the tokenizer to a PNG
under ``<output>/train_generated_images/`` (train_utils.py:769-794,
914-951); previews need ``--config`` and ``--vq_ckpt``.

RAR: ``RARTrainer`` on ``build_rar`` (bf16 activations), its warm-up over a
quarter of the run and its randomness annealed to 0 at half; a checkpoint
every ``--ckpt_every`` steps with the token stream's state, from which a
rerun of the same command resumes exactly. MaskGIT: ``MaskGITTrainer`` with
``--maskgit_arch``; its checkpoints are written and never read back, as in
the JAX script.

Draws: the models are drawn from seed 0 (``torch.Generator``, where the JAX
script draws from ``PRNGKey(0)``), and step s draws from a generator seeded
from (0, s) on the device (``_cli.step_generator``, the JAX script's
``fold_in(key, step)``); the previews from seed ``step``. The streams
differ from ``jax.random``'s; each is the same on every process, where it
draws for the global batch (``parallel/dist.py``).
"""

from __future__ import annotations

import argparse
import copy
import json
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
from imagefolder_tpu_torch.scripts._cli import load_tokenizer, resolve_device, step_generator

__all__ = ["main", "JsonlTokens"]


class JsonlTokens:
    """Pretokenized JSONL reader (reference PretoeknizedDataSetJSONL,
    data/webdataset_reader.py:253); a copy of the JAX script's."""

    def __init__(self, path):
        self.rows = [json.loads(line) for line in open(path)]

    def __len__(self):
        return len(self.rows)

    def batches(self, batch_size, seed=0, shard_index=0, shard_count=1):
        return _JsonlBatchIter(self.rows, batch_size, seed, shard_index, shard_count)


class _JsonlBatchIter:
    """Infinite epoch-seeded-permutation batch stream with exact-resume
    state (reference DistInfiniteBatchSampler.start_ep/start_it,
    utils/data_sampler.py:67-103): the epoch's global permutation from
    ``numpy.random.default_rng((seed, epoch))``, this process's strided
    slice of it, (epoch, cursor) checkpointable via get_state/set_state."""

    def __init__(self, rows, batch_size, seed=0, shard_index=0, shard_count=1):
        if len(rows) // max(shard_count, 1) < batch_size:
            raise ValueError(
                f"per-shard rows ({len(rows)}//{shard_count}) < batch_size "
                f"({batch_size}): the epoch permutation can never fill one "
                "batch — shrink --batch_size or the process count")
        self.rows = rows
        self.batch_size = batch_size
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0
        self.cursor = 0
        self._idx = None

    def _epoch_idx(self):
        if self._idx is None:
            rng = np.random.default_rng((self.seed, self.epoch))
            self._idx = rng.permutation(len(self.rows))[self.shard_index::self.shard_count]
        return self._idx

    def __iter__(self):
        return self

    def __next__(self):
        idx = self._epoch_idx()
        if self.cursor + self.batch_size > len(idx):
            self.epoch += 1
            self.cursor = 0
            self._idx = None
            idx = self._epoch_idx()
        rows = [self.rows[j] for j in idx[self.cursor:self.cursor + self.batch_size]]
        self.cursor += self.batch_size
        return (np.asarray([r["tokens"] for r in rows], np.int32),
                np.asarray([r["class_id"] for r in rows], np.int32))

    def get_state(self) -> bytes:
        return json.dumps({"epoch": self.epoch, "cursor": self.cursor}).encode()

    def set_state(self, blob: bytes):
        st = json.loads(bytes(blob).decode())
        self.epoch, self.cursor = st["epoch"], st["cursor"]
        self._idx = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.train_rar")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--config", default=None, help="tokenizer yaml (on-the-fly)")
    ap.add_argument("--vq_ckpt", default=None)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--model", choices=["rar", "maskgit"], default="rar")
    ap.add_argument("--maskgit_arch", choices=["bert", "uvit"], default="bert",
                    help="MaskGIT trunk: ImageBert or UViTBert (RAR/maskgit.py:209)")
    ap.add_argument("--output", default="output/rar")
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--codebook_size", type=int, default=4096)
    ap.add_argument("--num_classes", type=int, default=1000,
                    help="condition_num_classes (robustTok-rar.yaml)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--total_steps", type=int, default=250_000)
    ap.add_argument("--ckpt_every", type=int, default=10_000)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--generate_every", type=int, default=0,
                    help="steps between EMA preview grids (0 = off; "
                         "reference experiment.generate_every)")
    ap.add_argument("--guidance_scale", type=float, default=3.0)
    ap.add_argument("--guidance_scale_pow", type=float, default=2.75)
    ap.add_argument("--temperature", type=float, default=2.0,
                    help="randomize_temperature for previews (train_utils.py:925)")
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    return add_distributed_args(ap)


def _online_tokens(args, tok, local_bs: int, dev: torch.device):
    """On-the-fly tokenization stream (train_utils.py:676-686): the
    ImageFolder loader's batches encoded by the frozen tokenizer, epoch
    after epoch. Returns (stream of (tokens, labels) host arrays, seq_len,
    codebook_size)."""
    from imagefolder_tpu_torch.data.imagenet import make_dataloader

    model, margs = tok[0], tok[1]
    seq_len = margs.num_latent_tokens * margs.product_quant

    def gen():
        loader = make_dataloader(args.data_path, local_bs, margs.image_size, train=True,
                                 shard_index=process_index(), shard_count=process_count())
        while True:
            for b in loader:
                with torch.no_grad():
                    toks = model.encode_to_tokens(b["image"].to(dev))
                yield toks.cpu().numpy(), np.asarray(b["label"])

    return gen(), seq_len, margs.codebook_size


def _preview(gen_fn, tok, model, args, step: int, tracker, logger) -> Optional[Path]:
    """An 8-image preview grid (reference generate_images,
    utils/train_utils.py:914-951): the labels of ``default_rng(0)``,
    ``gen_fn(model, labels, generator)`` with a generator seeded ``step``,
    decoded by the tokenizer, saved as a PNG and logged; process 0 only."""
    from imagefolder_tpu_torch.utils.viz import generation_grid, save_png

    if not is_primary():
        return None
    vae = tok[0]
    dev = next(model.parameters()).device
    lbls = torch.from_numpy(np.random.default_rng(0).choice(args.num_classes, 8)
                            .astype(np.int64)).to(dev)
    with torch.no_grad():
        toks = gen_fn(model, lbls, torch.Generator(device=dev).manual_seed(step))
        imgs = vae.decode_tokens(toks).float()  # [-1, 1]
    grid = generation_grid(imgs.cpu().numpy(), ncol=8)
    out = Path(args.output) / "train_generated_images" / f"{step:08d}_s-generated.png"
    save_png(grid, out)
    tracker.log_image("Train Generated", grid, step)
    logger.info(f"preview grid -> {out}")
    return out


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"trainer", "step", "metrics" (the last step's), "ckpt",
    "previews" (PNG paths), "seq_len"}."""
    from imagefolder_tpu_torch.utils.logging import MetricLogger, Tracker, create_logger

    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)
    if args.batch_size % process_count():
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of the "
                         f"{process_count()} processes")
    local_bs = args.batch_size // process_count()
    logger = create_logger(args.output)
    tok = load_tokenizer(args.config, args.vq_ckpt, dev) if (args.config and args.vq_ckpt) \
        else None
    if args.jsonl:
        data = JsonlTokens(args.jsonl)
        seq_len = len(data.rows[0]["tokens"])
        batches = data.batches(local_bs, shard_index=process_index(),
                               shard_count=process_count())
        logger.info(f"{len(data)} pretokenized rows, seq_len={seq_len}")
    else:
        if tok is None or not args.data_path:
            raise SystemExit("on-the-fly mode needs --config --vq_ckpt --data_path")
        batches, seq_len, args.codebook_size = _online_tokens(args, tok, local_bs, dev)
        logger.info(f"on-the-fly tokenization, seq_len={seq_len}")
    if args.generate_every and tok is None:
        logger.info("previews disabled: --generate_every needs the tokenizer "
                    "(--config + --vq_ckpt)")
    tracker = Tracker(use_wandb=args.wandb, log_dir=args.output, use_tb=True)
    if args.model == "maskgit":
        return _train_maskgit(args, batches, seq_len, logger, tok, tracker, dev)

    from imagefolder_tpu_torch.models import build_rar
    from imagefolder_tpu_torch.models.rar import rar_generate
    from imagefolder_tpu_torch.train.rar_train import (
        RARTrainConfig,
        RARTrainer,
        get_rar_random_ratio,
    )
    from imagefolder_tpu_torch.utils.ckpt import CheckpointManager

    rar = build_rar(seq_len=seq_len, codebook_size=args.codebook_size, hidden=args.hidden,
                    depth=args.depth, heads=args.heads, num_classes=args.num_classes,
                    dtype_str="bfloat16", generator=torch.Generator().manual_seed(0),
                    device=dev)
    tcfg = RARTrainConfig(total_steps=args.total_steps, warmup_steps=args.total_steps // 4,
                          random_ratio_anneal_end=args.total_steps // 2)
    trainer = RARTrainer(rar, tcfg)
    ckpt = CheckpointManager(args.output)
    restored, start = ckpt.restore()
    if restored is not None:
        trainer.load_state_dict(restored)
        logger.info(f"resumed at {start}")
    mlog = MetricLogger(logger, args.log_every)
    gen_fn = None
    ema_model = None
    if tok is not None and args.generate_every:
        # KV cache in the activation dtype (see sample_rar.py)
        def gen_fn(model, c, g):
            return rar_generate(model, c, g, guidance_scale=args.guidance_scale,
                                randomize_temperature=args.temperature,
                                guidance_scale_pow=args.guidance_scale_pow,
                                cache_dtype=model.config.dtype)
        ema_model = copy.deepcopy(rar).requires_grad_(False).eval()
    it = batches
    if start and hasattr(it, "set_state") and ckpt.apply_data_state(start, it, log=logger.info):
        logger.info("restored data-stream state")
    metrics: dict = {}
    previews = []
    for step in range(start, args.total_steps):
        toks, labels = next(it)
        ratio = get_rar_random_ratio(tcfg.random_ratio_anneal_start,
                                     tcfg.random_ratio_anneal_end, step)
        metrics = trainer.train_step(torch.as_tensor(toks, dtype=torch.long, device=dev),
                                     torch.as_tensor(labels, dtype=torch.long, device=dev),
                                     ratio, step_generator(dev, 0, step))
        if (step + 1) % args.log_every == 0:
            host = {k: float(v) for k, v in metrics.items()}
            mlog.update(**host, random_ratio=ratio)
            mlog.log(step + 1, args.total_steps)
            tracker.log(dict(host, random_ratio=ratio), step + 1)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, trainer.state_dict())
            if hasattr(it, "get_state"):
                ckpt.save_data_state(step + 1, it.get_state())
        if gen_fn is not None and (step + 1) % args.generate_every == 0:
            # the EMA weights sample the preview (train_utils.py:777-780)
            ema_model.load_state_dict(trainer.ema_state_dict())
            previews.append(_preview(gen_fn, tok, ema_model, args, step + 1, tracker, logger))
    ckpt.save(args.total_steps, trainer.state_dict())
    ckpt.wait()
    tracker.close()
    return {"trainer": trainer, "step": args.total_steps, "metrics": metrics, "ckpt": ckpt,
            "previews": previews, "seq_len": seq_len}


def _train_maskgit(args, batches, seq_len, logger, tok, tracker, dev) -> dict:
    """MaskGIT's masked-modelling loop (reference model_type='maskgit'):
    ``MaskGITTrainer`` (optax.adamw's step on the warm-up cosine schedule),
    checkpoints of the weights, previews from the live weights."""
    from imagefolder_tpu_torch.models import build_maskgit
    from imagefolder_tpu_torch.models.maskgit import maskgit_generate
    from imagefolder_tpu_torch.train.rar_train import MaskGITTrainer
    from imagefolder_tpu_torch.utils.ckpt import CheckpointManager
    from imagefolder_tpu_torch.utils.logging import MetricLogger

    model = build_maskgit(seq_len=seq_len, codebook_size=args.codebook_size,
                          hidden=args.hidden, depth=args.depth, heads=args.heads,
                          num_classes=args.num_classes, dtype_str="bfloat16",
                          arch=args.maskgit_arch, generator=torch.Generator().manual_seed(0),
                          device=dev)
    trainer = MaskGITTrainer(model, args.total_steps)
    gen_fn = None
    if tok is not None and args.generate_every:
        def gen_fn(m, c, g):
            return maskgit_generate(m, c, g, guidance_scale=args.guidance_scale,
                                    guidance_decay="constant",
                                    guidance_scale_pow=args.guidance_scale_pow,
                                    randomize_temperature=args.temperature,
                                    num_sample_steps=8)
    ckpt = CheckpointManager(args.output)
    mlog = MetricLogger(logger, args.log_every)
    metrics: dict = {}
    previews = []
    for step in range(args.total_steps):
        toks, labels = next(batches)
        metrics = trainer.train_step(torch.as_tensor(toks, dtype=torch.long, device=dev),
                                     torch.as_tensor(labels, dtype=torch.long, device=dev),
                                     step_generator(dev, 0, step))
        if (step + 1) % args.log_every == 0:
            host = {"loss": float(metrics["loss"]),
                    "correct_tokens": float(metrics["correct_tokens"])}
            mlog.update(**host)
            mlog.log(step + 1, args.total_steps)
            tracker.log(host, step + 1)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"model": model.state_dict()})
        if gen_fn is not None and (step + 1) % args.generate_every == 0:
            model.eval()
            previews.append(_preview(gen_fn, tok, model, args, step + 1, tracker, logger))
            model.train()
    ckpt.save(args.total_steps, {"model": model.state_dict()})
    ckpt.wait()
    tracker.close()
    return {"trainer": trainer, "step": args.total_steps, "metrics": metrics, "ckpt": ckpt,
            "previews": previews, "seq_len": seq_len}


if __name__ == "__main__":
    main()
