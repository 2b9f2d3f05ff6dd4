"""VAR sampling CLI for FID (counterpart of ``scripts/sample_var.py``;
reference ``inference.py``): the 10-stage CFG decode over class-balanced
labels, uint8 ``clip(255 img + 0.5)``, one npz, and with ``--ref_npz`` the
evaluator (``evaluate_fid.evaluate``).

Usage:
    python -m imagefolder_tpu_torch.scripts.sample_var --config configs/MSVR10P2-4096.yaml \
        --vq_ckpt <file> --var_ckpt <train_var checkpoint or weight file> \
        [--cfg 3.25 --top_k 900 --top_p 0.96] [--joint_sample] [--more_smooth] \
        [--ref_npz ref.npz --inception_ckpt <file>] [--device cpu]

``--var_ckpt`` is a ``train_var`` checkpoint (its EMA where it has one,
else its weights) or an upstream-layout VAR weight file; VAR runs with
bf16 activations (``build_vae_var``). ``--more_smooth`` is the reference's
gumbel-softmax visualisation protocol, not one for FID. Process p samples
the labels p, p + P, ... with a generator seeded p (the JAX script's
``fold_in(PRNGKey(0), p)``, split per batch; the streams differ), and
process 0 merges the processes' npz parts.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.parallel.dist import (
    add_distributed_args,
    init_from_args,
    is_primary,
    process_index,
)
from imagefolder_tpu_torch.scripts._cli import (
    checkpoint_weights,
    class_balanced_batches,
    resolve_device,
    save_samples,
)

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.sample_var")
    ap.add_argument("--config", required=True)
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--var_ckpt", required=True)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--num_samples", type=int, default=50_000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--cfg", type=float, default=3.25)
    ap.add_argument("--top_k", type=int, default=900)
    ap.add_argument("--top_p", type=float, default=0.96)
    ap.add_argument("--joint_sample", action="store_true")
    ap.add_argument("--more_smooth", action="store_true",
                    help="gumbel-softmax smoothed code mixtures "
                         "(var.py:196-225, inference.py:32 visualization "
                         "protocol; not for FID benchmarking)")
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--output", default="var_samples.npz")
    ap.add_argument("--ref_npz", default=None,
                    help="reference batch npz: run the full evaluator "
                         "(FID/sFID/IS/Prec/Recall) after sampling")
    ap.add_argument("--inception_ckpt", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    return add_distributed_args(ap)


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"samples": the merged uint8 array (None off process 0),
    "metrics": the evaluator's or None}."""
    from imagefolder_tpu_torch.models import build_vae_var
    from imagefolder_tpu_torch.train.var_train import var_sample
    from imagefolder_tpu_torch.utils.config import load_tokenizer_config

    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)
    margs, _, _ = load_tokenizer_config(args.config)
    vae, var = build_vae_var(margs, depth=args.depth, num_classes=args.num_classes,
                             dtype_str="bfloat16", device=dev)
    vae.load_state_dict(checkpoint_weights(args.vq_ckpt), strict=True)
    var.load_state_dict(checkpoint_weights(args.var_ckpt), strict=True)
    vae.requires_grad_(False).eval()
    var.requires_grad_(False).eval()

    g = torch.Generator(device=dev).manual_seed(process_index())
    out = []
    for lb, n in class_balanced_batches(args.num_samples, args.num_classes, args.batch_size):
        imgs = var_sample(var, vae, lb.to(dev), g, cfg_scale=args.cfg, top_k=args.top_k,
                          top_p=args.top_p, joint_sample=args.joint_sample,
                          more_smooth=args.more_smooth)  # [0, 1]
        u8 = torch.clamp(imgs.float() * 255.0 + 0.5, 0, 255).to(torch.uint8)
        out.append(u8.cpu().numpy()[:n])
    arr = save_samples(args.output, np.concatenate(out), args.num_samples)
    metrics = None
    if args.ref_npz and is_primary():
        # gFID leg (reference inference.py:117-133 -> evaluator.py main)
        from imagefolder_tpu_torch.scripts.evaluate_fid import evaluate, load_inception_fn

        metrics = evaluate(args.ref_npz, args.output, load_inception_fn(args.inception_ckpt, dev))
    return {"samples": arr, "metrics": metrics}


if __name__ == "__main__":
    main()
