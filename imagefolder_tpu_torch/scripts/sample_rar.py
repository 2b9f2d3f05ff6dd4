"""RAR / MaskGIT sampling CLI for FID (counterpart of
``scripts/sample_rar.py``; reference ``sample_imagenet_rar.py`` and
``demo_util.sample_fn``, model_type rar|maskgit): class-balanced labels,
generate, ``decode_tokens``, uint8 ``clip(127.5 img + 128)``, one npz, and
with ``--ref_npz`` the evaluator (``evaluate_fid.evaluate``).

Usage:
    python -m imagefolder_tpu_torch.scripts.sample_rar --config configs/RobustTok.yaml \
        --vq_ckpt <file> --rar_ckpt <train_rar checkpoint or rar-b.bin> \
        [--model maskgit] [--num_samples N] [--ref_npz ref.npz --inception_ckpt <file>] \
        [--device cpu]

``--rar_ckpt`` is a ``train_rar`` checkpoint (its EMA where it has one,
else its weights) or an upstream-layout weight file. RAR samples with its
KV cache in bf16, the activations' dtype (CFG ``--guidance_scale`` with the
power-cosine ramp, ``--temperature``); MaskGIT by iterative parallel
decoding (``--guidance_decay``, ``--num_sample_steps``). Process p samples
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
    load_tokenizer,
    resolve_device,
    save_samples,
)

__all__ = ["main", "to_uint8"]


def to_uint8(imgs_pm1: torch.Tensor) -> np.ndarray:
    """[-1, 1] images as uint8, clip(127.5 x + 128) truncated (the JAX
    script's cast)."""
    return torch.clamp(127.5 * imgs_pm1.float() + 128.0, 0, 255).to(torch.uint8).cpu().numpy()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.sample_rar")
    ap.add_argument("--config", required=True, help="tokenizer yaml")
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--rar_ckpt", required=True)
    ap.add_argument("--model", choices=["rar", "maskgit"], default="rar")
    ap.add_argument("--maskgit_arch", choices=["bert", "uvit"], default="bert",
                    help="MaskGIT trunk: ImageBert or UViTBert (RAR/maskgit.py:209)")
    ap.add_argument("--guidance_decay", default="constant",
                    choices=["constant", "linear", "power-cosine"])
    ap.add_argument("--num_sample_steps", type=int, default=8,
                    help="maskgit parallel-decode steps")
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--num_samples", type=int, default=50_000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--guidance_scale", type=float, default=16.0)
    ap.add_argument("--guidance_scale_pow", type=float, default=2.75)
    ap.add_argument("--temperature", type=float, default=1.02)
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--output", default="samples.npz")
    ap.add_argument("--ref_npz", default=None,
                    help="reference batch npz: run the full evaluator "
                         "(FID/sFID/IS/Prec/Recall) after sampling")
    ap.add_argument("--inception_ckpt", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    return add_distributed_args(ap)


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"samples": the merged uint8 array (None off process 0),
    "tokens": this process's token batches, "metrics": the evaluator's or
    None}."""
    from imagefolder_tpu_torch.models import build_maskgit, build_rar

    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    init_from_args(args, dev)
    vae, margs, _ = load_tokenizer(args.config, args.vq_ckpt, dev)
    weights = checkpoint_weights(args.rar_ckpt)
    kw = dict(hidden=args.hidden, depth=args.depth, heads=args.heads,
              num_classes=args.num_classes, dtype_str="bfloat16", device=dev)
    if args.model == "maskgit":
        from imagefolder_tpu_torch.models.maskgit import maskgit_generate

        model = build_maskgit(margs, arch=args.maskgit_arch, **kw)

        def gen(c, g):
            return maskgit_generate(model, c, g, guidance_scale=args.guidance_scale,
                                    guidance_decay=args.guidance_decay,
                                    guidance_scale_pow=args.guidance_scale_pow,
                                    randomize_temperature=args.temperature,
                                    num_sample_steps=args.num_sample_steps)
    else:
        from imagefolder_tpu_torch.models.rar import rar_generate

        model = build_rar(margs, **kw)

        # KV cache in the activation dtype: k and v are bf16-rounded before
        # caching anyway, so an fp32 cache only doubles its memory
        def gen(c, g):
            return rar_generate(model, c, g, guidance_scale=args.guidance_scale,
                                randomize_temperature=args.temperature,
                                guidance_scale_pow=args.guidance_scale_pow,
                                cache_dtype=model.config.dtype)
    model.load_state_dict(weights, strict=True)
    model.requires_grad_(False).eval()

    g = torch.Generator(device=dev).manual_seed(process_index())
    out, tokens = [], []
    seen = 0
    with torch.no_grad():
        for lb, n in class_balanced_batches(args.num_samples, args.num_classes,
                                            args.batch_size):
            toks = gen(lb.to(dev), g)
            imgs = vae.decode_tokens(toks)  # [-1, 1]
            out.append(to_uint8(imgs)[:n])
            tokens.append(toks[:n].cpu())
            if seen % (args.batch_size * 50) == 0:
                print(f"{seen}/{args.num_samples}")
            seen += n
    arr = save_samples(args.output, np.concatenate(out), args.num_samples)
    metrics = None
    if args.ref_npz and is_primary():
        # gFID leg (reference inference.py:117-133 -> evaluator.py main)
        from imagefolder_tpu_torch.scripts.evaluate_fid import evaluate, load_inception_fn

        metrics = evaluate(args.ref_npz, args.output, load_inception_fn(args.inception_ckpt, dev))
    return {"samples": arr, "tokens": tokens, "metrics": metrics}


if __name__ == "__main__":
    main()
