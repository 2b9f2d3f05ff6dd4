"""Export a trained checkpoint to the upstream and HF interchange formats
(counterpart of ``scripts/export_weights.py``; reference
``RAR/modules/base_model.py:15-127``, BaseModel's save_pretrained):

    # tokenizer -> upstream-loadable .pt / .safetensors
    python -m imagefolder_tpu_torch.scripts.export_weights --kind vqmodel \
        --config configs/VQ-4096.yaml --ckpt output/run/ckpts/step_00020000.pt \
        --out XQGAN-4096.safetensors

    # RAR -> rar-b.bin (the zoo's layout, RobustTok-README.md:17)
    python -m imagefolder_tpu_torch.scripts.export_weights --kind rar \
        --ckpt output/rar/ckpts/step_00250000.pt --out rar-b.bin --use_ema

    # HF-style directory (model.safetensors + config.json)
    python -m imagefolder_tpu_torch.scripts.export_weights --kind rar --ckpt ... \
        --out rar_b/ --hf

The input is a training checkpoint of the port (``utils/ckpt.py``: its
EMA copy with ``--use_ema`` where it has one, else its weights) or a
weight file (``.safetensors``, ``.bin``, ``.pt``, ``.pth``: a format
conversion). The port's models keep the upstream layout in their state
dicts, so the weights are written as they are; the output's suffix picks
the format. Runs on the host: no model is built and no device used.
"""

from __future__ import annotations

import argparse
from typing import Optional

from imagefolder_tpu_torch.scripts._cli import checkpoint_weights
from imagefolder_tpu_torch.utils.hub import save_pretrained, save_pretrained_weight

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.export_weights")
    ap.add_argument("--kind", required=True, choices=["vqmodel", "rar", "var"])
    ap.add_argument("--ckpt", required=True,
                    help="a training checkpoint of the port, or a torch/safetensors file")
    ap.add_argument("--out", required=True,
                    help=".safetensors/.bin/.pt path, or a directory with --hf")
    ap.add_argument("--config", default=None,
                    help="tokenizer yaml (required for --kind vqmodel, as by the JAX "
                         "exporter, whose converters read it; here the weights carry it)")
    ap.add_argument("--depth", type=int, default=24,
                    help="generator depth (the JAX exporter's converters read it; here the "
                         "weights carry it)")
    ap.add_argument("--use_ema", action="store_true",
                    help="export the EMA weights when the checkpoint has "
                         "them (the zoo's RAR checkpoints are EMA)")
    ap.add_argument("--hf", action="store_true",
                    help="write an HF-style directory (model.safetensors + config.json)")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Returns {"out": the path written, "weights": the state dict}."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.kind == "vqmodel" and not args.config:
        ap.error("--kind vqmodel needs --config")
    weights = checkpoint_weights(args.ckpt, use_ema=args.use_ema)
    if args.hf:
        out = save_pretrained(args.out, weights, args.kind,
                              config={"source_ckpt": str(args.ckpt)})
    else:
        out = save_pretrained_weight(args.out, weights)
    print(f"wrote {out}")
    return {"out": out, "weights": weights}


if __name__ == "__main__":
    main()
