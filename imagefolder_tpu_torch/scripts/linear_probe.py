"""Linear probing of frozen tokenizer features (counterpart of
``scripts/linear_probe.py``; reference
``tokenizer/tokenizer_image/linear_probing.py``, bit-rotted upstream and
rebuilt as a working tool): train a linear classifier on the spatial mean
of ``VQModel.img_to_sem_feat`` and report top-1 ACC on the val folder.

Usage:
    python -m imagefolder_tpu_torch.scripts.linear_probe --config configs/RobustTok.yaml \\
        --vq_ckpt <file> --data_path <dir> --val_data <dir> [--steps 5000] [--device cpu]

The head (W (C, classes) and b, both zero at the start) trains with
``torch.optim.Adam`` at optax.adam's defaults (betas 0.9, 0.999, eps 1e-8)
on cross-entropy; batches come from the port's ImageFolder loader
(``data/imagenet.py``: the train loader shuffled and augmented, repeated as
long as the steps need; the val loader once, centre crops, the last batch
kept). ``--vq_ckpt`` is a port training checkpoint (its EMA, else its model)
or an upstream-layout weight file. The tokenizer runs in the YAML's dtype.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.data.imagenet import make_dataloader
from imagefolder_tpu_torch.scripts._cli import load_tokenizer, resolve_device

__all__ = ["main", "features", "train_step"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.linear_probe")
    ap.add_argument("--config", required=True)
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--val_data", default=None)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


@torch.no_grad()
def features(model, images: torch.Tensor) -> torch.Tensor:
    """The probe's input: ``img_to_sem_feat``'s spatial mean, (B, C) fp32."""
    return model.img_to_sem_feat(images).float().mean(dim=(1, 2))


def train_step(w: torch.Tensor, b: torch.Tensor, opt: torch.optim.Optimizer,
               feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One Adam step of the head (w, b) on cross-entropy over a batch of
    features; returns the loss before the step."""
    loss = F.cross_entropy(feats @ w + b, labels.long())
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Returns {"acc": top-1 in percent, "total": val images, "loss": the
    last step's loss, "steps": steps taken}."""
    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    model, margs, run = load_tokenizer(args.config, args.vq_ckpt, dev)
    dim = margs.codebook_embed_dim
    w = torch.zeros((dim, args.num_classes), device=dev, requires_grad=True)
    b = torch.zeros((args.num_classes,), device=dev, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    train = iter(make_dataloader(args.data_path or run.data_path, args.batch_size,
                                 margs.image_size, train=True))
    loss = torch.zeros(())
    for i in range(args.steps):
        batch = next(train)
        loss = train_step(w, b, opt, features(model, batch["image"].to(dev)),
                          batch["label"].to(dev))
        if (i + 1) % 200 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")

    val = make_dataloader(args.val_data or run.val_data_path, args.batch_size,
                          margs.image_size, train=False, num_epochs=1, drop_remainder=False)
    correct = total = 0
    with torch.no_grad():
        for batch in val:
            pred = (features(model, batch["image"].to(dev)) @ w + b).argmax(dim=-1).cpu()
            correct += int((pred == batch["label"].long()).sum())
            total += len(pred)
    acc = 100.0 * correct / max(total, 1)
    print(f"linear-probe ACC: {acc:.2f}% ({total} images)")
    return {"acc": acc, "total": total, "loss": float(loss), "steps": args.steps}


if __name__ == "__main__":
    main()
