"""Reconstruction evaluation CLI (counterpart of
``scripts/eval_reconstruction.py``): PSNR and SSIM (reference
``tokenizer/vqgan/reconstruction_vqgan_ddp.py``) and, with Inception
weights, rFID against the val images (reference ``xqgan_train.py:516-569``).

pFID is the FID with RobustTok's latent perturbation on the encode path
(``--perturb ALPHA BETA DELTA``): encode, each branch's final f-hat
perturbed against its codebook (``ops/perturb.py``), decode, clip.

Usage:
    python -m imagefolder_tpu_torch.scripts.eval_reconstruction \
        --config configs/RobustTok.yaml --vq_ckpt <file> --val_data <dir> \
        [--inception_ckpt <file>] [--perturb ALPHA BETA DELTA] [--device cpu]

The model runs in fp32 (the reference's eval leg runs outside autocast,
xqgan_train.py:522-534). ``--vq_ckpt`` is a weight file or a training
checkpoint (``.pt``, ``.pth``, ``.bin``, ``.safetensors``), unwrapped from
its ``ema``, ``model`` or ``state_dict`` entry and loaded with strict=True.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from imagefolder_tpu_torch.data.imagenet import make_dataloader
from imagefolder_tpu_torch.eval.fid import compute_statistics
from imagefolder_tpu_torch.eval.inception import load_inception
from imagefolder_tpu_torch.eval.psnr_ssim import psnr, ssim
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.ops.perturb import add_perturbation, draw_perturbation
from imagefolder_tpu_torch.scripts._cli import resolve_device
from imagefolder_tpu_torch.utils.config import load_tokenizer_config
from imagefolder_tpu_torch.utils.hub import load_state_dict_file

__all__ = ["main", "rec_perturbed"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m imagefolder_tpu_torch.scripts.eval_reconstruction")
    ap.add_argument("--config", required=True)
    ap.add_argument("--vq_ckpt", required=True)
    ap.add_argument("--val_data", default=None)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_images", type=int, default=5000)
    ap.add_argument("--inception_ckpt", default=None, help="pytorch-fid checkpoint for rFID")
    ap.add_argument("--perturb", nargs=3, type=float, default=None,
                    metavar=("ALPHA", "BETA", "DELTA"))
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def rec_perturbed(model: VQModel, x: torch.Tensor, alpha: float, beta: float, delta: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Encode, perturb each branch's final f-hat against its codebook,
    decode, clip to [-1, 1] (the pFID path). Each branch draws its two
    uniforms (``draw_perturbation``) from ``generator``."""
    cfg = model.config
    h = model.encode(x)
    fhats = model._branch_fhats(x)
    quants = []
    for i, qz in enumerate(model.quantizers):
        z = h[:, i]
        n = z.shape[0] * z.shape[1] * z.shape[2]
        quants.append(add_perturbation(z, fhats[i][-1], qz.embedding.weight, alpha=alpha,
                                       beta=beta, delta=int(delta),
                                       codebook_norm=cfg.codebook_l2_norm,
                                       draws=draw_perturbation(n, generator, x.device)))
    return model.fhat_to_img(torch.cat(quants, dim=-1))


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(device or args.device)
    margs, _, run = load_tokenizer_config(args.config, {"dtype_str": "float32"})
    val = args.val_data or run.val_data_path
    model = VQModel(margs, device=dev)
    model.load_state_dict(load_state_dict_file(args.vq_ckpt), strict=True)
    inception = load_inception(args.inception_ckpt, device=dev) if args.inception_ckpt else None
    gen = torch.Generator(device=dev).manual_seed(0)

    loader = make_dataloader(val, args.batch_size, margs.image_size, train=False, num_epochs=1,
                             drop_remainder=False)
    psnrs, ssims, feats_real, feats_fake = [], [], [], []
    seen = 0
    with torch.no_grad():
        for b in loader:
            if seen >= args.max_images:
                break
            x = b["image"].to(dev)
            if args.perturb is None:
                r = model.img_to_reconstructed_img(x)
            else:
                r = rec_perturbed(model, x, *args.perturb, generator=gen)
            x01, r01 = x * 0.5 + 0.5, r.float() * 0.5 + 0.5
            psnrs.append(psnr(x01, r01).cpu().numpy())
            ssims.append(ssim(x01, r01).cpu().numpy())
            if inception is not None:
                feats_real.append(inception(x01)["pool3"].cpu().numpy())
                feats_fake.append(inception(r01)["pool3"].cpu().numpy())
            seen += x.shape[0]

    out = {"images": seen, "psnr": float(np.mean(np.concatenate(psnrs))),
           "ssim": float(np.mean(np.concatenate(ssims)))}
    print(f"images: {seen}")
    print(f"PSNR: {out['psnr']:.4f}")
    print(f"SSIM: {out['ssim']:.4f}")
    if inception is not None:
        out["feats_real"] = np.concatenate(feats_real)
        out["feats_fake"] = np.concatenate(feats_fake)
        s_real = compute_statistics(out["feats_real"])
        s_fake = compute_statistics(out["feats_fake"])
        tag = "pFID" if args.perturb else "rFID"
        out[tag.lower()] = s_real.frechet_distance(s_fake)
        print(f"{tag}: {out[tag.lower()]:.4f}")
    return out


if __name__ == "__main__":
    main()
