"""End-to-end CLI workflow on the card (counterpart of
``scripts/e2e_pipeline.py``): drive the port's user-facing CLIs
(``imagefolder_tpu_torch/scripts/``) as subprocesses through the
reference's three-workload pipeline (README.md:150-248) on a procedural
dataset:

  1. train_tokenizer  (single-scale VQ, CNN VQ-16)        -> tok_vq/
     with the in-training eval stack live: the val-rFID best-ckpt gate
     through a seeded Inception (``eval/inception.py::load_inception(seed=)``
     saved in pytorch-fid's layout: random weights, so the FID numbers mean
     nothing, the plumbing is the real path), per-scale recon grids
     (vis_every), tracker scalars;
  2. train_tokenizer  (multi-scale PQ2 MSVQ)              -> tok_msvq/
     with the PSNR fallback gating the best checkpoint (no Inception);
  3. eval_reconstruction on both tokenizers (PSNR/SSIM);
  4. pretokenize      (tok_vq -> pretokenized.jsonl)      [workload C]
  5. train_rar --jsonl ... --generate_every               [workload C]
     (EMA preview grids decoded by the tokenizer);
  6. sample_rar       -> rar_samples.npz                  [workload C]
  7. train_var        (tok_msvq, teacher forcing)         [workload B]
     with --eval_every: val CE/acc, a CFG preview grid and the best
     checkpoint by val loss tail;
  8. sample_var       -> var_samples.npz                  [workload B]
  9. grade the class-conditional samples: nearest-pool-neighbour class
     fidelity and distance (an exact-memorisation proxy: no real Inception
     weights are in the repository).

Every stage is a shipped CLI with its public flags and ``--device``: nothing
is called through the library API. ``summary.json`` names the device the
stages ran on.

Usage:
    python -m imagefolder_tpu_torch.scripts.e2e_pipeline --workdir e2e_port [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

__all__ = ["main", "make_dataset", "write_yaml", "grade_samples", "save_grid", "latest_ckpt"]

# 8 visually distinct class palettes (RGB in [0,1])
_COLORS = np.array([
    [0.95, 0.25, 0.20], [0.20, 0.80, 0.35], [0.25, 0.45, 0.95],
    [0.95, 0.80, 0.20], [0.80, 0.30, 0.90], [0.20, 0.85, 0.85],
    [0.95, 0.55, 0.20], [0.60, 0.60, 0.60],
])


def make_dataset(root: Path, classes: int, per_class: int, size: int,
                 seed: int = 0):
    """Procedural class-structured pool: per class a distinct grating
    orientation/frequency + color tint; per instance a random phase."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(classes):
        d = root / f"class_{c:02d}"
        d.mkdir(parents=True, exist_ok=True)
        ang = c * np.pi / classes
        freq = 3.0 + 1.5 * c
        tint = _COLORS[c % len(_COLORS)]
        for i in range(per_class):
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * freq *
                          (xx * np.cos(ang) + yy * np.sin(ang)) + phase)
            img = tint[None, None] * (0.55 + 0.40 * wave[..., None])
            img = img + rng.normal(0, 0.015, img.shape)
            u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(d / f"{i:03d}.png")


def write_yaml(path: Path, **kv):
    lines = []
    for k, v in kv.items():
        if isinstance(v, (list, tuple)):
            v = "[" + ", ".join(str(x) for x in v) + "]"
        lines.append(f"{k}: {v}")
    path.write_text("\n".join(lines) + "\n")


STAGE_TIMEOUT = 2400
RESUME = False


def run_stage(name: str, module: str, args: list, logdir: Path, device: str,
              timeout: int = 0) -> float:
    """``python -m imagefolder_tpu_torch.scripts.<module> <args> --device
    <device>`` from the repository root, its output to ``logs/<name>.log``;
    the stage's seconds (a ``<name>.ok`` stamp is written, which
    ``--resume`` skips on). A failed stage ends the run."""
    timeout = timeout or STAGE_TIMEOUT
    log = logdir / f"{name}.log"
    ok = logdir / f"{name}.ok"
    if RESUME and ok.exists():
        dt = float(ok.read_text())
        print(f"[e2e] {name}: already done ({dt:.0f}s), skipping")
        return dt
    cmd = [sys.executable, "-m", f"imagefolder_tpu_torch.scripts.{module}",
           *map(str, args), "--device", device]
    print(f"[e2e] {name}: {' '.join(cmd[1:])}")
    t0 = time.time()
    with open(log, "w") as f:
        try:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = f"timeout({timeout}s)"
    dt = time.time() - t0
    tail = "".join(log.read_text().splitlines(keepends=True)[-8:])
    print(f"[e2e] {name}: rc={rc} in {dt:.0f}s\n{tail}")
    if rc != 0:
        raise SystemExit(f"stage {name} failed (see {log})")
    ok.write_text(f"{dt:.1f}")
    return dt


def latest_ckpt(outdir: Path) -> Path:
    """The newest ``ckpts/step_<step>.pt`` a port CLI wrote under ``outdir``."""
    return max((outdir / "ckpts").glob("step_*.pt"), key=lambda p: int(p.stem[5:]))


def grade_samples(npz_path: Path, ds_root: Path, classes: int,
                  n_samples: int):
    """Nearest-pool-neighbour grading at 32x32: a sample is 'class
    faithful' if its nearest training image belongs to the requested
    class (labels follow the samplers' tile(arange(classes)) order)."""
    from PIL import Image

    arr = np.load(npz_path)["arr_0"].astype(np.float32) / 255.0
    req = np.tile(np.arange(classes), -(-n_samples // classes))[:n_samples]
    pool, pool_lbl = [], []
    for ci, d in enumerate(sorted(ds_root.iterdir())):
        for f in sorted(d.glob("*.png")):
            pool.append(np.asarray(
                Image.open(f).resize((32, 32), Image.BILINEAR),
                dtype=np.float32) / 255.0)
            pool_lbl.append(ci)
    pool = np.stack(pool).reshape(len(pool), -1)
    pool_lbl = np.asarray(pool_lbl)
    ds = []
    for a in arr:
        small = np.asarray(Image.fromarray(
            (a * 255).astype(np.uint8)).resize((32, 32), Image.BILINEAR),
            dtype=np.float32).reshape(-1) / 255.0
        ds.append(np.sqrt(((pool - small) ** 2).sum(-1) / pool.shape[1]))
    ds = np.stack(ds)  # [N, pool]
    nn = ds.argmin(-1)
    return {
        "class_fidelity": float((pool_lbl[nn] == req).mean()),
        "mean_nn_rmse": float(ds.min(-1).mean()),
        "per_class_fidelity": [
            float((pool_lbl[nn[req == c]] == c).mean())
            if (req == c).any() else None
            for c in range(classes)
        ],
    }


def save_grid(npz_path: Path, out_png: Path, cols: int = 8):
    from PIL import Image

    arr = np.load(npz_path)["arr_0"]
    n, h, w, _ = arr.shape
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, a in enumerate(arr):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = a
    Image.fromarray(grid).save(out_png)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m imagefolder_tpu_torch.scripts.e2e_pipeline")
    ap.add_argument("--workdir", default="e2e_port")
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--per_class", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--tok_epochs", type=int, default=40)
    ap.add_argument("--var_epochs", type=int, default=75)
    ap.add_argument("--rar_steps", type=int, default=600)
    ap.add_argument("--num_samples", type=int, default=32)
    ap.add_argument("--stage_timeout", type=int, default=2400,
                    help="per-stage wall clock cap, seconds")
    ap.add_argument("--resume", action="store_true",
                    help="skip stages whose logs/<name>.ok stamp exists (artifacts from the "
                         "prior run are reused)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    global STAGE_TIMEOUT, RESUME
    STAGE_TIMEOUT = args.stage_timeout
    RESUME = args.resume
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is False "
                         "(pass --device cpu to run on the CPU)")

    wd = Path(args.workdir).absolute()
    ds = wd / "ds"
    logs = wd / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    make_dataset(ds, args.classes, args.per_class, args.image_size)
    n_train = args.classes * args.per_class
    grid = args.image_size // 16  # VQ-16 cnn downsample factor
    tok_steps = args.tok_epochs * (n_train // 16)

    # a seeded Inception in pytorch-fid's layout: random weights, real
    # plumbing, so the val-rFID best-ckpt gate runs its true code path
    from imagefolder_tpu_torch.eval.inception import load_inception

    seeded_inception = wd / "seeded_inception.pth"
    torch.save(load_inception(seed=0, device="cpu").state_dict(), seeded_inception)

    common = dict(
        enc_type="cnn", dec_type="cnn", vq_model="VQ-16",
        semantic_guide="none", detail_guide="none",
        codebook_size=256, codebook_embed_dim=32,
        num_latent_tokens=grid * grid, image_size=args.image_size,
        data_path=ds, val_data_path=ds,
        epochs=args.tok_epochs, global_batch_size=16,
        lr=8e-4, lr_scheduler="none", disc_type="patchgan",
        disc_epoch_start=args.tok_epochs // 3, disc_adaptive_weight="true",
        ema="true", save_best="true", ckpt_every=max(tok_steps // 2, 1),
        vis_every=max(tok_steps // 3, 1), log_every=8,
    )
    vq_yaml, msvq_yaml = wd / "vq.yaml", wd / "msvq.yaml"
    pyramid = [p for p in (1, 2, 3, 4, 6, 8, 10, 13) if p < grid] + [grid]
    write_yaml(vq_yaml, cloud_save_path=wd / "tok_vq",
               v_patch_nums=[grid], product_quant=1, **common)
    write_yaml(msvq_yaml, cloud_save_path=wd / "tok_msvq",
               v_patch_nums=pyramid, product_quant=2, **common)

    summary = {"stages": {}, "config": vars(args),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    def stage(name, module, stage_args):
        summary["stages"][name] = run_stage(name, module, stage_args, logs, args.device)

    # VQ tokenizer: val-rFID best-ckpt gate (seeded Inception weights)
    stage("train_tok_vq", "train_tokenizer", ["--config", vq_yaml,
                                              "--inception_ckpt", seeded_inception])
    # MSVQ tokenizer: the PSNR fallback gates best-ckpt
    stage("train_tok_msvq", "train_tokenizer", ["--config", msvq_yaml])
    for tag in ("tok_vq", "tok_msvq"):
        metric = "val rfid" if tag == "tok_vq" else "val psnr"
        summary[f"{tag}_val"] = [
            line.strip() for line in (logs / f"train_{tag}.log").read_text().splitlines()
            if metric in line.lower()]
        assert summary[f"{tag}_val"], f"{tag}: no {metric} line logged"
        assert (wd / tag / "best.pt").exists(), f"{tag}: best ckpt missing"
        vis = sorted((wd / tag / "vis").glob("recon_*.png"))
        assert vis, f"{tag}: no recon grids written"
        summary[f"{tag}_recon_grids"] = [v.name for v in vis]
    vq_ckpt = latest_ckpt(wd / "tok_vq")
    msvq_ckpt = latest_ckpt(wd / "tok_msvq")

    for tag, yml, ck in (("vq", vq_yaml, vq_ckpt), ("msvq", msvq_yaml, msvq_ckpt)):
        stage(f"eval_recon_{tag}", "eval_reconstruction",
              ["--config", yml, "--vq_ckpt", ck, "--val_data", ds, "--batch_size", 16,
               "--max_images", n_train])
        for line in (logs / f"eval_recon_{tag}.log").read_text().splitlines():
            if "PSNR" in line.upper():
                summary[f"recon_{tag}"] = line.strip()

    # ---- workload C: pretokenize -> RAR -> sample ----
    jsonl = wd / "pretokenized.jsonl"
    stage("pretokenize", "pretokenize",
          ["--config", vq_yaml, "--vq_ckpt", vq_ckpt, "--data_path", ds, "--output", jsonl,
           "--crop_mode", "center", "--batch_size", 64])
    summary["pretokenized_rows"] = sum(1 for _ in open(jsonl))
    stage("train_rar", "train_rar",
          ["--jsonl", jsonl, "--hidden", 256, "--depth", 6, "--heads", 4,
           "--codebook_size", 256, "--num_classes", args.classes, "--batch_size", 32,
           "--total_steps", args.rar_steps, "--ckpt_every", args.rar_steps, "--log_every", 100,
           # periodic EMA preview grids (the tokenizer decodes them)
           "--config", vq_yaml, "--vq_ckpt", vq_ckpt,
           "--generate_every", max(args.rar_steps // 2, 1),
           "--guidance_scale", 1.5, "--temperature", 1.0, "--output", wd / "rar"])
    rar_previews = sorted((wd / "rar" / "train_generated_images").glob("*.png"))
    assert rar_previews, "train_rar: no preview grids generated"
    summary["rar_previews"] = [p.name for p in rar_previews]
    rar_npz = wd / "rar_samples.npz"
    stage("sample_rar", "sample_rar",
          ["--config", vq_yaml, "--vq_ckpt", vq_ckpt, "--rar_ckpt", latest_ckpt(wd / "rar"),
           "--hidden", 256, "--depth", 6, "--heads", 4, "--num_classes", args.classes,
           "--num_samples", args.num_samples, "--batch_size", args.num_samples,
           "--guidance_scale", 1.5, "--temperature", 1.0, "--output", rar_npz])
    summary["rar"] = grade_samples(rar_npz, ds, args.classes, args.num_samples)
    save_grid(rar_npz, wd / "rar_samples.png")

    # ---- workload B: VAR teacher-forced training -> CFG sampling ----
    var_steps = args.var_epochs * (n_train // 16)
    stage("train_var", "train_var",
          ["--config", msvq_yaml, "--vq_ckpt", msvq_ckpt, "--depth", 6, "--batch_size", 16,
           "--epochs", args.var_epochs, "--tblr", 2e-3, "--num_classes", args.classes,
           "--ckpt_every", 1_000_000, "--log_every", 100,
           # eval_ep + CFG preview + best-by-val-loss-tail
           "--eval_every", max(var_steps // 2, 1), "--output", wd / "var"])
    summary["var_val"] = [line.strip() for line in
                          (logs / "train_var.log").read_text().splitlines() if "[eval" in line]
    assert summary["var_val"], "train_var: no eval_ep lines logged"
    assert (wd / "var" / "best.pt").exists(), "train_var: best ckpt missing"
    var_previews = sorted((wd / "var" / "preview").glob("gen_*.png"))
    assert var_previews, "train_var: no CFG preview grids"
    summary["var_previews"] = [p.name for p in var_previews]
    var_npz = wd / "var_samples.npz"
    stage("sample_var", "sample_var",
          ["--config", msvq_yaml, "--vq_ckpt", msvq_ckpt, "--var_ckpt", latest_ckpt(wd / "var"),
           "--depth", 6, "--num_classes", args.classes, "--num_samples", args.num_samples,
           "--batch_size", args.num_samples, "--cfg", 1.5, "--top_k", 32, "--top_p", 0.95,
           "--output", var_npz])
    summary["var"] = grade_samples(var_npz, ds, args.classes, args.num_samples)
    save_grid(var_npz, wd / "var_samples.png")

    (wd / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
