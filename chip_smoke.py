"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, each printing what it found (any failure ends the run with a non-zero
exit; no failure is caught):
  1. device: the card's name and power limit, as nvidia-smi gives them;
  2. build: compile ``imagefolder_tpu_torch/csrc/*.cu`` (one nvcc per source,
     all started together, into the gitignored ``imagefolder_tpu_torch/_build/``)
     and load the library;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card: packed-qkv attention (#1) at the ViT shapes, its backward (#2)
     at the GAN step's three shapes, under the encoder's shared mask with and
     without dbias, ragged, in fp32 and through autograd, BNHD attention (#3) at every VAR
     sampling stage, the teacher-forcing shape and edge cases, its backward
     (#6) at the training shape with and without dbias, without a bias, at
     L = 680, ragged, on strided views and in fp32, and the codebook search
     (#9) at every scale of the multi-scale encode;
  4. models, card against CPU in fp32 from one seed: the VQ-4096 ViT-B
     tokenizer at B=2, and the MSVR10P2-4096 tokenizer with VAR-d16
     (``img_to_idxBl`` codes per scale, ``VAR.forward`` logits, greedy
     ``var_sample`` tokens and images; then one ``VARTrainer`` step's loss,
     every parameter's gradient, the gradient norm and the updated
     parameters, with the same training masks on both sides); two flagship
     GAN ``TokenizerTrainer`` steps (every metric, every trainable gradient of
     the generator and the disc heads, the updated parameters, with the same
     random draws on both sides); a code or token may differ only at a
     near-tie, and the card then goes on from the CPU's choice;
  5. main paths at B=64 in bf16, timed with CUDA events (a warm-up call, then
     median, min and max), each with every launch counter set to 0 just
     before its timed calls and read just after: the VQ-4096 round trip,
     ``var_sample`` (cfg 1.5, top-k 900, top-p 0.96), ``img_to_idxBl``, the
     teacher-forcing ``VAR.forward``, ``VARTrainer.train_step`` and
     ``eval_step``, and the flagship GAN ``TokenizerTrainer.train_step``;
  6. times: each kernel, its plain version (order plain, kernel, kernel,
     plain) and one PyTorch library call computing the same function (for
     #2 and #6, the backward of ``scaled_dot_product_attention``), at the main
     paths' largest shapes, beside the card's bound for that work.
Then one JSON line of kernel records and, last, the device JSON line.

Imports nothing of JAX: the card's machine has none. JAX parity lives in the
CPU tests (tests/test_torch_*.py).
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.losses.diffaug import draw_aug
from imagefolder_tpu_torch.losses.discriminators import draw_crop
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.models.vit import LayerScale
from imagefolder_tpu_torch.ops import quantize
from imagefolder_tpu_torch.ops.cuda import _build
from imagefolder_tpu_torch.ops.cuda import attention as attn
from imagefolder_tpu_torch.ops.cuda import codebook
from imagefolder_tpu_torch.train import var_train
from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer
from imagefolder_tpu_torch.train.var_train import VARTrainConfig, VARTrainer

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
HEADS = 12          # ViT-B
DISC_HEADS = 6      # DinoDisc's ViT-S/16 trunk
VAR_DEPTH = 16      # VAR-d16: width 1024, 16 heads of 64
VAR_HEADS = 16
HD = 64
PNS = (1, 1, 2, 3, 3, 4, 5, 6, 8, 11)  # MSVR10P2-4096's v_patch_nums
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
# card vs CPU, fp32 throughout: only summation order differs, compounded over
# 24 ViT blocks of width 768 with LayerScale raised to O(1), or 16 VAR blocks
MODEL_TOL = 1e-3
NEAR_TIE = 1e-5        # fp64 score gap under which two codes count as tied
LOGIT_NEAR_TIE = 1e-3  # top-2 gap of fp32 CFG logits under which a greedy pick may flip
KINK_NEAR_TIE = 1e-4   # of a tensor's max abs: a relu input or max-pool gap that may flip
# H100 SXM (NVIDIA data sheet): HBM3 rate, dense bf16 tensor-core peak and
# fp32 FMA peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# every kernel's launch counter: (module, attribute)
COUNTERS = {
    "attention_qkv_fwd": (attn, "LAUNCHES"),
    "attention_qkv_bwd": (attn, "BWD_LAUNCHES"),
    "fused_attention_fwd": (attn, "FUSED_LAUNCHES"),
    "fused_attention_bwd": (attn, "FUSED_BWD_LAUNCHES"),
    "codebook_argmin": (codebook, "LAUNCHES"),
}


def reset_counts():
    for mod, name in COUNTERS.values():
        setattr(mod, name, 0)


def read_counts() -> dict:
    return {k: getattr(mod, name) for k, (mod, name) in COUNTERS.items()}


def check_launches(path: str, calls: int, per_call: dict) -> dict:
    """The counters against per-call launches times the calls made since
    they were reset; a kernel not named must not have launched."""
    got = read_counts()
    want = {k: per_call.get(k, 0) * calls for k in COUNTERS}
    if got != want:
        raise AssertionError(f"[{path}] launches {got}, want {want} for {calls} calls")
    return got


def bench_margs(dtype_str: str) -> ModelArgs:
    """The tokenizer configuration bench.py measures for the JAX package:
    VQ-4096, DINOv2 ViT-B/16 encoder and decoder, 256 px, 256 latents."""
    return ModelArgs(
        codebook_size=4096, codebook_embed_dim=64, v_patch_nums=(16,),
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_base_patch14_dinov2.lvd142m",
        decoder_model="vit_base_patch14_dinov2.lvd142m",
        semantic_guide="none", detail_guide="none", num_latent_tokens=256,
        abs_pos_embed=True, image_size=256, dtype_str=dtype_str)


def msvr_margs(dtype_str: str) -> ModelArgs:
    """configs/MSVR10P2-4096.yaml at inference: two PQ branches of 121
    latents, ten scales, one 4096 x 32 codebook per branch, DINOv2 ViT-B/16
    encoder and decoder, 256 px. The teachers feed only training losses and
    are left out, as bench.py's sample leg does."""
    return ModelArgs(
        codebook_size=4096, codebook_embed_dim=32, v_patch_nums=PNS,
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_base_patch14_dinov2.lvd142m",
        decoder_model="vit_base_patch14_dinov2.lvd142m",
        semantic_guide="none", detail_guide="none", num_latent_tokens=121,
        product_quant=2, abs_pos_embed=True, image_size=256, dtype_str=dtype_str)


def encoder_mask(n: int, nl: int, device, block_first: int = 0) -> torch.Tensor:
    """The encoder's shared use_attn_mask bias: rows before the last nl cannot
    attend to the last nl columns. block_first > 0 also keeps the last nl rows
    from the first block_first columns, so that their first k/v tiles are
    all -inf."""
    idx = torch.arange(n, device=device)
    blocked = (idx[:, None] < n - nl) & (idx[None, :] >= n - nl)
    blocked |= (idx[:, None] >= n - nl) & (idx[None, :] < block_first)
    return torch.zeros(n, n, device=device).masked_fill(blocked, float("-inf"))[None, None]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + 1e-12)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.detach().float().cpu() - b.detach().float().cpu()).abs().max().item()


def _check(name: str, err: float, tol: float):
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time the card could take: compulsory bytes over the HBM
    rate, or operations over the peak rate of their type, whichever is
    larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------- phases -------------------------------- #

def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(line)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} card(s)")


def phase_build():
    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.relative_to(ROOT)} {'built' if fresh else 'found'} "
          f"and loaded in {secs:.2f} s")
    for line in _build.ptxas_report():
        print(f"[build] ptxas {line}")


def kernels_qkv(dev) -> float:
    """#1 against its plain version; returns the largest bf16 error at the
    main paths' shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("encoder VQ-4096", (BATCH, 513), bf16, None),
        ("decoder VQ-4096", (BATCH, 514), bf16, None),
        ("encoder MSVR10P2", (BATCH, 499), bf16, None),
        ("decoder MSVR10P2", (BATCH, 379), bf16, None),
        ("decoder fp32", (2, 514), f32, None),
        ("ragged", (3, 37), bf16, None),
        ("ragged fp32", (3, 37), f32, None),
        ("masked", (8, 513), bf16, encoder_mask(513, 256, dev)),
        ("masked fp32", (2, 513), f32, encoder_mask(513, 256, dev)),
        ("masked, -inf first tiles", (4, 513), bf16, encoder_mask(513, 256, dev, 128)),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main_err = 0.0
    for name, (b, n), dtype, bias in cases:
        qkv = torch.randn((b, n, 3 * HD * HEADS), generator=gen, device=dev).to(dtype)
        got = attn.attention_qkv(qkv, HEADS, bias)
        want = attn.attention_qkv_reference(qkv, HEADS, bias)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
            raise AssertionError(f"[kernels] #1 {name}: non-finite output")
        err = _max_err(got, want)
        print(f"[kernels] #1 {name:26s} qkv {tuple(qkv.shape)} {str(dtype)[6:]:8s} "
              f"bias={'shared' if bias is not None else 'none':6s} "
              f"max_abs_err {err:.3e} (tol {TOL[dtype]:g})")
        _check(f"[kernels] #1 {name}", err, TOL[dtype])
        if dtype == bf16 and bias is None and b == BATCH:
            main_err = max(main_err, err)
    return main_err


def kernels_qkv_bwd(dev) -> float:
    """#2 against its plain version: the max abs error of dqkv (and dbias)
    over the max abs of the plain result, at the three shapes of the GAN
    step, with the encoder's shared -inf mask (dbias on and off), ragged and
    in fp32; then ``attention_qkv``'s autograd on the card, which must go
    through #2 once. dbias keeps #6's bound (see ``kernels_bnhd_bwd``).
    Returns the largest error at the main path's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [  # (name, (B, N), heads, dtype, bias, dbias, main)
        ("encoder MSVR10P2", (BATCH, 499), HEADS, bf16, None, False, True),
        ("decoder MSVR10P2", (BATCH, 379), HEADS, bf16, None, False, True),
        ("DinoDisc trunk", (BATCH, 197), DISC_HEADS, bf16, None, False, True),
        ("masked, dbias off", (8, 499), HEADS, bf16, encoder_mask(499, 242, dev), False, False),
        ("masked, dbias on", (8, 499), HEADS, bf16, encoder_mask(499, 242, dev), True, False),
        ("masked fp32, dbias on", (2, 499), HEADS, f32, encoder_mask(499, 242, dev), True,
         False),
        ("DinoDisc fp32", (2, 197), DISC_HEADS, f32, None, False, False),
    ]
    for n in (1, 37, 130):
        cases.append((f"ragged N={n}", (3, n), 4, bf16, None, False, False))
        cases.append((f"ragged N={n}, bias", (3, n), 4, bf16,
                      encoder_mask(n, n // 3, dev, 1), True, False))
    cases.append(("ragged N=37 fp32", (3, 37), 4, f32, None, False, False))
    main_err = 0.0
    for name, (b, n), h, dtype, bias, need_db, main in cases:
        qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(dtype)
        g = torch.randn((b, n, HD * h), generator=gen, device=dev).to(dtype)
        got = attn.attention_qkv_bwd(qkv, h, bias, g, need_dbias=need_db)
        want = attn.attention_qkv_bwd_reference(qkv, h, bias, g, need_dbias=need_db)
        torch.cuda.synchronize()
        errs = {}
        for what, a, w in zip(("dqkv", "dbias"), got, want):
            if (a is None) != (w is None):
                raise AssertionError(f"[kernels] #2 {name}: {what} is {a} against {w}")
            if w is None:
                continue
            if a.shape != w.shape or a.dtype != w.dtype:
                raise AssertionError(f"[kernels] #2 {name}: {what} {tuple(a.shape)} {a.dtype}")
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(w).all())):
                raise AssertionError(f"[kernels] #2 {name}: non-finite {what}")
            errs[what] = _max_err(a, w) / max(w.detach().abs().max().item(), 1e-30)
        tol = TOL[dtype]
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[kernels] #2 {name:22s} qkv {tuple(qkv.shape)} {str(dtype)[6:]:8s} "
              f"bias={'shared' if bias is not None else 'none':6s}: error over max |plain| "
              f"{shown} (tol {tol:g})")
        for what, e in errs.items():
            _check(f"[kernels] #2 {name} {what}", e, tol)
        if main:
            main_err = max(main_err, *errs.values())
    # autograd: attention_qkv's backward on the card is one #2 launch
    qkv = torch.randn((2, 37, 3 * HD * HEADS), generator=gen, device=dev, requires_grad=True)
    bias = encoder_mask(37, 12, dev).requires_grad_()
    g = torch.randn((2, 37, HD * HEADS), generator=gen, device=dev)
    before = attn.BWD_LAUNCHES
    dqkv, dbias = torch.autograd.grad(attn.attention_qkv(qkv, HEADS, bias), (qkv, bias), g)
    want = attn.attention_qkv_bwd_reference(qkv.detach(), HEADS, bias.detach(), g)
    torch.cuda.synchronize()
    err = max(_max_err(dqkv, want[0]) / want[0].abs().max().item(),
              _max_err(dbias, want[1]) / want[1].abs().max().item())
    if attn.BWD_LAUNCHES != before + 1:
        raise AssertionError(f"[kernels] #2 autograd launched {attn.BWD_LAUNCHES - before} times")
    print(f"[kernels] #2 autograd of attention_qkv on the card: one launch, dqkv and dbias "
          f"error over max |plain| {err:.3e} (tol {TOL[f32]:g})")
    _check("[kernels] #2 autograd", err, TOL[f32])
    return main_err


def _bnhd(gen, b, lq, lk, h, dtype, dev, l2=True):
    """q (B, Lq, H, 64), k and v (B, Lk, H, 64) as VAR's attention makes them:
    with attn_l2_norm, L2-normed q times its temperature (4 at init) and
    L2-normed k, read at scale 1."""
    q = torch.randn((b, lq, h, HD), generator=gen, device=dev)
    k = torch.randn((b, lk, h, HD), generator=gen, device=dev)
    v = torch.randn((b, lk, h, HD), generator=gen, device=dev)
    if l2:
        q, k = _l2n(q) * 4.0, _l2n(k)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def kernels_bnhd(dev) -> float:
    """#3 against its plain version; returns the largest bf16 error at the
    main paths' shapes (the sampling stages and teacher forcing)."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    tf_bias = build_attn_bias(PNS).to(dev)
    ltot = tf_bias.shape[-1]
    cases = []  # (name, q, k, v, bias, scale, main)
    cum = 0
    for si, pn in enumerate(PNS):  # KV-cached CFG decode: 2B rows, no bias
        cum += pn * pn
        cases.append((f"sample stage {si}", *_bnhd(gen, 2 * BATCH, pn * pn, cum, VAR_HEADS,
                                                    bf16, dev), None, 1.0, True))
    cases.append(("teacher forcing", *_bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev),
                  tf_bias, 1.0, True))
    cases.append(("teacher forcing fp32", *_bnhd(gen, 2, ltot, ltot, VAR_HEADS, f32, dev),
                  tf_bias, 1.0, False))
    cases.append(("last stage fp32", *_bnhd(gen, 4, 121, ltot, VAR_HEADS, f32, dev),
                  None, 1.0, False))
    cases.append(("ragged", *_bnhd(gen, 3, 37, 77, 4, bf16, dev, l2=False), None, None, False))
    cases.append(("Lq=1", *_bnhd(gen, 5, 1, 2, 4, bf16, dev), None, 1.0, False))
    cases.append(("Lq=1 fp32", *_bnhd(gen, 5, 1, 2, 4, f32, dev), None, 1.0, False))
    per_bh = torch.randn((2, 4, 37, 45), generator=gen, device=dev)
    per_bh[..., 5:9] = float("-inf")
    for dtype in (bf16, f32):
        cases.append((f"per-(B,H) bias {str(dtype)[6:]}",
                      *_bnhd(gen, 2, 37, 45, 4, dtype, dev, l2=False), per_bh, None, False))
    qkv = torch.randn((4, 30, 3, VAR_HEADS, HD), generator=gen, device=dev).bfloat16()
    cases.append(("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev),
                  0.25 / math.sqrt(HD), False))
    wide = torch.randn((3, 40, 4, HD + 1), generator=gen, device=dev).bfloat16()
    cases.append(("unaligned rows", wide[:, :21, :, :HD], wide[..., :HD], wide[..., 1:],
                  None, None, False))
    main_err = 0.0
    for name, q, k, v, bias, scale, main in cases:
        got = attn.fused_attention(q, k, v, bias, scale)
        want = attn.fused_attention_reference(q, k, v, bias, scale)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
            raise AssertionError(f"[kernels] #3 {name}: non-finite output")
        err = _max_err(got, want)
        tol = TOL[q.dtype]
        print(f"[kernels] #3 {name:22s} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]:8s} bias={'none' if bias is None else tuple(bias.shape)} "
              f"max_abs_err {err:.3e} (tol {tol:g})")
        _check(f"[kernels] #3 {name}", err, tol)
        if main:
            main_err = max(main_err, err)
    return main_err


def kernels_bnhd_bwd(dev) -> float:
    """#6 against its plain version: for each of dq, dk, dv (and dbias), the
    max abs error over the max abs of the plain result. dbias sums ds over
    B*H heads with fp32 atomics in an order that changes from run to run;
    its terms are the same fp32 values as the plain version's, so it is held
    to the same bound. Returns the largest error at the training shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tf_bias = build_attn_bias(PNS).to(dev)
    ltot = tf_bias.shape[-1]
    pns16 = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)  # the default pyramid, L = 680
    cases = []  # (name, q, k, v, bias, dbias, scale, main)
    for need_db in (False, True):
        cases.append((f"training shape, dbias {'on' if need_db else 'off'}",
                      *_bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev), tf_bias, need_db,
                      1.0, True))
    cases.append(("training shape, no bias", *_bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16,
                                                   dev), None, False, 1.0, True))
    cases.append(("L=680", *_bnhd(gen, 4, 680, 680, VAR_HEADS, bf16, dev),
                  build_attn_bias(pns16).to(dev), True, 1.0, False))
    for n in (1, 37, 130):
        cases.append((f"ragged L={n}", *_bnhd(gen, 3, n, n, 4, bf16, dev, l2=False), None,
                      False, None, False))
        cases.append((f"ragged L={n}, bias", *_bnhd(gen, 3, n, n, 4, bf16, dev),
                      encoder_mask(n, n // 3, dev), True, 1.0, False))
    qkv = torch.randn((4, 30, 3, VAR_HEADS, HD), generator=gen, device=dev).bfloat16()
    cases.append(("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev),
                  True, 0.25 / math.sqrt(HD), False))
    cases.append(("training shape fp32", *_bnhd(gen, 2, ltot, ltot, VAR_HEADS, f32, dev),
                  tf_bias, True, 1.0, False))
    cases.append(("ragged L=37 fp32", *_bnhd(gen, 3, 37, 37, 4, f32, dev, l2=False), None,
                  False, None, False))
    cases.append(("L=130 fp32, bias", *_bnhd(gen, 3, 130, 130, 4, f32, dev),
                  encoder_mask(130, 43, dev), True, 1.0, False))
    main_err = 0.0
    for name, q, k, v, bias, need_db, scale, main in cases:
        g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attn.fused_attention_bwd(q, k, v, bias, g, scale, need_dbias=need_db)
        want = attn.fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias=need_db)
        torch.cuda.synchronize()
        tol = TOL[q.dtype]
        errs = {}
        for what, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            if (a is None) != (w is None):
                raise AssertionError(f"[kernels] #6 {name}: {what} is {a} against {w}")
            if w is None:
                continue
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(w).all())):
                raise AssertionError(f"[kernels] #6 {name}: non-finite {what}")
            errs[what] = _max_err(a, w) / max(w.detach().abs().max().item(), 1e-30)
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[kernels] #6 {name:28s} q {tuple(q.shape)} {str(q.dtype)[6:]:8s} "
              f"bias={'none' if bias is None else tuple(bias.shape)}: error over max |plain| "
              f"{shown} (tol {tol:g})")
        for what, e in errs.items():
            _check(f"[kernels] #6 {name} {what}", e, tol)
        if main:
            main_err = max(main_err, *errs.values())
    return main_err


def _score_gap(x: torch.Tensor, cb: torch.Tensor, maximize: bool, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """|score(a) - score(b)| per row in fp64, the score being the kernel's
    |e|^2 - 2 x.e (or -2 x.e when maximizing)."""
    x, cb = x.double(), cb.double()
    s = -2.0 * (x @ cb.T)
    if not maximize:
        s = s + cb.square().sum(-1)
    return (s.gather(1, a[:, None]) - s.gather(1, b[:, None])).abs()[:, 0]


def kernels_codebook(dev) -> float:
    """#9 against its plain version: indices equal except at near-ties,
    where the fp64 score gap must be <= NEAR_TIE. Returns the largest gap at
    the main path's shapes (0 when every index agrees)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = [(f"scale pn={pn}", BATCH * pn * pn, 4096, 32, maximize, True)
             for pn in sorted(set(PNS)) for maximize in (True, False)]
    cases += [("V off the tile", 1000, 4000, 32, True, False),
              ("C=8", 777, 4096, 8, False, False), ("C=16", 777, 1024, 16, True, False),
              ("C=64", 777, 4096, 64, True, False)]
    main_gap = 0.0
    for name, n, v, c, maximize, main in cases:
        x = torch.randn((n, c), generator=gen, device=dev)
        cb = torch.randn((v, c), generator=gen, device=dev)
        if maximize:  # the quantizer passes L2-normalised rows
            x, cb = _l2n(x), _l2n(cb)
        got = codebook.codebook_argmin(x, cb, maximize)
        want = codebook.codebook_argmin_reference(x, cb, maximize)
        torch.cuda.synchronize()
        diff = (got != want).nonzero()[:, 0]
        gap = _score_gap(x[diff], cb, maximize, got[diff], want[diff]).max().item() \
            if diff.numel() else 0.0
        print(f"[kernels] #9 {name:14s} x ({n}, {c}) codebook ({v}, {c}) "
              f"maximize={maximize!s:5s} {n - diff.numel()}/{n} equal, "
              f"max fp64 score gap {gap:.3e} (near-tie <= {NEAR_TIE:g})")
        if not (0 <= int(got.min()) and int(got.max()) < v):
            raise AssertionError(f"[kernels] #9 {name}: index out of range")
        _check(f"[kernels] #9 {name} score gap", gap, NEAR_TIE)
        if main:
            main_gap = max(main_gap, gap)
    return main_gap


def _excite_layerscale(model: torch.nn.Module, gen: torch.Generator):
    """LayerScale starts at 1e-5, which leaves every block (and its attention)
    out of the output; raise it so that the comparison sees them."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerScale):
                mod.gamma.uniform_(0.5, 1.0, generator=gen)


def phase_model_vq(dev):
    """The VQ-4096 round-trip tokenizer, card against the same weights on
    the CPU."""
    cfg = bench_margs("float32")
    gen = torch.Generator().manual_seed(SEED)
    cpu = VQModel(cfg, generator=gen, device="cpu").eval()
    _excite_layerscale(cpu, gen)
    card = copy.deepcopy(cpu).to(dev)
    x = torch.rand((2, cfg.image_size, cfg.image_size, 3), generator=gen) * 2 - 1
    with torch.inference_mode():
        h_cpu, h_card = cpu.encode(x), card.encode(x.to(dev))
        tok_cpu, tok_card = cpu.encode_to_tokens(x), card.encode_to_tokens(x.to(dev)).cpu()
        img_cpu = cpu.decode_tokens(tok_cpu)
        img_card = card.decode_tokens(tok_cpu.to(dev))
        rec_cpu = cpu.img_to_reconstructed_img(x)
        rec_card = card.img_to_reconstructed_img(x.to(dev))
    torch.cuda.synchronize()
    errs = {"latents": _max_err(h_cpu, h_card), "decode_tokens": _max_err(img_cpu, img_card)}
    diff = (tok_cpu != tok_card).nonzero()
    if diff.numel():  # only near-tied codes may differ
        q = cpu.quantize
        z = h_cpu[:, 0].reshape(-1, q.z_channels).double()
        z = z / (z.norm(dim=-1, keepdim=True) + 1e-12)
        e = q.embed(torch.arange(q.vocab_size)).double()
        d = z.square().sum(-1, keepdim=True) + e.square().sum(-1) - 2 * z @ e.T
        rows = diff[:, 0] * tok_cpu.shape[1] + diff[:, 1]
        gap = (d[rows, tok_cpu.reshape(-1)[rows]] - d[rows, tok_card.reshape(-1)[rows]]).abs()
        if not bool((gap <= NEAR_TIE).all()):
            raise AssertionError(f"[model] tokens differ beyond near-ties: {gap.tolist()}")
    else:
        errs["img_to_reconstructed_img"] = _max_err(rec_cpu, rec_card)
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] VQ-4096 fp32 B=2 card vs CPU: {shown} (tol {MODEL_TOL:g}); tokens "
          f"{tok_cpu.numel() - diff.shape[0]}/{tok_cpu.numel()} equal, "
          f"{torch.unique(tok_cpu).numel()} distinct")
    for k, v in errs.items():
        _check(f"[model] {k}", v, MODEL_TOL)


class Lockstep:
    """Runs a path on the CPU and then on the card with ``module.name``
    wrapped. The CPU run records each call's arguments and result; the card
    run compares each of its results with the CPU's, requires every entry
    that differs to be a near-tie (``gap(cpu_args, cpu_out, card_out)`` <=
    ``tol``), and hands the CPU's result on, so that one near-tie flip does
    not change everything after it."""

    def __init__(self, module, name: str, gap, tol: float):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.gap, self.tol = gap, tol
        self.calls, self.compared, self.flips, self.max_gap = [], 0, 0, 0.0

    def _run(self, fn, wrapper):
        setattr(self.module, self.name, wrapper)
        try:
            return fn()
        finally:
            setattr(self.module, self.name, self.orig)

    def on_cpu(self, fn):
        def record(*args):
            out = self.orig(*args)
            self.calls.append((args, out))
            return out
        return self._run(fn, record)

    def on_card(self, fn):
        pending = iter(self.calls)

        def replay(*args):
            got = self.orig(*args)
            cpu_args, want = next(pending)
            diff = got.cpu() != want
            self.compared += want.numel()
            if bool(diff.any()):
                gap = self.gap(cpu_args, want[diff], got.cpu()[diff], diff).max().item()
                self.max_gap = max(self.max_gap, gap)
                _check(f"[model] {self.name} flip beyond a near-tie", gap, self.tol)
                self.flips += int(diff.sum())
            return want.to(got.device)

        out = self._run(fn, replay)
        if next(pending, None) is not None:
            raise AssertionError(f"[model] the card made fewer {self.name} calls than the CPU")
        return out


def _code_gap(args, want, got, diff):
    """_codebook_lookup(rest_NC, codebook_VC, znorm): fp64 score gap."""
    rest, cb, znorm = args
    if znorm:
        rest, cb = _l2n(rest.double()), _l2n(cb.double())
    return _score_gap(rest[diff], cb, znorm, want, got)


def _logit_gap(args, want, got, diff):
    """sample_with_top_k_top_p(logits, ...) with top_k=1: the gap between
    the two picks' CFG logits."""
    lg = args[0].double()[diff]
    return (lg.gather(-1, want[:, None]) - lg.gather(-1, got[:, None])).abs()[:, 0]


def phase_model_var(dev):
    """MSVR10P2-4096 with VAR-d16 in fp32 at B=2, card against the same
    weights on the CPU."""
    margs = msvr_margs("float32")
    gen = torch.Generator().manual_seed(SEED)
    vae_cpu, var_cpu = build_vae_var(margs, VAR_DEPTH, generator=gen, device="cpu")
    _excite_layerscale(vae_cpu, gen)
    vae_cpu.eval()
    var_cpu.eval()
    vae_card, var_card = copy.deepcopy(vae_cpu).to(dev), copy.deepcopy(var_cpu).to(dev)
    x = torch.rand((2, margs.image_size, margs.image_size, 3), generator=gen) * 2 - 1
    label = torch.tensor([207, 980])
    codes = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
    picks = Lockstep(var_train, "sample_with_top_k_top_p", _logit_gap, LOGIT_NEAR_TIE)
    errs = {}
    with torch.inference_mode():
        errs["latents"] = _max_err(vae_cpu.encode(x), vae_card.encode(x.to(dev)))
        idx_cpu = codes.on_cpu(lambda: vae_cpu.img_to_idxBl(x))
        idx_card = codes.on_card(lambda: vae_card.img_to_idxBl(x.to(dev)))
        x_in = vae_cpu.idxBl_to_var_input(idx_cpu)
        x_in_card = vae_card.idxBl_to_var_input(idx_card)
        errs["var_input"] = _max_err(x_in, x_in_card)
        errs["VAR.forward logits"] = _max_err(var_cpu(label, x_in),
                                              var_card(label.to(dev), x_in_card))
        img_cpu = picks.on_cpu(lambda: var_train.var_sample(
            var_cpu, vae_cpu, label, torch.Generator().manual_seed(SEED), top_k=1))
        img_card = picks.on_card(lambda: var_train.var_sample(
            var_card, vae_card, label.to(dev), torch.Generator(device=dev).manual_seed(SEED),
            top_k=1))
        errs["var_sample images"] = _max_err(img_cpu, img_card)
    torch.cuda.synchronize()
    if tuple(img_card.shape) != tuple(x.shape):
        raise AssertionError(f"[model] var_sample images {tuple(img_card.shape)}")
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    distinct = torch.unique(torch.cat([i.reshape(-1) for b in idx_cpu for i in b])).numel()
    print(f"[model] MSVR10P2-4096 + VAR-d16 fp32 B=2 card vs CPU: {shown} "
          f"(tol {MODEL_TOL:g}); img_to_idxBl codes {codes.compared - codes.flips}/"
          f"{codes.compared} equal over {len(codes.calls)} lookups ({distinct} distinct), "
          f"max near-tie gap {codes.max_gap:.3e}; greedy var_sample tokens "
          f"{picks.compared - picks.flips}/{picks.compared} equal, max top-2 logit gap "
          f"at a flip {picks.max_gap:.3e} (<= {LOGIT_NEAR_TIE:g})")
    for k, v in errs.items():
        _check(f"[model] {k}", v, MODEL_TOL)
    return (vae_cpu, var_cpu), (vae_card, var_card)


def phase_model_train(dev, cpu_models, card_models):
    """One VARTrainer step of MSVR10P2-4096 + VAR-d16 in fp32 at B=2, card
    against CPU from the same weights (those of ``phase_model_var``): the
    loss, every parameter's gradient (max abs error over that gradient's max
    abs), the gradient norm and the updated parameters. The training masks
    are drawn once on the CPU and passed to both sides, with one class drop,
    token drops and one sample's drop path set so that each is exercised;
    the codes go in lockstep as in ``phase_model_var``."""
    gen = torch.Generator().manual_seed(SEED + 7)
    tcfg = VARTrainConfig()
    tr_cpu, tr_card = VARTrainer(*cpu_models, tcfg), VARTrainer(*card_models, tcfg)
    var_cpu, var_card = cpu_models[1], card_models[1]
    px = cpu_models[0].config.image_size
    x = torch.rand((2, px, px, 3), generator=gen) * 2 - 1
    label = torch.tensor([207, 980])
    masks = var_cpu.draw_masks(2, p_drop_factor=1.0, generator=gen)
    masks["class_drop"] = torch.tensor([False, True])
    masks["token_keep"][0, :40] = False
    masks["drop_path"][VAR_DEPTH - 1] = (torch.tensor([0.0, 1.0]), torch.tensor([1.0, 0.0]))
    masks_card = {k: v.to(dev) if torch.is_tensor(v) else
                  [None if t is None else tuple(m.to(dev) for m in t) for t in v]
                  for k, v in masks.items()}
    codes = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
    loss_cpu = codes.on_cpu(lambda: tr_cpu.loss_and_backward(x, label, masks=masks))[0]
    loss_card = codes.on_card(lambda: tr_card.loss_and_backward(
        x.to(dev), label.to(dev), masks=masks_card))[0]
    grad_errs = {}
    for (name, p_cpu), p_card in zip(var_cpu.named_parameters(), var_card.parameters()):
        if p_cpu.grad is None or p_card.grad is None:
            raise AssertionError(f"[model] {name}: no gradient (cpu {p_cpu.grad is not None}, "
                                 f"card {p_card.grad is not None})")
        grad_errs[name] = _max_err(p_card.grad, p_cpu.grad) / max(
            p_cpu.grad.abs().max().item(), 1e-30)
    worst = max(grad_errs, key=grad_errs.get)
    gn_cpu, gn_card = tr_cpu.opt.step(), tr_card.opt.step()
    torch.cuda.synchronize()
    step_err = max(_max_err(a, b) for a, b in zip(var_cpu.parameters(), var_card.parameters()))
    errs = {"loss": abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item()),
            "grad_norm": abs(gn_card.item() - gn_cpu.item()) / gn_cpu.item(),
            f"gradient of {worst}": grad_errs[worst]}
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] VARTrainer step fp32 B=2 card vs CPU (relative): {shown} (tol {MODEL_TOL:g}; "
          f"{len(grad_errs)} parameter gradients, median error "
          f"{statistics.median(grad_errs.values()):.3e}); loss {loss_cpu.item():.6f}, grad norm "
          f"{gn_cpu.item():.6f}; updated parameters max abs diff {step_err:.3e}; codes "
          f"{codes.compared - codes.flips}/{codes.compared} equal")
    for k, v in errs.items():
        _check(f"[model] {k}", v, MODEL_TOL)
    _check("[model] updated parameters", step_err, MODEL_TOL)


class KinkLockstep(torch.overrides.TorchFunctionMode):
    """The branches of the GAN step's piecewise-linear ops, in lockstep:
    ``F.relu`` and ``F.max_pool2d`` (LPIPS's VGG, the hinge and LeCam
    losses) and ``F.leaky_relu`` (DinoDisc's heads). Under ``record()`` (the
    CPU run) each call keeps its branch, the positive mask or the max-pool
    argmax; under ``replay()`` (the card run) each call computes its own
    branch, requires every element where it differs from the CPU's to be a
    near-tie (the input within ``tol`` of the tensor's max abs of the kink,
    or the two pooled values that close), and then takes the CPU's branch,
    in the forward and in the gradient. Without it an fp32 rounding
    difference that moves one of millions of VGG or head activations across
    0 sends a different gradient down that element, and the per-position
    gradients (``pos_embed``) or those behind a BatchNormLocal then differ
    by more than rounding. Both runs compute ``x * where(mask, 1, slope)``
    and a gather at the argmax, which equal the library ops in value and
    gradient."""

    def __init__(self, tol: float):
        super().__init__()
        self.tol, self.branches, self.pending = tol, [], None
        self.calls, self.compared, self.flips, self.max_gap = 0, 0, 0, 0.0

    def record(self):
        self.pending = None
        return self

    def replay(self):
        self.pending = iter(self.branches)
        return self

    def _cpu_branch(self, own: torch.Tensor, gap) -> torch.Tensor:
        if self.pending is None:
            self.branches.append(own.cpu())
            return own
        want = next(self.pending).to(own.device)
        diff = own != want
        self.calls += 1
        self.compared += want.numel()
        if bool(diff.any()):
            g = gap(diff, want)
            self.max_gap = max(self.max_gap, g)
            _check("[model] piecewise-linear branch flip beyond a near-tie", g, self.tol)
            self.flips += int(diff.sum())
        return want

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (F.relu, F.leaky_relu):
            x = args[0]
            slope = 0.0 if func is F.relu else (args[1] if len(args) > 1 else
                                                kwargs.get("negative_slope", 0.01))
            xd = x.detach()
            mask = self._cpu_branch(
                xd > 0, lambda d, _: (xd[d].abs().max() / xd.abs().max().clamp_min(1e-30)).item())
            return x * torch.where(mask, 1.0, slope).to(x.dtype)
        if func is F.max_pool2d:
            x, k = args[0], args[1]
            out, idx = F.max_pool2d(x, k, return_indices=True)
            n, c = out.shape[:2]

            def pooled(i):
                return x.reshape(n, c, -1).gather(2, i.reshape(n, c, -1)).reshape(out.shape)

            idx = self._cpu_branch(idx, lambda d, want: (
                (out - pooled(want)).detach()[d].abs().max() / x.detach().abs().max()).item())
            return pooled(idx)
        return func(*args, **kwargs)


def _to(obj, dev):
    """Tensors in nested dicts and tuples, moved to ``dev``."""
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to(v, dev) for v in obj)
    return obj.to(dev) if torch.is_tensor(obj) else obj


def gan_draws(batch: int, px: int, gen: torch.Generator) -> dict:
    """Every random draw of one ``TokenizerTrainer.train_step``, made on the
    CPU: the quantizer dropout, the three DiffAug calls (generator pass, fake
    and real images of the disc pass) and the disc's crop-or-resize."""
    cpu = torch.device("cpu")
    return {"dropout_n": torch.randint(3, len(PNS) + 1, (batch,), generator=gen),
            **{k: draw_aug(batch, gen, cpu) for k in ("aug_g", "aug_f", "aug_r")},
            "crop": draw_crop(px, gen, cpu)}


# zero in exact arithmetic: a conv bias that BatchNormLocal's mean removes
ZERO_GRAD = r"heads\.\d+\.b\d\.conv\.bias"
ZERO_GRAD_TOL = 1e-4  # of the max abs gradient of the same conv's weight


def _grad_errs(what: str, named_cpu, params_card, trainable: list) -> tuple:
    """Each trainable parameter's gradient, card against CPU: the max abs
    error over the CPU gradient's max abs. Every trainable parameter must
    have a gradient (AdamW would skip one that has none, optax decays it). A
    gradient that is zero in exact arithmetic (``ZERO_GRAD``) is held, on
    both sides, to ``ZERO_GRAD_TOL`` of its weight's gradient instead."""
    named_cpu = list(named_cpu)
    trainable = {id(p) for p in trainable}
    weight_max = {n: p.grad.abs().max().item() for n, p in named_cpu
                  if p.grad is not None and n.endswith(".weight")}
    errs, zero = {}, {}
    for (name, p_cpu), p_card in zip(named_cpu, params_card):
        if id(p_cpu) not in trainable:
            if p_cpu.grad is not None or p_card.grad is not None:
                raise AssertionError(f"[model] {what} {name}: frozen, but has a gradient")
            continue
        if p_cpu.grad is None or p_card.grad is None:
            raise AssertionError(f"[model] {what} {name}: no gradient (cpu "
                                 f"{p_cpu.grad is not None}, card {p_card.grad is not None})")
        if re.fullmatch(ZERO_GRAD, name):
            ref = weight_max[name[:-len("bias")] + "weight"]
            zero[name] = max(p_cpu.grad.abs().max().item(),
                             p_card.grad.abs().max().item()) / ref
            _check(f"[model] {what} {name} (zero in exact arithmetic)", zero[name],
                   ZERO_GRAD_TOL)
            continue
        errs[name] = _max_err(p_card.grad, p_cpu.grad) / max(
            p_cpu.grad.abs().max().item(), 1e-30)
    return errs, zero


def phase_model_gan(dev):
    """Two ``TokenizerTrainer`` steps of the flagship GAN recipe in fp32 at
    B=2 (MSVR10P2-4096 with the DINOv2 ViT-B teacher, LPIPS VGG16, DinoDisc
    ViT-S/16 at depth 12, remat on), card against CPU from the same weights,
    with every random draw made once on the CPU and given to both sides
    (``train_step(draws=...)``; the first step takes the disc's crop, the
    second its area resize). Held: every metric (loss terms, ``gen_loss``,
    ``disc_loss``, the adaptive weight, both pre-clip gradient norms) within
    ``MODEL_TOL`` of max(|CPU value|, 1); after the first step every
    trainable parameter's gradient of the generator and of the disc heads
    within ``MODEL_TOL`` of its max abs; after the second (the first lr of
    both schedules is 0) the updated parameters and the spectral-norm state.
    The codes go in lockstep as in ``phase_model_var``, and the branches of
    the piecewise-linear ops as ``KinkLockstep`` says."""
    mcfg, tcfg = flagship_gan_recipe(2, margs_overrides={"dtype_str": "float32"},
                                     tcfg_overrides={"loss_dtype": "float32"})
    gen = torch.Generator().manual_seed(SEED + 4)
    tr_cpu = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED),
                              device="cpu")
    _excite_layerscale(tr_cpu.model, gen)
    tr_cpu.sync_ema()
    tr_card = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED),
                               device=dev)
    for name in ("model", "lpips", "disc"):
        getattr(tr_card, name).load_state_dict(getattr(tr_cpu, name).state_dict())
    tr_card.sync_ema()
    px = mcfg.image_size
    x = torch.rand((2, px, px, 3), generator=gen) * 2 - 1
    shown, compared, flips, kink_flips, kink_gap = [], 0, 0, 0, 0.0
    for step in range(2):
        draws = gan_draws(2, px, gen)
        if draws["crop"] is not None:  # above 224 px
            draws["crop"] = (torch.tensor(step == 0), *draws["crop"][1:])
        codes = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
        kinks = KinkLockstep(KINK_NEAR_TIE)
        with kinks.record():
            m_cpu = codes.on_cpu(lambda: tr_cpu.train_step(x, draws=draws))
        with kinks.replay():
            m_card = codes.on_card(lambda: tr_card.train_step(x.to(dev),
                                                              draws=_to(draws, dev)))
        if kinks.calls != len(kinks.branches):
            raise AssertionError(f"[model] the card made {kinks.calls} piecewise-linear calls, "
                                 f"the CPU {len(kinks.branches)}")
        compared, flips = compared + codes.compared, flips + codes.flips
        kink_flips, kink_gap = kink_flips + kinks.flips, max(kink_gap, kinks.max_gap)
        torch.cuda.synchronize()
        if sorted(m_cpu) != sorted(m_card):
            raise AssertionError(f"[model] GAN step metrics {sorted(m_card)}")
        for k, want in m_cpu.items():
            err = _max_err(m_card[k], want) / max(want.abs().max().item(), 1.0)
            _check(f"[model] GAN step {step} {k}", err, MODEL_TOL)
        worst_m = max(m_cpu, key=lambda k: _max_err(m_card[k], m_cpu[k]))
        shown.append(f"step {step}: " + ", ".join(
            f"{k} {m_cpu[k].item():.6f}" for k in ("gen_loss", "disc_loss",
                                                   "disc_adaptive_weight", "grad_norm",
                                                   "disc_grad_norm"))
            + f", worst metric {worst_m} abs err {_max_err(m_card[worst_m], m_cpu[worst_m]):.3e}")
        if step == 0:
            g_errs, g_zero = _grad_errs("generator", tr_cpu.model.named_parameters(),
                                        tr_card.model.parameters(), tr_cpu.gen_opt.params)
            d_errs, d_zero = _grad_errs("disc", tr_cpu.disc.named_parameters(),
                                        tr_card.disc.parameters(), tr_cpu.disc_opt.params)
    step_err = max(_max_err(a, b) for a, b in zip(
        [*tr_cpu.model.state_dict().values(), *tr_cpu.disc.state_dict().values()],
        [*tr_card.model.state_dict().values(), *tr_card.disc.state_dict().values()]))
    print(f"[model] GAN step (flagship recipe) fp32 B=2 card vs CPU: "
          + "; ".join(shown) + f" (tol {MODEL_TOL:g} of max(|value|, 1))")
    for what, errs, zero in (("generator", g_errs, g_zero), ("disc heads", d_errs, d_zero)):
        worst = max(errs, key=errs.get)
        print(f"[model] GAN step {what}: {len(errs)} parameter gradients within "
              f"{errs[worst]:.3e} of their max abs (worst {worst}, median "
              f"{statistics.median(errs.values()):.3e}; tol {MODEL_TOL:g})"
              + (f"; {len(zero)} zero in exact arithmetic at most {max(zero.values()):.3e} of "
                 f"their weight's (tol {ZERO_GRAD_TOL:g})" if zero else ""))
        _check(f"[model] GAN step {what} gradient of {worst}", errs[worst], MODEL_TOL)
    print(f"[model] GAN step after two steps: parameters and spectral state max abs diff "
          f"{step_err:.3e} (tol {MODEL_TOL:g}); codes {compared - flips}/{compared} equal; "
          f"{kink_flips} relu, leaky-relu or max-pool elements took the CPU's branch, max "
          f"near-tie gap {kink_gap:.3e} (<= {KINK_NEAR_TIE:g} of the tensor's max abs)")
    _check("[model] GAN step updated parameters", step_err, MODEL_TOL)


def time_calls(path: str, fn, iters: int, per_call: dict, dev) -> dict:
    """One warm-up call, then ``iters`` calls between CUDA events, with the
    launch counters set to 0 just before and read just after."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    reset_counts()
    events[0].record()
    for i in range(iters):
        out = fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = check_launches(path, iters, per_call)
    per_iter = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return {"out": out, "ms": statistics.median(per_iter), "min": per_iter[0],
            "max": per_iter[-1], "iters": iters, "peak": torch.cuda.max_memory_allocated(dev),
            "launches": launches}


def _report(path: str, r: dict, batch: int, what: str):
    per_call = {k: v // r["iters"] for k, v in r["launches"].items() if v}
    print(f"[main] {path} B={batch} bf16: median {r['ms']:.3f} ms/batch (min {r['min']:.3f}, "
          f"max {r['max']:.3f}, {r['iters']} calls), {batch / r['ms'] * 1e3:.1f} img/s; peak "
          f"{r['peak'] / 2**30:.2f} GiB allocated; launches per call {per_call}; {what}")


def main_round_trip(dev) -> dict:
    cfg = bench_margs("bfloat16")
    px, nl, vocab = cfg.image_size, cfg.num_latent_tokens, cfg.codebook_size
    model = VQModel(cfg, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    x = torch.rand((BATCH, px, px, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    per_call = {"attention_qkv_fwd": len(model.encoder.model.blocks)
                + len(model.decoder.model.blocks)}  # 24
    with torch.inference_mode():
        r = time_calls("round trip", lambda: model.img_to_reconstructed_img(x), 10,
                       per_call, dev)
        tokens = model.encode_to_tokens(x)
        rec = model.decode_tokens(tokens)
        torch.cuda.synchronize()
    y = r["out"]
    if tuple(y.shape) != (BATCH, px, px, 3) or y.dtype != torch.float32:
        raise AssertionError(f"[main] round trip output {tuple(y.shape)} {y.dtype}")
    if not (bool(torch.isfinite(y).all()) and y.abs().max().item() <= 1.0):
        raise AssertionError("[main] round trip output not finite or outside [-1, 1]")
    if tuple(tokens.shape) != (BATCH, nl) or not (
            0 <= tokens.min().item() and tokens.max().item() < vocab):
        raise AssertionError(f"[main] tokens {tuple(tokens.shape)} "
                             f"in [{tokens.min().item()}, {tokens.max().item()}]")
    if tuple(rec.shape) != (BATCH, px, px, 3) or not bool(torch.isfinite(rec).all()):
        raise AssertionError("[main] decode_tokens output malformed")
    _report("VQ-4096 img_to_reconstructed_img", r, BATCH,
            f"tokens {tuple(tokens.shape)} in [{tokens.min().item()}, "
            f"{tokens.max().item()}], {torch.unique(tokens).numel()} distinct")
    return r


def main_var_paths(dev) -> dict:
    """var_sample, img_to_idxBl and VAR.forward of MSVR10P2-4096 + VAR-d16 in
    bf16 at B=64."""
    margs = msvr_margs("bfloat16")
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    vae.eval()
    var.eval()
    n_enc, n_dec = len(vae.encoder.model.blocks), len(vae.decoder.model.blocks)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.arange(BATCH, device=dev) % 1000
    out = {}

    out["var_sample"] = r = time_calls(
        "var_sample", lambda: var_train.var_sample(var, vae, labels, gen, cfg_scale=1.5,
                                                   top_k=900, top_p=0.96),
        5, {"fused_attention_fwd": VAR_DEPTH * len(PNS), "attention_qkv_fwd": n_dec}, dev)
    img = r["out"]
    px = margs.image_size
    if tuple(img.shape) != (BATCH, px, px, 3) or not (
            bool(torch.isfinite(img).all()) and 0 <= img.min().item()
            and img.max().item() <= 1):
        raise AssertionError("[main] var_sample images malformed")
    _report("var_sample(cfg 1.5, top-k 900, top-p 0.96)", r, BATCH,
            f"images {tuple(img.shape)} in [{img.min().item():.3f}, {img.max().item():.3f}]")

    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        out["img_to_idxBl"] = r = time_calls(
            "img_to_idxBl", lambda: vae.img_to_idxBl(x), 10,
            {"codebook_argmin": margs.product_quant * len(PNS), "attention_qkv_fwd": n_enc},
            dev)
        idx = r["out"]
        shapes = [[tuple(i.shape) for i in b] for b in idx]
        if shapes != [[(BATCH, pn * pn) for pn in PNS]] * margs.product_quant or not all(
                0 <= int(i.min()) and int(i.max()) < margs.codebook_size
                for b in idx for i in b):
            raise AssertionError(f"[main] img_to_idxBl codes malformed: {shapes}")
        distinct = torch.unique(torch.cat([i.reshape(-1) for b in idx for i in b])).numel()
        _report("img_to_idxBl", r, BATCH,
                f"2 branches x {len(PNS)} scales of codes, {distinct} distinct")

        x_in = vae.idxBl_to_var_input(idx)
        out["VAR.forward"] = r = time_calls(
            "VAR.forward", lambda: var(labels, x_in), 10, {"fused_attention_fwd": VAR_DEPTH},
            dev)
        logits = r["out"]
        if tuple(logits.shape) != (BATCH, var.config.L, var.config.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("[main] VAR.forward logits malformed")
        _report("VAR.forward (teacher forcing, block-causal bias)", r, BATCH,
                f"logits {tuple(logits.shape)}")
    return out


def main_train_paths(dev) -> dict:
    """VARTrainer.train_step and eval_step of MSVR10P2-4096 + VAR-d16 in bf16
    at B=64, ``VARTrainConfig()`` defaults, the training masks drawn from a
    seeded generator on the card."""
    margs = msvr_margs("bfloat16")
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    tr = VARTrainer(vae, var, VARTrainConfig(),
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    n_enc = len(vae.encoder.model.blocks)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    px = margs.image_size
    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    encode = {"codebook_argmin": margs.product_quant * len(PNS), "attention_qkv_fwd": n_enc}
    out = {}
    before = [p.detach().clone() for p in var.parameters()]
    out["train_step"] = r = time_calls(
        "train_step", lambda: tr.train_step(x, labels), 10,
        {**encode, "fused_attention_fwd": VAR_DEPTH, "fused_attention_bwd": VAR_DEPTH}, dev)
    m = {k: v.item() for k, v in r["out"].items()}
    # every parameter with a gradient moves; empty_emb has none while token
    # dropout is off (p_drop_factor 0), and is in the no-decay group
    trained = [p.grad is not None for p in var.parameters()]
    changed = [not torch.equal(a, b) for a, b in zip(before, var.parameters())]
    if not (all(math.isfinite(v) for v in m.values()) and changed == trained):
        raise AssertionError(f"[main] train_step metrics {m}, {sum(changed)} parameters "
                             f"changed, {sum(trained)} have a gradient")
    _report("VARTrainer.train_step (VARTrainConfig())", r, BATCH,
            ", ".join(f"{k} {v:.4f}" for k, v in m.items())
            + f"; {sum(changed)}/{len(before)} parameter tensors changed over 11 steps, "
            "each one that has a gradient")
    del before
    out["eval_step"] = r = time_calls(
        "eval_step", lambda: tr.eval_step(x, labels), 10,
        {**encode, "fused_attention_fwd": VAR_DEPTH}, dev)
    ev = r["out"]
    if sorted(ev) != ["L_mean", "L_tail", "acc_mean", "acc_tail"] or not all(
            tuple(t.shape) == (BATCH,) and bool(torch.isfinite(t).all()) for t in ev.values()):
        raise AssertionError("[main] eval_step outputs malformed")
    _report("VARTrainer.eval_step", r, BATCH,
            ", ".join(f"{k} mean {t.mean().item():.4f}" for k, t in ev.items()))
    return out


def gan_launches(tr: TokenizerTrainer) -> dict:
    """Kernel launches of one flagship GAN ``train_step``, from the code: #1
    in the encoder and decoder (each block again in the backward: remat), the
    teacher, DinoDisc in the generator pass and on the fake and real images;
    #2 in the backward of DinoDisc's trunk (for the adaptive weight's
    gradient of g_adv, then in the generator's backward) and of the decoder
    and encoder (the teacher is frozen, and the disc pass's trunk sees no
    input that needs a gradient; a trunk block after the deepest readout
    gets no gradient); #9 in every scale of both branches."""
    m, cfg = tr.model, tr.model_cfg
    enc, dec = len(m.encoder.model.blocks), len(m.decoder.model.blocks)
    sem, disc = len(m.semantic_model.blocks), len(tr.disc.dino.blocks)
    disc_bwd = max(tr.disc.kd) + 1 if tr.disc.kd else 0
    remat = 2 if cfg.remat else 1
    return {"attention_qkv_fwd": remat * (enc + dec) + sem + 3 * disc,
            "attention_qkv_bwd": enc + dec + 2 * disc_bwd,
            "codebook_argmin": cfg.product_quant * len(cfg.v_patch_nums)}


def main_gan_paths(dev) -> dict:
    """``TokenizerTrainer.train_step`` of the flagship GAN recipe at B=64,
    bf16 activations and a bf16 loss stack (``bench.py``'s train leg), from
    seeded random weights and draws on the card: exact launches, finite
    metrics, every trainable parameter changed after the timed steps (the
    warm-up step's lr is 0) and every frozen one (the teacher, the VGG,
    DinoDisc's trunk) bit-unchanged."""
    mcfg, tcfg = flagship_gan_recipe(BATCH, tcfg_overrides={"loss_dtype": "bfloat16"})
    tr = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    px = mcfg.image_size
    x = torch.rand((BATCH, px, px, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    named = [*(("model." + n, p) for n, p in tr.model.named_parameters()),
             *(("lpips." + n, p) for n, p in tr.lpips.named_parameters()),
             *(("disc." + n, p) for n, p in tr.disc.named_parameters())]
    before = {n: p.detach().clone() for n, p in named}
    r = time_calls("GAN train_step", lambda: tr.train_step(x), 10, gan_launches(tr), dev)
    m = {k: v.float().mean().item() for k, v in r["out"].items()}
    changed = {n: not torch.equal(before[n], p) for n, p in named}
    trainable = {n: p.requires_grad for n, p in named}
    frozen = sum(not t for t in trainable.values())
    if not (all(math.isfinite(v) for v in m.values()) and changed == trainable):
        bad = sorted(n for n in changed if changed[n] != trainable[n])
        raise AssertionError(f"[main] GAN train_step metrics {m}; changed != trainable at "
                             f"{bad[:10]} ({len(bad)})")
    del before
    _report("TokenizerTrainer.train_step (flagship GAN recipe)", r, BATCH,
            ", ".join(f"{k} {v:.4f}" for k, v in m.items())
            + f"; {sum(changed.values())} trainable parameter tensors changed over 11 steps, "
            f"{frozen} frozen ones (teacher, VGG, DinoDisc trunk) unchanged")
    return {"GAN train_step": r}


def _time_ms(fn, reps: int = 20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_kernel(name: str, kernel, plain, library, nbytes: float, ops: float,
                 dtype: torch.dtype, shape: str) -> dict:
    """Kernel and plain version in the order plain, kernel, kernel, plain;
    then the library call; beside the bound for the same work."""
    with torch.inference_mode():
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
    lib = _time_ms(library)  # outside inference mode: a library backward needs autograd
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    b_ms, by = bound_ms(nbytes, ops, dtype)
    print(f"[times] {name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
          f"(order plain, kernel, kernel, plain), library {lib:.4f} ms; bound {b_ms:.4f} ms "
          f"by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G ops); kernel at "
          f"{b_ms / k_ms * 100:.1f}% of the bound")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": by}


def phase_times(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    out = {}

    # 1: the VQ-4096 decoder's shape
    b, n, h = BATCH, 514, HEADS
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(bf16)
    q, k, v = qkv.view(b, n, 3, h, HD).permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, hd) views
    out["attention_qkv_fwd"] = _time_kernel(
        "#1 attention_qkv", lambda: attn.attention_qkv(qkv, h),
        lambda: attn.attention_qkv_reference(qkv, h),
        lambda: F.scaled_dot_product_attention(q, k, v),
        (qkv.numel() + b * n * h * HD) * 2, 4 * b * h * n * n * HD, bf16, str(tuple(qkv.shape)))

    # 2: the encoder's shape, no bias (as the GAN step); the library call is
    # the backward only of SDPA on the q, k, v views of the same qkv
    b, n, h = BATCH, 499, HEADS
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(bf16)
    g = torch.randn((b, n, HD * h), generator=gen, device=dev).to(bf16)
    lq, lk, lv = (t.detach().requires_grad_()
                  for t in qkv.view(b, n, 3, h, HD).permute(2, 0, 3, 1, 4).unbind(0))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    lib_g = g.view(b, n, h, HD).transpose(1, 2)
    out["attention_qkv_bwd"] = _time_kernel(
        "#2 attention_qkv backward", lambda: attn.attention_qkv_bwd(qkv, h, None, g),
        lambda: attn.attention_qkv_bwd_reference(qkv, h, None, g),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        (2 * qkv.numel() + g.numel()) * 2, 5 * 2 * b * h * n * n * HD, bf16,
        f"qkv {tuple(qkv.shape)}, g {tuple(g.shape)}")
    del lib_out, lq, lk, lv

    # 3: the last sampling stage (most bytes of the path), then teacher forcing
    ltot = sum(p * p for p in PNS)
    for name, (b, lq, lk), bias in (
            ("#3 fused_attention, last sampling stage", (2 * BATCH, PNS[-1] ** 2, ltot), None),
            ("#3 fused_attention, teacher forcing", (BATCH, ltot, ltot),
             build_attn_bias(PNS).to(dev))):
        q, k, v = _bnhd(gen, b, lq, lk, VAR_HEADS, bf16, dev)
        pairs = lq * lk if bias is None else int(torch.isfinite(bias).sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (
            0 if bias is None else bias.numel() * 4)
        rec = _time_kernel(
            name, lambda: attn.fused_attention(q, k, v, bias, 1.0),
            lambda: attn.fused_attention_reference(q, k, v, bias, 1.0),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=None if bias is None else bias.to(bf16), scale=1.0),
            nbytes, 4 * b * VAR_HEADS * pairs * HD, bf16,
            f"q {tuple(q.shape)} k {tuple(k.shape)}")
        out.setdefault("fused_attention_fwd", rec)

    # 6: the training shape, block-causal bias, no dbias (as the train step)
    bias = build_attn_bias(PNS).to(dev)
    q, k, v = _bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias.to(bf16), scale=1.0)
    lib_g = g.transpose(1, 2)
    pairs = int(torch.isfinite(bias).sum())
    out["fused_attention_bwd"] = _time_kernel(
        "#6 fused_attention backward, training shape",
        lambda: attn.fused_attention_bwd(q, k, v, bias, g, 1.0, need_dbias=False),
        lambda: attn.fused_attention_bwd_reference(q, k, v, bias, g, 1.0, need_dbias=False),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        7 * q.numel() * 2 + bias.numel() * 4, 5 * 2 * BATCH * VAR_HEADS * pairs * HD, bf16,
        f"q, k, v, g {tuple(q.shape)}")

    # 9: the last scale of a B=64 encode
    n, vsz, c = BATCH * PNS[-1] ** 2, 4096, 32
    x = _l2n(torch.randn((n, c), generator=gen, device=dev))
    cb = _l2n(torch.randn((vsz, c), generator=gen, device=dev))
    out["codebook_argmin"] = _time_kernel(
        "#9 codebook_argmin", lambda: codebook.codebook_argmin(x, cb, True),
        lambda: codebook.codebook_argmin_reference(x, cb, True),
        lambda: torch.argmax(x @ cb.T, dim=-1),
        (n * c + vsz * c) * 4 + n * 8, 2 * n * vsz * c, torch.float32,
        f"x ({n}, {c}) codebook ({vsz}, {c})")
    return out


KERNELS = {
    "attention_qkv_fwd": ("imagefolder_tpu_torch/csrc/attention_qkv.cu",
                          "imagefolder_tpu/ops/pallas/attention.py:93"),
    "attention_qkv_bwd": ("imagefolder_tpu_torch/csrc/attention_qkv_bwd.cu",
                          "imagefolder_tpu/ops/pallas/attention.py:223"),
    "fused_attention_fwd": ("imagefolder_tpu_torch/csrc/attention_bnhd.cu",
                            "imagefolder_tpu/ops/pallas/attention.py:374"),
    "fused_attention_bwd": ("imagefolder_tpu_torch/csrc/attention_bnhd_bwd.cu",
                            "imagefolder_tpu/ops/pallas/attention.py:708"),
    "codebook_argmin": ("imagefolder_tpu_torch/csrc/codebook_argmin.cu",
                        "imagefolder_tpu/ops/pallas/codebook.py:62"),
}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # fp32 on the card means fp32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    errs = {"attention_qkv_fwd": kernels_qkv(dev), "attention_qkv_bwd": kernels_qkv_bwd(dev),
            "fused_attention_fwd": kernels_bnhd(dev),
            "fused_attention_bwd": kernels_bnhd_bwd(dev),
            "codebook_argmin": kernels_codebook(dev)}
    phase_model_vq(dev)
    phase_model_train(dev, *phase_model_var(dev))
    phase_model_gan(dev)
    paths = {"round trip": main_round_trip(dev), **main_var_paths(dev),
             **main_train_paths(dev), **main_gan_paths(dev)}
    times = phase_times(dev)
    records = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {p: r["launches"][name] for p, r in paths.items() if r["launches"][name]}
        if not by_path:
            raise AssertionError(f"{name} never launched on a main path")
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": errs[name], **times[name]})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
