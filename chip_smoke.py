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
     without dbias, ragged, in fp32 and through autograd (fp32, and bf16 at
     the encoder's shape, where the forward saves its output and lse for the
     backward), BNHD attention (#3)
     at every VAR sampling stage, the teacher-forcing shape and edge cases, its
     backward (#6) at the training shape with and without dbias, without a
     bias, at L = 680, ragged, on strided views and in fp32, the q-blocked
     attention (#4) and its backward (#5) at the 512 px shapes (VAR's L = 2240
     under the block-causal bias, the tokenizer's packed views at N = 2050 and
     3073), ragged past the JAX package's caps, in fp32 and, for #5, with
     dbias and through autograd (fp32, and bf16 at VAR's training shape), the
     two pieces of the bf16 backward of #2 and #5 (the blank-tile map, exact,
     on VAR's 512 px bias and the ragged encoder masks; the forwards' lse,
     whose store leaves the output unchanged), the codebook search (#9) at every scale of
     both multi-scale encodes, and the fused sublayers: attention (#7) at the
     ViT-B decoder's and encoder's and at ViT-S width, the MLP (#8) at ViT-B
     and ViT-S width, the MLP probe (#10) at scripts/perf.py's shape, each
     ragged, with res = 0 and in fp32, LayerScale of order 1, #7 and #8
     through autograd, and the wrappers' refusals;
  4. models, card against CPU in fp32 from one seed: the VQ-4096 ViT-B
     tokenizer at B=2, then its decode and round trip with the fused
     sublayers on the card; RAR-B at full width with CFG, B=2, the same
     Gumbel noise on both sides, and its tokens decoded by that tokenizer
     (RobustTok at inference) fused on the card; for MSVR10P2-4096 and
     MSVR10P2-4096-512, each with VAR-d16, ``img_to_idxBl`` codes per scale,
     the round trip image, ``VAR.forward`` logits, greedy ``var_sample``
     tokens and images, then one ``VARTrainer`` step's loss, every
     parameter's gradient, the gradient norm and the updated parameters,
     with the same training masks on both sides; two flagship GAN
     ``TokenizerTrainer`` steps (every metric, every trainable gradient of
     the generator and the disc heads, the updated parameters, with the same
     random draws on both sides); a code or token may differ only at a
     near-tie, and the card then goes on from the CPU's choice;
  5. main paths in bf16, timed with CUDA events (a warm-up call, then
     median, min and max), each with every launch counter set to 0 just
     before its timed calls and read just after: at B=64 the VQ-4096 round
     trip, composed and then fused (``round trip fused``); RAR sampling
     (``rar sample``: ``rar_generate`` with CFG and the fused RobustTok
     decode; then the generator and the decode alone); the MLP probe (12
     chained #10 calls at scripts/perf.py's shape); for both multi-scale
     configurations ``var_sample`` (cfg 1.5, top-k 900, top-p 0.96; at 256 px
     decoded by bench.py's sample-leg tokenizer, ViT-S), ``img_to_idxBl``,
     the teacher-forcing ``VAR.forward``, ``VARTrainer.train_step`` (B=16 at
     512 px) and ``eval_step``, and the 512 px round trip; and the flagship
     GAN ``TokenizerTrainer.train_step``;
  6. times: each kernel (#2 and #5 as training calls them, with the
     forward's saved output and lse; #1 and #4 also with the lse store on),
     its plain version (order plain, kernel, kernel,
     plain) and one PyTorch library call computing the same function (for
     #2, #5 and #6, the backward of ``scaled_dot_product_attention``; for #7
     and #8, which no one call computes, the composed path; for #10 none),
     at the main paths' largest shapes, beside the card's bound for that
     work.
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
from imagefolder_tpu_torch.models import build_rar, build_vae_var
from imagefolder_tpu_torch.models import rar as rar_mod
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.models.vit import LayerScale, set_fused_sublayers
from imagefolder_tpu_torch.ops import quantize
from imagefolder_tpu_torch.ops.cuda import _build
from imagefolder_tpu_torch.ops.cuda import attention as attn
from imagefolder_tpu_torch.ops.cuda import block
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
PNS512 = (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)  # the 512 px pyramid, L = 2240
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
# bf16 forward outputs (#1, #3, #4) are also held per element to BF16_REL of
# the plain value (a bf16 ulp is at most 2^-7 of its value, and each side
# rounds its output once) plus ROW_SHARE of the RMS of its output row (one
# head's 64 values at one position)
BF16_REL = 2.0 ** -7
ROW_SHARE = 2.0 ** -5
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
    "fused_attention_qblk_fwd": (attn, "QBLK_LAUNCHES"),
    "fused_attention_qblk_bwd": (attn, "QBLK_BWD_LAUNCHES"),
    "codebook_argmin": (codebook, "LAUNCHES"),
    "attn_sublayer_fused": (block, "SUBLAYER_ATTN_LAUNCHES"),
    "mlp_sublayer_fused": (block, "SUBLAYER_MLP_LAUNCHES"),
    "fused_mlp": (block, "FUSED_MLP_LAUNCHES"),
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
    VQ-4096, DINOv2 ViT-B/16 encoder and decoder, 256 px, 256 latents. It is
    also RobustTok at inference (``configs/RobustTok.yaml``, the tokenizer of
    ``configs/generator/robustTok-rar.yaml:22-41``; its DINOv2 teacher feeds
    only training losses and is left out), which decodes RAR's tokens."""
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
    are left out. The model checks, teacher forcing and training use it;
    the 256 px sampling leg uses ``bench_sample_margs``."""
    return ModelArgs(
        codebook_size=4096, codebook_embed_dim=32, v_patch_nums=PNS,
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_base_patch14_dinov2.lvd142m",
        decoder_model="vit_base_patch14_dinov2.lvd142m",
        semantic_guide="none", detail_guide="none", num_latent_tokens=121,
        product_quant=2, abs_pos_embed=True, image_size=256, dtype_str=dtype_str)


def bench_sample_margs(dtype_str: str) -> ModelArgs:
    """The tokenizer of bench.py's sample leg (``bench.py:256-264``):
    ``msvr_margs`` with DINOv2 ViT-S/14 encoder and decoder (width 384, 6
    heads of 64, depth 12), 121 latents per PQ branch, a 4096 x 32 codebook
    per branch, 256 px."""
    return ModelArgs(
        codebook_size=4096, codebook_embed_dim=32, v_patch_nums=PNS,
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_small_patch14_dinov2.lvd142m",
        decoder_model="vit_small_patch14_dinov2.lvd142m",
        semantic_guide="none", detail_guide="none", num_latent_tokens=121,
        product_quant=2, abs_pos_embed=True, image_size=256, dtype_str=dtype_str)


def msvr512_margs(dtype_str: str) -> ModelArgs:
    """MSVR10P2-4096-512: ``msvr_margs`` at 512 px over the 512 px pyramid,
    with a 32 x 32 grid of 1024 latents per branch: the JAX package's 512 px
    recipe (``scripts/soak.py:76-81``, after upstream VAR's
    ``arg_util.py:287-291``). Under VAR-d16 L = 2240; the encoder's N = 1 +
    1024 + 2 * 1024 = 3073, the decoder's 1 + 1024 + 1 + 1024 = 2050. Nothing
    is cut."""
    return ModelArgs(
        codebook_size=4096, codebook_embed_dim=32, v_patch_nums=PNS512,
        enc_type="dinov2", dec_type="dinov2",
        encoder_model="vit_base_patch14_dinov2.lvd142m",
        decoder_model="vit_base_patch14_dinov2.lvd142m",
        semantic_guide="none", detail_guide="none", num_latent_tokens=PNS512[-1] ** 2,
        product_quant=2, abs_pos_embed=True, image_size=512, dtype_str=dtype_str)


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


def _fwd_check(what: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, str]:
    """A forward kernel's output against its plain version's: both finite,
    the max abs error within TOL, and in bf16 every element's error within
    BF16_REL * |plain| + ROW_SHARE * (the RMS of its head's 64 outputs at
    that position). The per-element bound follows the size of the values: a
    typical 512 px output (~0.03) is smaller than TOL's 2e-2, which the few
    large early VAR rows set. The row term covers what the order of the
    fp32 sums and p's rounding against a running max leave before the
    output's rounding. tests/test_torch_smoke_checks.py holds this check
    against a CPU model of the kernels' tiled numerics, which must pass,
    and against the model with a fault planted (the last k/v tile dropped,
    the rescale skipped), which must fail. Returns the max abs error and a
    note of the bound for the log line."""
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite output")
    diff = (got.float() - want.float()).abs().reshape(-1, HD)
    err = diff.max().item()
    _check(what, err, TOL[got.dtype])
    if got.dtype != torch.bfloat16:
        return err, f"(tol {TOL[got.dtype]:g})"
    size = want.float().abs().reshape(-1, HD)
    row_rms = size.square().mean(dim=1, keepdim=True).sqrt()
    worst = (diff / (BF16_REL * size + ROW_SHARE * row_rms)).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{what}: an element's error is {worst:.3f} of its bound "
                             "2^-7 |plain| + 2^-5 RMS(row)")
    return err, f"(tol {TOL[got.dtype]:g}; per element {worst:.3f} of 2^-7 |plain| + 2^-5 RMS(row))"


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
        err, note = _fwd_check(f"[kernels] #1 {name}", got, want)
        print(f"[kernels] #1 {name:26s} qkv {tuple(qkv.shape)} {str(dtype)[6:]:8s} "
              f"bias={'shared' if bias is not None else 'none':6s} "
              f"max_abs_err {err:.3e} {note}")
        if dtype == bf16 and bias is None and b == BATCH:
            main_err = max(main_err, err)
    return main_err


def _bwd_errs(num: str, name: str, got, want, names=("dq", "dk", "dv", "dbias")) -> dict:
    """Each gradient of a backward kernel's result ``got`` against the plain
    version's ``want``: its max abs error over the plain result's max abs,
    after checking presence, shape, type and finiteness."""
    errs = {}
    for what, a, w in zip(names, got, want):
        if (a is None) != (w is None):
            raise AssertionError(f"[kernels] {num} {name}: {what} is {a} against {w}")
        if w is None:
            continue
        if a.shape != w.shape or a.dtype != w.dtype:
            raise AssertionError(f"[kernels] {num} {name}: {what} {tuple(a.shape)} {a.dtype}")
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(w).all())):
            raise AssertionError(f"[kernels] {num} {name}: non-finite {what}")
        errs[what] = _max_err(a, w) / max(w.detach().abs().max().item(), 1e-30)
    return errs


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
        errs = _bwd_errs("#2", name, got, want, ("dqkv", "dbias"))
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
    # bf16 autograd at the encoder's shape, as the GAN step runs it: the
    # forward (one #1 launch) saves its output and lse, the backward (one #2
    # launch) reads them
    qkv = torch.randn((BATCH, 499, 3 * HD * HEADS), generator=gen, device=dev).to(bf16)
    g = torch.randn((BATCH, 499, HD * HEADS), generator=gen, device=dev).to(bf16)
    before = (attn.LAUNCHES, attn.BWD_LAUNCHES)
    leaf = qkv.clone().requires_grad_()
    (dqkv,) = torch.autograd.grad(attn.attention_qkv(leaf, HEADS), leaf, g)
    want = attn.attention_qkv_bwd_reference(qkv, HEADS, None, g)[0]
    torch.cuda.synchronize()
    counts = [attn.LAUNCHES - before[0], attn.BWD_LAUNCHES - before[1]]
    if counts != [1, 1]:
        raise AssertionError(f"[kernels] #2 bf16 autograd launched #1, #2 {counts}, want [1, 1]")
    err = _bwd_errs("#2", "bf16 autograd", (dqkv,), (want,), ("dqkv",))["dqkv"]
    print(f"[kernels] #2 bf16 autograd of attention_qkv, qkv {tuple(qkv.shape)}: one #1 launch "
          f"(lse saved), one #2 launch, dqkv error over max |plain| {err:.3e} "
          f"(tol {TOL[bf16]:g})")
    _check("[kernels] #2 bf16 autograd", err, TOL[bf16])
    return max(main_err, err)


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
        err, note = _fwd_check(f"[kernels] #3 {name}", got, want)
        print(f"[kernels] #3 {name:22s} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]:8s} bias={'none' if bias is None else tuple(bias.shape)} "
              f"max_abs_err {err:.3e} {note}")
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
        errs = _bwd_errs("#6", name, got, want)
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[kernels] #6 {name:28s} q {tuple(q.shape)} {str(q.dtype)[6:]:8s} "
              f"bias={'none' if bias is None else tuple(bias.shape)}: error over max |plain| "
              f"{shown} (tol {tol:g})")
        for what, e in errs.items():
            _check(f"[kernels] #6 {name} {what}", e, tol)
        if main:
            main_err = max(main_err, *errs.values())
    return main_err


def _packed_views(gen, b, n, h, dtype, dev):
    """q, k, v as the (B, N, 3, H, hd) views of a packed (B, N, 3C) qkv, as
    ``attention_qkv``'s long branch hands them to the q-blocked kernels."""
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(dtype)
    return qkv.view(b, n, 3, h, HD).unbind(2)


def _in_chunks(fn, b: int, chunk: int, *tensors, **kw):
    """The plain version ``fn`` over the batch in slices of ``chunk``
    (tensors of batch ``b`` are sliced, the rest passed whole): its (B, H, L,
    L) fp32 intermediates at a 512 px shape do not fit the card at once.
    Results are joined on the batch axis; a (1, 1, L, L) dbias is summed."""
    outs = []
    for i in range(0, b, chunk):
        outs.append(fn(*(t[i:i + chunk] if torch.is_tensor(t) and t.shape[0] == b else t
                         for t in tensors), **kw))
    if torch.is_tensor(outs[0]):
        return torch.cat(outs)
    joined = [torch.cat(parts) for parts in zip(*(o[:3] for o in outs))]
    dbias = None if outs[0][3] is None else sum(o[3].float() for o in outs).to(outs[0][3].dtype)
    return (*joined, dbias)


def kernels_qblk(dev) -> float:
    """#4 against its plain version: at VAR's 512 px teacher forcing under
    the block-causal bias, at the decoder's and the encoder's packed views
    (kernel at B = 64, the plain version in batch slices), ragged past the
    JAX package's caps (2049, 2305 with a bias, 2817 without), cross-length,
    on unaligned rows, and in fp32. Returns the largest bf16 error at the
    main paths' shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tf_bias = build_attn_bias(PNS512).to(dev)
    ltot = tf_bias.shape[-1]
    cases = [  # (name, q, k, v, bias, scale, plain batch slice, main)
        ("VAR teacher forcing 512", *_bnhd(gen, 16, ltot, ltot, VAR_HEADS, bf16, dev),
         tf_bias, 1.0, 4, True),
        ("decoder 512 packed views", *_packed_views(gen, BATCH, 2050, HEADS, bf16, dev), None,
         None, 8, True),
        ("encoder 512 packed views", *_packed_views(gen, BATCH, 3073, HEADS, bf16, dev), None,
         None, 4, True),
        ("ragged L=2049, bias", *_bnhd(gen, 3, 2049, 2049, 4, bf16, dev),
         encoder_mask(2049, 683, dev, 1), 1.0, 3, False),
        ("ragged L=2305, bias", *_bnhd(gen, 3, 2305, 2305, 4, bf16, dev),
         build_attn_bias((1, 2, 3, 4, 6, 9, 13, 18, 24, 33)).to(dev), 1.0, 3, False),
        ("ragged L=2817, no bias", *_bnhd(gen, 3, 2817, 2817, 4, bf16, dev, l2=False), None,
         None, 3, False),
        ("cross length 1500 x 2500", *_bnhd(gen, 2, 1500, 2500, 4, bf16, dev, l2=False), None,
         None, 2, False),
        ("VAR teacher forcing 512 fp32", *_bnhd(gen, 2, ltot, ltot, VAR_HEADS, f32, dev),
         tf_bias, 1.0, 2, False),
        ("ragged L=2305 fp32, bias", *_bnhd(gen, 2, 2305, 2305, 4, f32, dev),
         encoder_mask(2305, 768, dev, 64), 1.0, 2, False),
    ]
    # rows of 65 elements, k one element off a 16-byte boundary: no 16-byte loads
    wide = torch.randn((2, 3, 2100, 4, HD + 1), generator=gen, device=dev).bfloat16()
    cases.append(("unaligned rows", wide[0, ..., :HD], wide[0, ..., 1:], wide[1, ..., :HD], None,
                  None, 3, False))
    main_err = 0.0
    for name, q, k, v, bias, scale, chunk, main in cases:
        got = attn.fused_attention_qblk(q, k, v, bias, scale)
        want = _in_chunks(attn.fused_attention_qblk_reference, q.shape[0], chunk, q, k, v, bias,
                          scale)
        torch.cuda.synchronize()
        err, note = _fwd_check(f"[kernels] #4 {name}", got, want)
        print(f"[kernels] #4 {name:28s} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]:8s} bias={'none' if bias is None else tuple(bias.shape)} "
              f"max_abs_err {err:.3e} {note}")
        if main:
            main_err = max(main_err, err)
        del got, want
    return main_err


def kernels_qblk_bwd(dev) -> float:
    """#5 against its plain version, the error of each gradient over the
    plain result's max abs (dbias held as #6's, see ``kernels_bnhd_bwd``):
    VAR's 512 px training shape with dbias off (the train step) and on, the
    decoder's and the encoder's packed views, ragged past the JAX caps, and
    fp32 (kernel at full batch, the plain version in batch slices); then
    autograd on the card through ``dot_product_attention`` and through
    ``attention_qkv``'s long branch, each one #5 launch. Returns the
    largest error at the training shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    tf_bias = build_attn_bias(PNS512).to(dev)
    ltot = tf_bias.shape[-1]
    cases = [  # (name, q, k, v, bias, dbias, scale, plain batch slice, main)
        ("VAR training 512, dbias off", *_bnhd(gen, 16, ltot, ltot, VAR_HEADS, bf16, dev),
         tf_bias, False, 1.0, 2, True),
        ("VAR training 512, dbias on", *_bnhd(gen, 4, ltot, ltot, VAR_HEADS, bf16, dev), tf_bias,
         True, 1.0, 2, False),
        ("decoder 512 packed views", *_packed_views(gen, 8, 2050, HEADS, bf16, dev), None, False,
         None, 2, False),
        ("encoder 512 packed views", *_packed_views(gen, 4, 3073, HEADS, bf16, dev), None, False,
         None, 1, False),
        ("ragged L=2049, bias", *_bnhd(gen, 3, 2049, 2049, 4, bf16, dev),
         encoder_mask(2049, 683, dev, 1), True, 1.0, 3, False),
        ("ragged L=2305, bias", *_bnhd(gen, 3, 2305, 2305, 4, bf16, dev),
         encoder_mask(2305, 768, dev, 64), True, 1.0, 3, False),
        ("ragged L=2817, no bias", *_bnhd(gen, 3, 2817, 2817, 4, bf16, dev, l2=False), None,
         False, None, 3, False),
        ("VAR training 512 fp32, dbias on", *_bnhd(gen, 2, ltot, ltot, VAR_HEADS, f32, dev),
         tf_bias, True, 1.0, 1, False),
        ("ragged L=2049 fp32, no bias", *_bnhd(gen, 2, 2049, 2049, 4, f32, dev, l2=False), None,
         False, None, 2, False),
    ]
    main_err = 0.0
    for name, q, k, v, bias, need_db, scale, chunk, main in cases:
        g = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        got = attn.fused_attention_qblk_bwd(q, k, v, bias, g, scale, need_dbias=need_db)
        want = _in_chunks(attn.fused_attention_qblk_bwd_reference, q.shape[0], chunk, q, k, v,
                          bias, g, scale, need_dbias=need_db)
        torch.cuda.synchronize()
        errs = _bwd_errs("#5", name, got, want)
        tol = TOL[q.dtype]
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[kernels] #5 {name:31s} q {tuple(q.shape)} {str(q.dtype)[6:]:8s} "
              f"bias={'none' if bias is None else tuple(bias.shape)}: error over max |plain| "
              f"{shown} (tol {tol:g})")
        for what, e in errs.items():
            _check(f"[kernels] #5 {name} {what}", e, tol)
        if main:
            main_err = max(main_err, *errs.values())
        del got, want
    # autograd on the card: the router and the packed long branch, one #5
    # launch each, past the budget in fp32
    q, k, v = (t.requires_grad_() for t in _bnhd(gen, 2, 2065, 2065, 4, f32, dev, l2=False))
    bias = encoder_mask(2065, 600, dev, 64).requires_grad_()
    g = torch.randn(q.shape, generator=gen, device=dev)
    qkv = torch.randn((2, 2050, 3 * HD * 4), generator=gen, device=dev, requires_grad=True)
    gp = torch.randn((2, 2050, HD * 4), generator=gen, device=dev)
    for name, run, want in (
            ("dot_product_attention", lambda: torch.autograd.grad(
                attn.dot_product_attention(q, k, v, bias), (q, k, v, bias), g),
             lambda: attn.fused_attention_qblk_bwd_reference(
                 q.detach(), k.detach(), v.detach(), bias.detach(), g)),
            ("attention_qkv (packed)", lambda: (torch.autograd.grad(
                attn.attention_qkv(qkv, 4), qkv, gp)[0], None),
             lambda: attn.attention_qkv_bwd_reference(qkv.detach(), 4, None, gp))):
        before = (attn.QBLK_LAUNCHES, attn.QBLK_BWD_LAUNCHES, attn.LAUNCHES, attn.BWD_LAUNCHES)
        got, ref = run(), want()
        torch.cuda.synchronize()
        after = (attn.QBLK_LAUNCHES, attn.QBLK_BWD_LAUNCHES, attn.LAUNCHES, attn.BWD_LAUNCHES)
        if [a - b for a, b in zip(after, before)] != [1, 1, 0, 0]:
            raise AssertionError(f"[kernels] #5 autograd of {name}: launches #4, #5, #1, #2 "
                                 f"{[a - b for a, b in zip(after, before)]}, want [1, 1, 0, 0]")
        err = max(_max_err(a, w) / w.abs().max().item()
                  for a, w in zip(got, ref) if w is not None)
        print(f"[kernels] #5 autograd of {name} on the card: one #4 and one #5 launch, "
              f"gradients' error over max |plain| {err:.3e} (tol {TOL[f32]:g})")
        _check(f"[kernels] #5 autograd of {name}", err, TOL[f32])
    # bf16 autograd at VAR's 512 px training shape through the router, as the
    # train step runs it: the forward (one #4 launch) saves its output and
    # lse, the backward (one #5 launch) reads them
    q, k, v = _bnhd(gen, 16, ltot, ltot, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    before = (attn.QBLK_LAUNCHES, attn.QBLK_BWD_LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attn.dot_product_attention(*leaves, tf_bias, 1.0), leaves, g)
    want = _in_chunks(attn.fused_attention_qblk_bwd_reference, 16, 2, q, k, v, tf_bias, g, 1.0,
                      need_dbias=False)
    torch.cuda.synchronize()
    counts = [attn.QBLK_LAUNCHES - before[0], attn.QBLK_BWD_LAUNCHES - before[1]]
    if counts != [1, 1]:
        raise AssertionError(f"[kernels] #5 bf16 autograd launched #4, #5 {counts}, want [1, 1]")
    errs = _bwd_errs("#5", "bf16 autograd", got, want[:3], ("dq", "dk", "dv"))
    print(f"[kernels] #5 bf16 autograd of dot_product_attention, VAR training 512 q "
          f"{tuple(q.shape)}: one #4 launch (lse saved), one #5 launch, error over max |plain| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {TOL[bf16]:g})")
    for what, e in errs.items():
        _check(f"[kernels] #5 bf16 autograd {what}", e, TOL[bf16])
    return max(main_err, *errs.values())


def kernels_bwd_pieces(dev):
    """The two pieces that the bf16 backward of #2 and #5 adds, against
    their plain versions: the blank-tile map (exact) on VAR's 512 px block-
    causal bias and on the ragged encoder masks at L = 2049 and 2305; and
    the forwards' lse (#4 on VAR's 512 px shape and the encoder's packed
    views, #1 at the GAN encoder's shape and under its mask), error over the
    plain lse's max abs within TOL."""
    for name, bias in (("VAR 512 block-causal", build_attn_bias(PNS512).to(dev)),
                       ("encoder mask L=2049", encoder_mask(2049, 683, dev, 1)),
                       ("encoder mask L=2305", encoder_mask(2305, 768, dev, 64))):
        got, want = attn.blank_tile_map(bias), attn.blank_tile_map_reference(bias)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"[kernels] blank-tile map {name}: "
                                 f"{int((got != want).sum())} tiles differ")
        print(f"[kernels] blank-tile map {name:22s} {tuple(got.shape)}: equal to the plain "
              f"map, {int(got.sum())} of {got.numel()} tiles blank")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    tf_bias = build_attn_bias(PNS512).to(dev)
    ltot = tf_bias.shape[-1]
    cases = []  # (name, q, k, bias, forward with lse, forward without)
    for name, (b, n), dtype, bias in (("#4 VAR 512", (4, ltot), bf16, tf_bias),
                                      ("#4 VAR 512 fp32", (2, ltot), f32, tf_bias)):
        q, k, v = _bnhd(gen, b, n, n, VAR_HEADS, dtype, dev)
        cases.append((name, q, k, bias,
                      lambda q=q, k=k, v=v, bias=bias: attn.fused_attention_qblk_lse(
                          q, k, v, bias, 1.0),
                      lambda q=q, k=k, v=v, bias=bias: attn.fused_attention_qblk(
                          q, k, v, bias, 1.0)))
    q, k, v = _packed_views(gen, 2, 3073, HEADS, bf16, dev)
    cases.append(("#4 encoder 512 packed views", q, k, None,
                  lambda: attn.fused_attention_qblk_lse(q, k, v),
                  lambda: attn.fused_attention_qblk(q, k, v)))
    for name, (b, n), dtype, bias in (("#1 encoder MSVR10P2", (BATCH, 499), bf16, None),
                                      ("#1 encoder fp32", (2, 499), f32, None),
                                      ("#1 masked", (8, 513), bf16, encoder_mask(513, 256, dev))):
        qkv = torch.randn((b, n, 3 * HD * HEADS), generator=gen, device=dev).to(dtype)
        cases.append((name, *qkv.view(b, n, 3, HEADS, HD).unbind(2)[:2], bias,
                      lambda qkv=qkv, bias=bias: attn.attention_qkv_lse(qkv, HEADS, bias),
                      lambda qkv=qkv, bias=bias: attn.attention_qkv(qkv, HEADS, bias)))
    for name, q, k, bias, with_lse, without in cases:
        out, lse = with_lse()
        want = attn.attention_lse_reference(q, k, bias, 1.0 if name.startswith("#4 VAR") else None)
        same = torch.equal(out, without())
        torch.cuda.synchronize()
        if lse.shape != want.shape or not bool(torch.isfinite(lse).all()):
            raise AssertionError(f"[kernels] lse {name}: shape {tuple(lse.shape)} or non-finite")
        err = _max_err(lse, want) / want.abs().max().item()
        print(f"[kernels] lse {name:30s} {str(q.dtype)[6:]:8s} (B, H, L) {tuple(lse.shape)}: "
              f"error over max |plain| {err:.3e} (tol {TOL[q.dtype]:g}); output "
              f"{'equal to' if same else 'DIFFERS from'} the launch without lse")
        _check(f"[kernels] lse {name}", err, TOL[q.dtype])
        if not same:
            raise AssertionError(f"[kernels] lse {name}: the output changed with the lse store")


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
             for pn in sorted(set(PNS) | set(PNS512)) for maximize in (True, False)]
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


def _sublayer_operands(gen, b, n, c, hidden, dtype, dev, res=torch.float32):
    """xn (B, N, C) in ``dtype``, the residual stream in ``res`` (or zeros
    when ``res`` is None), and one sublayer's parameters in the (out, in)
    layout: W1 (hidden, C), b1, W2 (C, hidden or C for the attention's
    proj), b2, with the layers' init bounds, biases of 0.1, and LayerScale
    of order 1 (at DINOv2's 1e-5, ls * y would vanish under res and hide
    any error in y)."""
    c2 = c if hidden == 3 * c else hidden
    xn = torch.randn((b, n, c), generator=gen, device=dev).to(dtype)
    r = (torch.zeros((b, n, c), device=dev) if res is None else
         torch.randn((b, n, c), generator=gen, device=dev).to(res))
    w1 = (torch.rand((hidden, c), generator=gen, device=dev) * 2 - 1) * c ** -0.5
    w2 = (torch.rand((c, c2), generator=gen, device=dev) * 2 - 1) * c2 ** -0.5
    b1 = torch.randn(hidden, generator=gen, device=dev) * 0.1
    b2 = torch.randn(c, generator=gen, device=dev) * 0.1
    ls = torch.rand(c, generator=gen, device=dev) * 0.5 + 0.5
    return xn, r, w1, b1, w2, b2, ls


def _sublayer_check(what: str, got: torch.Tensor, want: torch.Tensor, res: torch.Tensor,
                    ls: torch.Tensor, dtype: torch.dtype) -> tuple[float, str]:
    """A fused sublayer's fp32 output against its plain version's: both
    finite; in fp32 (``dtype``, the activations') the max abs error within
    TOL; in bf16 every element
    within ls * (2^-6 |y| + 2^-6 RMS(y's row)) + 2^-20 |out|, where y =
    (plain - res) / ls is the sublayer's bf16 output before LayerScale:
    two roundings of y (the product's and the bias add's) may each land
    one bf16 ulp apart on the two sides, a rounding flip inside (a qkv, o
    or h element) moves y by a small share of its row's RMS, and the last
    term covers the fp32 residual add. tests/test_torch_sublayer_checks.py
    holds this check against a CPU model of the kernels' numerics (GEMMs
    summed in 32-wide k-steps, #1's tiled attention), which must pass, and
    against the model with a fault planted (the last k/v tile or GEMM
    k-step dropped, a bias omitted, LayerScale skipped, the last partial
    row tile unstored), which must fail; tests/test_torch_block_fused.py
    holds the same bound against the Pallas kernels on the CPU."""
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite output")
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{what}: output {tuple(got.shape)} {got.dtype}")
    diff = (got - want).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        _check(what, err, TOL[torch.float32])
        return err, f"(tol {TOL[torch.float32]:g})"
    y = (want - res.float()) / ls
    rms = y.square().mean(dim=-1, keepdim=True).sqrt()
    worst = (diff / (ls * (2.0 ** -6 * y.abs() + 2.0 ** -6 * rms)
                     + 2.0 ** -20 * want.abs())).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{what}: an element's error is {worst:.3f} of its bound "
                             "ls (2^-6 |y| + 2^-6 RMS(row)) + 2^-20 |out|")
    return err, f"(per element {worst:.3f} of ls (2^-6 |y| + 2^-6 RMS(row)))"


def _expect_refusal(what: str, exc: type, fn):
    try:
        fn()
    except exc as e:
        print(f"[kernels] {what}: refused ({type(e).__name__}: {e})")
        return
    raise AssertionError(f"[kernels] {what}: not refused")


def kernels_sublayers(dev) -> dict:
    """#7, #8 and #10 against their plain versions: #7 at the decoder's
    (64, 514, 768) and the encoder's (64, 513, 768) with 12 heads and at
    ViT-S width 384 with 6 heads, #8 at (64, 514, 768) with hidden 3072 and
    at ViT-S width, #10 at scripts/perf.py's (32832, 768, 3072); each also
    ragged, with res = 0, and in fp32; then autograd through each fused
    sublayer on the card (one forward launch; gradients against the
    composed path's) and the wrappers' refusals. Returns the largest bf16
    max abs error of each at the main paths' shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    errs = {"attn_sublayer_fused": 0.0, "mlp_sublayer_fused": 0.0, "fused_mlp": 0.0}
    attn_cases = [  # (name, (B, N, C), heads, dtype, res dtype or None, main)
        ("decoder VQ-4096", (BATCH, 514, 768), HEADS, bf16, f32, True),
        ("encoder VQ-4096, bf16 res", (BATCH, 513, 768), HEADS, bf16, bf16, True),
        ("decoder ViT-S", (BATCH, 379, 384), 6, bf16, f32, True),
        ("ragged", (3, 37, 768), HEADS, bf16, f32, False),
        ("res = 0", (8, 514, 768), HEADS, bf16, None, False),
        ("decoder fp32", (2, 514, 768), HEADS, f32, f32, False),
        ("ragged ViT-S fp32", (3, 37, 384), 6, f32, f32, False),
    ]
    for name, (b, n, c), h, dtype, res, main in attn_cases:
        xn, r, wq, bq, wp, bp, ls = _sublayer_operands(gen, b, n, c, 3 * c, dtype, dev, res)
        got = block.attn_sublayer_fused(xn, r, wq, bq, wp, bp, ls, h)
        want = block.attn_sublayer_fused_reference(xn, r, wq, bq, wp, bp, ls, h)
        torch.cuda.synchronize()
        tag = f"[kernels] #7 {name}"
        err, note = _sublayer_check(tag, got, want, r, ls, dtype)
        print(f"{tag:38s} xn {(b, n, c)} heads {h} {str(dtype)[6:]:8s} max_abs_err {err:.3e} "
              f"{note}")
        if main:
            errs["attn_sublayer_fused"] = max(errs["attn_sublayer_fused"], err)
    mlp_cases = [  # (name, (B, N, C), hidden, dtype, res dtype or None, main)
        ("decoder VQ-4096", (BATCH, 514, 768), 3072, bf16, f32, True),
        ("encoder VQ-4096", (BATCH, 513, 768), 3072, bf16, f32, True),
        ("decoder ViT-S, bf16 res", (BATCH, 379, 384), 1536, bf16, bf16, True),
        ("ragged", (3, 37, 768), 3072, bf16, f32, False),
        ("res = 0", (8, 514, 768), 3072, bf16, None, False),
        ("decoder fp32", (2, 514, 768), 3072, f32, f32, False),
        ("ragged fp32", (3, 37, 384), 1536, f32, f32, False),
    ]
    for name, (b, n, c), hid, dtype, res, main in mlp_cases:
        xn, r, w1, b1, w2, b2, ls = _sublayer_operands(gen, b, n, c, hid, dtype, dev, res)
        got = block.mlp_sublayer_fused(xn, r, w1, b1, w2, b2, ls)
        want = block.mlp_sublayer_fused_reference(xn, r, w1, b1, w2, b2, ls)
        torch.cuda.synchronize()
        tag = f"[kernels] #8 {name}"
        err, note = _sublayer_check(tag, got, want, r, ls, dtype)
        print(f"{tag:38s} xn {(b, n, c)} hidden {hid} {str(dtype)[6:]:8s} max_abs_err "
              f"{err:.3e} {note}")
        if main:
            errs["mlp_sublayer_fused"] = max(errs["mlp_sublayer_fused"], err)
    for name, m, dtype, main in (("perf.py's probe", BATCH * 513, bf16, True),
                                 ("ragged", 77, bf16, False), ("fp32", 300, f32, False),
                                 ("ragged fp32", 37, f32, False)):
        x = torch.randn((m, 768), generator=gen, device=dev).to(dtype)
        w1 = (torch.randn((3072, 768), generator=gen, device=dev) * 0.02).to(dtype)
        w2 = (torch.randn((768, 3072), generator=gen, device=dev) * 0.02).to(dtype)
        b1 = torch.randn(3072, generator=gen, device=dev) * 0.1
        b2 = torch.randn(768, generator=gen, device=dev) * 0.1
        got = block.fused_mlp(x, w1, b1, w2, b2)
        want = block.fused_mlp_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if got.dtype != dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[kernels] #10 {name}: output {got.dtype} or not finite")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if dtype == f32:
            _check(f"[kernels] #10 {name}", err, TOL[f32])
            note = f"(tol {TOL[f32]:g})"
        else:  # one rounding of o, and rounding flips of h elements
            size = want.float().abs()
            rms = size.square().mean(dim=-1, keepdim=True).sqrt()
            worst = (diff / (BF16_REL * size + ROW_SHARE * rms)).max().item()
            if not worst <= 1.0:
                raise AssertionError(f"[kernels] #10 {name}: an element's error is "
                                     f"{worst:.3f} of 2^-7 |plain| + 2^-5 RMS(row)")
            note = f"(per element {worst:.3f} of 2^-7 |plain| + 2^-5 RMS(row))"
        print(f"[kernels] #10 {name:31s} x ({m}, 768) hidden 3072 {str(dtype)[6:]:8s} "
              f"max_abs_err {err:.3e} {note}")
        if main:
            errs["fused_mlp"] = max(errs["fused_mlp"], err)

    # autograd on the card, fp32: one forward launch of the fused kernel; the
    # backward recomputes through the composed path (cuBLAS, #1 and #2)
    for num, name, fused, composed, hidden in (
            ("#7", "attn_sublayer_fused", lambda *a: block.attn_sublayer_fused(*a, HEADS),
             lambda *a: block._attn_composed(*a, HEADS), 3 * 768),
            ("#8", "mlp_sublayer_fused", block.mlp_sublayer_fused,
             block.mlp_sublayer_fused_reference, 3072)):
        ops = [t.requires_grad_() for t in _sublayer_operands(gen, 2, 37, 768, hidden, f32, dev)]
        g = torch.randn((2, 37, 768), generator=gen, device=dev)
        before = read_counts()
        got = torch.autograd.grad(fused(*ops), ops, g)
        after = read_counts()
        want = torch.autograd.grad(composed(*ops), ops, g)
        torch.cuda.synchronize()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        expect = {name: 1, **({"attention_qkv_fwd": 1, "attention_qkv_bwd": 1}
                              if num == "#7" else {})}
        if launched != expect:
            raise AssertionError(f"[kernels] {num} autograd launched {launched}, want {expect}")
        err = max(_max_err(a, w) / max(w.abs().max().item(), 1e-30) for a, w in zip(got, want))
        print(f"[kernels] {num} autograd of {name} on the card: launches {launched}; every "
              f"input's gradient against the composed path's, error over max |composed| "
              f"{err:.3e} (tol {TOL[f32]:g})")
        _check(f"[kernels] {num} autograd", err, TOL[f32])

    x96 = torch.zeros((2, 5, 96), device=dev)
    _expect_refusal("#8 at width 96", ValueError, lambda: block.mlp_sublayer_fused(
        x96, x96, torch.zeros((384, 96), device=dev), torch.zeros(384, device=dev),
        torch.zeros((96, 384), device=dev), torch.zeros(96, device=dev),
        torch.zeros(96, device=dev)))
    x128 = torch.zeros((2, 5, 128), device=dev)
    _expect_refusal("#7 at head dim 32", NotImplementedError, lambda: block.attn_sublayer_fused(
        x128, x128, torch.zeros((384, 128), device=dev), torch.zeros(384, device=dev),
        torch.zeros((128, 128), device=dev), torch.zeros(128, device=dev),
        torch.zeros(128, device=dev), 4))
    _expect_refusal("#10 with its weights on the CPU", ValueError, lambda: block.fused_mlp(
        torch.zeros((7, 64), device=dev), torch.zeros((64, 64)), torch.zeros(64),
        torch.zeros((64, 64)), torch.zeros(64)))
    _expect_refusal("#7 at width 100", ValueError, lambda: block.attn_sublayer_fused(
        torch.zeros((2, 5, 100), device=dev), torch.zeros((2, 5, 100), device=dev),
        torch.zeros((300, 100), device=dev), torch.zeros(300, device=dev),
        torch.zeros((100, 100), device=dev), torch.zeros(100, device=dev),
        torch.zeros(100, device=dev), 1))
    return errs


def _excite_layerscale(model: torch.nn.Module, gen: torch.Generator):
    """LayerScale starts at 1e-5, which leaves every block (and its attention)
    out of the output; raise it so that the comparison sees them."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerScale):
                mod.gamma.uniform_(0.5, 1.0, generator=gen)


def phase_model_vq(dev):
    """The VQ-4096 round-trip tokenizer, card against the same weights on
    the CPU; then, with the fused sublayers on the card (#7 and #8 in every
    block, exact launches), its decode and round trip against the CPU's
    composed path. Returns the CPU and the card models, the card's fused."""
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

    # the fused sublayers on the card against the CPU's composed path
    depth = len(card.encoder.model.blocks)
    if set_fused_sublayers(card, True, True) != 2 * depth:
        raise AssertionError("[model] set_fused_sublayers missed a block")
    errs = {}
    with torch.inference_mode():
        reset_counts()
        img_fused = card.decode_tokens(tok_cpu.to(dev))
        torch.cuda.synchronize()
        check_launches("[model] fused decode_tokens", 1,
                       {"attn_sublayer_fused": depth, "mlp_sublayer_fused": depth})
        errs["decode_tokens"] = _max_err(img_cpu, img_fused)
        reset_counts()
        rec_fused = card.img_to_reconstructed_img(x.to(dev))
        torch.cuda.synchronize()
        check_launches("[model] fused round trip", 1,
                       {"attn_sublayer_fused": 2 * depth, "mlp_sublayer_fused": 2 * depth})
        if not diff.numel():  # the codes are the CPU's: the images must agree
            errs["img_to_reconstructed_img"] = _max_err(rec_cpu, rec_fused)
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] VQ-4096 fp32 B=2, fused sublayers on the card (#7 and #8, {depth} each "
          f"in the decoder) vs the CPU's composed path: {shown} (tol {MODEL_TOL:g})")
    for k, v in errs.items():
        _check(f"[model] fused {k}", v, MODEL_TOL)
    return cpu, card


def _excite_adaln(model: torch.nn.Module, gen: torch.Generator):
    """RAR's AdaLN-zero layers start at 0, which leaves every block out of
    the output: draw them so that the gates, shifts and scales are O(1)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Sequential) and isinstance(mod[0], torch.nn.SiLU):
                mod[1].weight.normal_(0.0, 0.05, generator=gen)
                mod[1].bias.uniform_(-0.5, 0.5, generator=gen)


def _gumbel_gap(args, want, got, diff):
    """sample_tokens(logits, gumbel, T): the gap between the two picks'
    scores logits / T + g, in fp64."""
    score = (args[0].double() / args[2] + args[1].double())[diff]
    return (score.gather(-1, want[:, None]) - score.gather(-1, got[:, None])).abs()[:, 0]


RAR_SAMPLING = dict(guidance_scale=16.0, guidance_scale_pow=2.75, randomize_temperature=1.0)


def phase_model_rar(dev, vq_cpu: VQModel, vq_card: VQModel):
    """RAR-B at full width (768 wide, 24 deep, 16 heads, 256 tokens, 4096
    codes) in fp32, B=2 with CFG at ``configs/generator/robustTok-rar.yaml``'s
    settings, card against the same weights on the CPU, with the Gumbel noise
    drawn once on the CPU and handed to both: every pick equal except at a
    near-tie (the card then goes on from the CPU's pick), the CFG logits of
    the first and the last step; then the tokens decoded by the RobustTok
    tokenizer of ``phase_model_vq``, fused sublayers on the card against
    the composed path on the CPU."""
    gen = torch.Generator().manual_seed(SEED + 10)
    rar_cpu = build_rar(vq_cpu.config, generator=gen, device="cpu").eval()
    _excite_adaln(rar_cpu, gen)
    rar_card = copy.deepcopy(rar_cpu).to(dev)
    cfg = rar_cpu.config
    labels = torch.tensor([207, 980])
    noise = rar_mod._gumbel((cfg.image_seq_len, 2, cfg.codebook_size), gen, "cpu")
    picks = Lockstep(rar_mod, "sample_tokens", _gumbel_gap, LOGIT_NEAR_TIE, keep_card_args=True)
    tok_cpu = picks.on_cpu(lambda: rar_mod.rar_generate(rar_cpu, labels, noise=noise,
                                                        **RAR_SAMPLING))
    tok_card = picks.on_card(lambda: rar_mod.rar_generate(
        rar_card, labels.to(dev), noise=noise.to(dev), **RAR_SAMPLING))
    torch.cuda.synchronize()
    errs = {}
    for name, i in (("first step", 0), ("last step", cfg.image_seq_len - 1)):
        want = picks.calls[i][0][0]
        errs[f"CFG logits, {name}"] = _max_err(picks.card_args[i][0], want) / \
            want.abs().max().item()
    if not torch.equal(tok_card.cpu(), tok_cpu):
        raise AssertionError("[model] RAR: the card's tokens are not the CPU's picks")
    with torch.inference_mode():
        img_cpu = vq_cpu.decode_tokens(tok_cpu)
        reset_counts()
        img_card = vq_card.decode_tokens(tok_card)  # fused sublayers (phase_model_vq)
        torch.cuda.synchronize()
    depth = len(vq_card.decoder.model.blocks)
    check_launches("[model] RAR tokens' fused decode", 1,
                   {"attn_sublayer_fused": depth, "mlp_sublayer_fused": depth})
    errs["decoded images"] = _max_err(img_cpu, img_card)
    if tuple(img_card.shape) != (2, 256, 256, 3):
        raise AssertionError(f"[model] RAR decode {tuple(img_card.shape)}")
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] RAR-B fp32 B=2 CFG {RAR_SAMPLING['guidance_scale']:g} card vs CPU: "
          f"{shown} (tol {MODEL_TOL:g}; logits relative to their max abs); tokens "
          f"{picks.compared - picks.flips}/{picks.compared} picked alike, max near-tie gap "
          f"{picks.max_gap:.3e} (<= {LOGIT_NEAR_TIE:g}); "
          f"{torch.unique(tok_cpu).numel()} distinct tokens; decoded by RobustTok with "
          f"#7 and #8 ({depth} each) on the card")
    for k, v in errs.items():
        _check(f"[model] RAR {k}", v, MODEL_TOL)


class Lockstep:
    """Runs a path on the CPU and then on the card with ``module.name``
    wrapped. The CPU run records each call's arguments and result; the card
    run compares each of its results with the CPU's, requires every entry
    that differs to be a near-tie (``gap(cpu_args, cpu_out, card_out)`` <=
    ``tol``), and hands the CPU's result on, so that one near-tie flip does
    not change everything after it. With ``keep_card_args`` the card's
    arguments are kept too (``card_args``)."""

    def __init__(self, module, name: str, gap, tol: float, keep_card_args: bool = False):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.gap, self.tol = gap, tol
        self.calls, self.compared, self.flips, self.max_gap = [], 0, 0, 0.0
        self.card_args = [] if keep_card_args else None

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
            if self.card_args is not None:
                self.card_args.append(args)
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


def phase_model_var(dev, margs: ModelArgs, name: str):
    """A multi-scale tokenizer with VAR-d16 in fp32 at B=2,
    card against the same weights on the CPU: the encoder's latents,
    ``img_to_idxBl``'s codes per scale, the round trip image, the VAR input,
    ``VAR.forward`` logits and greedy ``var_sample`` tokens and images."""
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
        rec = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
        errs["round trip image"] = _max_err(
            rec.on_cpu(lambda: vae_cpu.img_to_reconstructed_img(x)),
            rec.on_card(lambda: vae_card.img_to_reconstructed_img(x.to(dev))))
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
    print(f"[model] {name} fp32 B=2 card vs CPU: {shown} (tol {MODEL_TOL:g}); img_to_idxBl "
          f"codes {codes.compared - codes.flips}/{codes.compared} equal over "
          f"{len(codes.calls)} lookups ({distinct} distinct), max near-tie gap "
          f"{codes.max_gap:.3e}, round trip codes {rec.compared - rec.flips}/{rec.compared} "
          f"equal; greedy var_sample tokens {picks.compared - picks.flips}/{picks.compared} "
          f"equal, max top-2 logit gap at a flip {picks.max_gap:.3e} (<= {LOGIT_NEAR_TIE:g})")
    for k, v in errs.items():
        _check(f"[model] {name} {k}", v, MODEL_TOL)
    return (vae_cpu, var_cpu), (vae_card, var_card)


def phase_model_train(dev, cpu_models, card_models, name: str):
    """One VARTrainer step of a tokenizer with VAR in fp32 at B=2, card
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
    masks["drop_path"][-1] = (torch.tensor([0.0, 1.0]), torch.tensor([1.0, 0.0]))
    masks_card = {k: v.to(dev) if torch.is_tensor(v) else
                  [None if t is None else tuple(m.to(dev) for m in t) for t in v]
                  for k, v in masks.items()}
    codes = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
    loss_cpu = codes.on_cpu(lambda: tr_cpu.loss_and_backward(x, label, masks=masks))[0]
    loss_card = codes.on_card(lambda: tr_card.loss_and_backward(
        x.to(dev), label.to(dev), masks=masks_card))[0]
    grad_errs = {}
    for (pname, p_cpu), p_card in zip(var_cpu.named_parameters(), var_card.parameters()):
        if p_cpu.grad is None or p_card.grad is None:
            raise AssertionError(f"[model] {name} {pname}: no gradient (cpu "
                                 f"{p_cpu.grad is not None}, card {p_card.grad is not None})")
        grad_errs[pname] = _max_err(p_card.grad, p_cpu.grad) / max(
            p_cpu.grad.abs().max().item(), 1e-30)
    worst = max(grad_errs, key=grad_errs.get)
    gn_cpu, gn_card = tr_cpu.opt.step(), tr_card.opt.step()
    torch.cuda.synchronize()
    step_err = max(_max_err(a, b) for a, b in zip(var_cpu.parameters(), var_card.parameters()))
    errs = {"loss": abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item()),
            "grad_norm": abs(gn_card.item() - gn_cpu.item()) / gn_cpu.item(),
            f"gradient of {worst}": grad_errs[worst]}
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] {name} VARTrainer step fp32 B=2 card vs CPU (relative): {shown} (tol "
          f"{MODEL_TOL:g}; {len(grad_errs)} parameter gradients, median error "
          f"{statistics.median(grad_errs.values()):.3e}); loss {loss_cpu.item():.6f}, grad norm "
          f"{gn_cpu.item():.6f}; updated parameters max abs diff {step_err:.3e}; codes "
          f"{codes.compared - codes.flips}/{codes.compared} equal")
    for k, v in errs.items():
        _check(f"[model] {name} {k}", v, MODEL_TOL)
    _check(f"[model] {name} updated parameters", step_err, MODEL_TOL)


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


def _check_images(what: str, y: torch.Tensor, batch: int, px: int):
    if tuple(y.shape) != (batch, px, px, 3) or y.dtype != torch.float32:
        raise AssertionError(f"[main] {what} output {tuple(y.shape)} {y.dtype}")
    if not (bool(torch.isfinite(y).all()) and y.abs().max().item() <= 1.0):
        raise AssertionError(f"[main] {what} output not finite or outside [-1, 1]")


def main_round_trip(dev) -> dict:
    """The VQ-4096 round trip at B=64, composed (#1 in every block) and then,
    on the same model and input, with the fused sublayers (#7 and #8 in
    every block, #1 none), so that the two differ only in the option."""
    cfg = bench_margs("bfloat16")
    px, nl, vocab = cfg.image_size, cfg.num_latent_tokens, cfg.codebook_size
    model = VQModel(cfg, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    x = torch.rand((BATCH, px, px, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    depth = len(model.encoder.model.blocks) + len(model.decoder.model.blocks)  # 24
    out = {}
    with torch.inference_mode():
        out["round trip"] = r = time_calls("round trip", lambda: model.img_to_reconstructed_img(x),
                                           10, {"attention_qkv_fwd": depth}, dev)
        tokens = model.encode_to_tokens(x)
        rec = model.decode_tokens(tokens)
        torch.cuda.synchronize()
        _check_images("round trip", r.pop("out"), BATCH, px)
        if tuple(tokens.shape) != (BATCH, nl) or not (
                0 <= tokens.min().item() and tokens.max().item() < vocab):
            raise AssertionError(f"[main] tokens {tuple(tokens.shape)} "
                                 f"in [{tokens.min().item()}, {tokens.max().item()}]")
        if tuple(rec.shape) != (BATCH, px, px, 3) or not bool(torch.isfinite(rec).all()):
            raise AssertionError("[main] decode_tokens output malformed")
        _report("VQ-4096 img_to_reconstructed_img", r, BATCH,
                f"tokens {tuple(tokens.shape)} in [{tokens.min().item()}, "
                f"{tokens.max().item()}], {torch.unique(tokens).numel()} distinct")

        set_fused_sublayers(model, True, True)
        out["round trip fused"] = r = time_calls(
            "round trip fused", lambda: model.img_to_reconstructed_img(x), 10,
            {"attn_sublayer_fused": depth, "mlp_sublayer_fused": depth}, dev)
        y = r.pop("out")
        _check_images("round trip fused", y, BATCH, px)
        rec_fused = model.decode_tokens(tokens)
        torch.cuda.synchronize()
        # the same tokens through the fused and the composed decoder, bf16:
        # with DINOv2's LayerScale of 1e-5 the sublayers move the fp32
        # stream little, so the images must agree to four bf16 ulps of
        # their largest value (phase_model_vq holds the fused decode with
        # LayerScale of order 1, in fp32)
        dec_err = _max_err(rec_fused, rec)
        dec_tol = 2.0 ** -6 * rec.float().abs().max().item()
        _check("[main] fused against composed decode_tokens", dec_err, dec_tol)
        _report("VQ-4096 img_to_reconstructed_img, fused sublayers", r, BATCH,
                f"decode_tokens of the composed run's tokens against the composed decoder: "
                f"max abs diff {dec_err:.3e} (tol 2^-6 max |image| = {dec_tol:.3e})")
    return out


def main_rar_paths(dev) -> dict:
    """RAR sampling at B=64 in bf16: ``rar_generate`` (RAR-B, CFG at
    ``configs/generator/robustTok-rar.yaml``'s settings, a bf16 KV cache as
    ``scripts/sample_rar.py`` sets it) and ``decode_tokens`` on the RobustTok
    tokenizer with the fused sublayers (#7 and #8 in each decoder block);
    then each of the two alone: the generator launches no kernel (its
    attention is plain PyTorch over the cache, as the JAX package's decode
    is XLA)."""
    margs = bench_margs("bfloat16")
    vae = VQModel(margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    set_fused_sublayers(vae, True, True)
    gen = torch.Generator().manual_seed(SEED + 11)
    rar = build_rar(margs, dtype_str="bfloat16", generator=gen, device="cpu").eval()
    _excite_adaln(rar, gen)  # drawn on the CPU, as every model's weights
    rar.to(dev)
    labels = torch.arange(BATCH, device=dev) % 1000
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    depth = len(vae.decoder.model.blocks)
    decode = {"attn_sublayer_fused": depth, "mlp_sublayer_fused": depth}

    def generate():
        return rar_mod.rar_generate(rar, labels, sgen, cache_dtype=torch.bfloat16,
                                    **RAR_SAMPLING)

    out = {}
    with torch.inference_mode():
        out["rar sample"] = r = time_calls("rar sample", lambda: vae.decode_tokens(generate()),
                                           3, decode, dev)
        _check_images("rar sample", r.pop("out"), BATCH, margs.image_size)
        _report("RAR-B rar_generate + fused decode_tokens (CFG 16, pow 2.75)", r, BATCH,
                "images in [-1, 1]")
        out["rar generate"] = r = time_calls("rar generate", generate, 2, {}, dev)
        tok = r.pop("out")
        if tuple(tok.shape) != (BATCH, rar.config.image_seq_len) or not (
                0 <= int(tok.min()) and int(tok.max()) < rar.config.codebook_size):
            raise AssertionError(f"[main] rar_generate tokens {tuple(tok.shape)}")
        _report("RAR-B rar_generate alone", r, BATCH,
                f"tokens {tuple(tok.shape)}, {torch.unique(tok).numel()} distinct")
        out["rar decode"] = r = time_calls("rar decode", lambda: vae.decode_tokens(tok), 10,
                                           decode, dev)
        _check_images("rar decode", r.pop("out"), BATCH, margs.image_size)
        _report("RobustTok decode_tokens alone, fused sublayers", r, BATCH, "images in [-1, 1]")
    return out


MLP_PROBE = (BATCH * 513, 768, 3072, 12)  # scripts/perf.py:29-33: B*L rows, D, HID; 12 layers


def main_mlp_probe(dev) -> dict:
    """scripts/perf.py's MLP probe on the fused kernel: 12 chained #10 calls
    over (B*L, D) = (32832, 768) bf16 rows, hidden 3072, the weights N(0,
    0.02) and zero fp32 biases as the probe draws them."""
    m, d, hid, layers = MLP_PROBE
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.randn((m, d), generator=gen, device=dev).bfloat16()
    w1 = (torch.randn((hid, d), generator=gen, device=dev) * 0.02).bfloat16()
    w2 = (torch.randn((d, hid), generator=gen, device=dev) * 0.02).bfloat16()
    b1, b2 = torch.zeros(hid, device=dev), torch.zeros(d, device=dev)

    def stack():
        t = x
        for _ in range(layers):
            t = block.fused_mlp(t, w1, b1, w2, b2)
        return t

    with torch.inference_mode():
        r = time_calls("mlp probe", stack, 10, {"fused_mlp": layers}, dev)
    y = r.pop("out")
    if tuple(y.shape) != (m, d) or y.dtype != torch.bfloat16 or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"[main] mlp probe output {tuple(y.shape)} {y.dtype}")
    _report(f"{layers}x fused MLP probe (scripts/perf.py, ({m}, {d}), hidden {hid})", r,
            BATCH, f"output RMS {y.float().square().mean().sqrt().item():.3e}")
    return {"mlp probe": r}


def main_var_paths(dev, margs: ModelArgs, tag: str, per_call: dict,
                   sample_margs: ModelArgs | None = None) -> dict:
    """The serving paths of a multi-scale tokenizer with VAR-d16 in bf16 at
    B=64: the round trip (when ``per_call`` names it), ``var_sample``,
    ``img_to_idxBl`` and ``VAR.forward``, each checked against its
    ``per_call`` launches; results keyed ``tag + path``. ``var_sample``
    decodes through a tokenizer of ``sample_margs`` when given (bench.py's
    sample leg, whose VAR has the same vocabulary and Cvae)."""
    pns = tuple(margs.v_patch_nums)
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    vae.eval()
    var.eval()
    sample_vae = vae if sample_margs is None else VQModel(
        sample_margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.arange(BATCH, device=dev) % 1000
    px = margs.image_size
    out = {}

    if "round trip" in per_call:
        x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
        with torch.inference_mode():
            out[tag + "round trip"] = r = time_calls(
                tag + "round trip", lambda: vae.img_to_reconstructed_img(x), 10,
                per_call["round trip"], dev)
        y = r["out"]
        if tuple(y.shape) != (BATCH, px, px, 3) or not (
                bool(torch.isfinite(y).all()) and y.abs().max().item() <= 1.0):
            raise AssertionError(f"[main] {tag}round trip output malformed")
        _report(f"{tag}img_to_reconstructed_img", r, BATCH,
                f"images {tuple(y.shape)} in [{y.min().item():.3f}, {y.max().item():.3f}]")
        del x, y, r

    out[tag + "var_sample"] = r = time_calls(
        tag + "var_sample", lambda: var_train.var_sample(var, sample_vae, labels, gen,
                                                         cfg_scale=1.5, top_k=900, top_p=0.96),
        5, per_call["var_sample"], dev)
    img = r["out"]
    if tuple(img.shape) != (BATCH, px, px, 3) or not (
            bool(torch.isfinite(img).all()) and 0 <= img.min().item()
            and img.max().item() <= 1):
        raise AssertionError(f"[main] {tag}var_sample images malformed")
    _report(f"{tag}var_sample(cfg 1.5, top-k 900, top-p 0.96)", r, BATCH,
            f"images {tuple(img.shape)} in [{img.min().item():.3f}, {img.max().item():.3f}]; "
            f"decoded by {sample_vae.config.decoder_model}")
    del img, r, sample_vae

    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        out[tag + "img_to_idxBl"] = r = time_calls(
            tag + "img_to_idxBl", lambda: vae.img_to_idxBl(x), 10, per_call["img_to_idxBl"],
            dev)
        idx = r["out"]
        shapes = [[tuple(i.shape) for i in b] for b in idx]
        if shapes != [[(BATCH, pn * pn) for pn in pns]] * margs.product_quant or not all(
                0 <= int(i.min()) and int(i.max()) < margs.codebook_size
                for b in idx for i in b):
            raise AssertionError(f"[main] {tag}img_to_idxBl codes malformed: {shapes}")
        distinct = torch.unique(torch.cat([i.reshape(-1) for b in idx for i in b])).numel()
        _report(f"{tag}img_to_idxBl", r, BATCH,
                f"2 branches x {len(pns)} scales of codes, {distinct} distinct")

        x_in = vae.idxBl_to_var_input(idx)
        out[tag + "VAR.forward"] = r = time_calls(
            tag + "VAR.forward", lambda: var(labels, x_in), 10, per_call["VAR.forward"], dev)
        logits = r["out"]
        if tuple(logits.shape) != (BATCH, var.config.L, var.config.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"[main] {tag}VAR.forward logits malformed")
        _report(f"{tag}VAR.forward (teacher forcing, block-causal bias)", r, BATCH,
                f"logits {tuple(logits.shape)}")
    for r in out.values():
        r.pop("out")  # keep no batch of outputs alive past the path
    return out


def main_train_paths(dev, margs: ModelArgs, tag: str, per_call: dict,
                     train_batch: int = BATCH) -> dict:
    """VARTrainer.train_step (at ``train_batch``) and eval_step (at B=64) of
    a multi-scale tokenizer with VAR-d16 in bf16, ``VARTrainConfig()``
    defaults, the training masks drawn from a seeded generator on the card;
    each checked against its ``per_call`` launches."""
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    tr = VARTrainer(vae, var, VARTrainConfig(),
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    px = margs.image_size
    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    out = {}
    before = [p.detach().clone() for p in var.parameters()]
    xt, lt = x[:train_batch], labels[:train_batch]
    out[tag + "train_step"] = r = time_calls(
        tag + "train_step", lambda: tr.train_step(xt, lt), 10, per_call["train_step"], dev)
    m = {k: v.item() for k, v in r.pop("out").items()}
    # every parameter with a gradient moves; empty_emb has none while token
    # dropout is off (p_drop_factor 0), and is in the no-decay group
    trained = [p.grad is not None for p in var.parameters()]
    changed = [not torch.equal(a, b) for a, b in zip(before, var.parameters())]
    if not (all(math.isfinite(v) for v in m.values()) and changed == trained):
        raise AssertionError(f"[main] {tag}train_step metrics {m}, {sum(changed)} parameters "
                             f"changed, {sum(trained)} have a gradient")
    _report(f"{tag}VARTrainer.train_step (VARTrainConfig())", r, train_batch,
            ", ".join(f"{k} {v:.4f}" for k, v in m.items())
            + f"; {sum(changed)}/{len(before)} parameter tensors changed over 11 steps, "
            "each one that has a gradient")
    del before
    out[tag + "eval_step"] = r = time_calls(
        tag + "eval_step", lambda: tr.eval_step(x, labels), 10, per_call["eval_step"], dev)
    ev = r.pop("out")
    if sorted(ev) != ["L_mean", "L_tail", "acc_mean", "acc_tail"] or not all(
            tuple(t.shape) == (BATCH,) and bool(torch.isfinite(t).all()) for t in ev.values()):
        raise AssertionError(f"[main] {tag}eval_step outputs malformed")
    _report(f"{tag}VARTrainer.eval_step", r, BATCH,
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
                 dtype: torch.dtype, shape: str, reps: int = 20,
                 library_call: str = "one PyTorch call") -> dict:
    """Kernel and plain version in the order plain, kernel, kernel, plain;
    then the library call (``library_call`` says what it is; None where no
    PyTorch call computes the same function); beside the bound for the
    same work."""
    with torch.inference_mode():
        p1, k1, k2, p2 = (_time_ms(fn, reps) for fn in (plain, kernel, kernel, plain))
    # outside inference mode: a library backward needs autograd
    lib = None if library is None else _time_ms(library, reps)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    b_ms, by = bound_ms(nbytes, ops, dtype)
    shown = "none" if lib is None else f"{lib:.4f} ms"
    print(f"[times] {name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
          f"(order plain, kernel, kernel, plain), library ({library_call}) {shown}; bound "
          f"{b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G ops); kernel at "
          f"{b_ms / k_ms * 100:.1f}% of the bound")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib, "library_call": library_call,
            "bound_ms": b_ms, "bound_by": by}


def _time_lse(name: str, off, on, rec: dict, reps: int = 20):
    """A forward with its lse store off and on, in the order off, on, on,
    off; both means go into the kernel's record (``ms`` stays the off
    time, from ``_time_kernel``)."""
    with torch.inference_mode():
        a1, b1, b2, a2 = (_time_ms(fn, reps) for fn in (off, on, on, off))
    rec["lse_off_ms"], rec["lse_on_ms"] = (a1 + a2) / 2, (b1 + b2) / 2
    print(f"[times] {name}: lse store off {a1:.4f}/{a2:.4f} ms, on {b1:.4f}/{b2:.4f} ms "
          f"(order off, on, on, off): {(rec['lse_on_ms'] / rec['lse_off_ms'] - 1) * 100:+.2f}%")


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
        (qkv.numel() + b * n * h * HD) * 2, 4 * b * h * n * n * HD, bf16, str(tuple(qkv.shape)),
        library_call="SDPA")
    _time_lse("#1 attention_qkv", lambda: attn.attention_qkv(qkv, h),
              lambda: attn.attention_qkv_lse(qkv, h), out["attention_qkv_fwd"])

    # 2: the encoder's shape, no bias, as the GAN step's autograd calls it:
    # with the forward's saved output and lse (prep, main and dq kernels
    # timed); the library call is the backward only of SDPA on the q, k, v
    # views of the same qkv
    b, n, h = BATCH, 499, HEADS
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(bf16)
    g = torch.randn((b, n, HD * h), generator=gen, device=dev).to(bf16)
    o_fwd, lse = attn.attention_qkv_lse(qkv, h)
    lq, lk, lv = (t.detach().requires_grad_()
                  for t in qkv.view(b, n, 3, h, HD).permute(2, 0, 3, 1, 4).unbind(0))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    lib_g = g.view(b, n, h, HD).transpose(1, 2)
    out["attention_qkv_bwd"] = _time_kernel(
        "#2 attention_qkv backward",
        lambda: attn.attention_qkv_bwd(qkv, h, None, g, o=o_fwd, lse=lse),
        lambda: attn.attention_qkv_bwd_reference(qkv, h, None, g),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        (2 * qkv.numel() + g.numel()) * 2, 5 * 2 * b * h * n * n * HD, bf16,
        f"qkv {tuple(qkv.shape)}, g {tuple(g.shape)}", library_call="SDPA backward")
    del lib_out, lq, lk, lv, o_fwd, lse

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
            f"q {tuple(q.shape)} k {tuple(k.shape)}", library_call="SDPA")
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
        f"q, k, v, g {tuple(q.shape)}", library_call="SDPA backward")

    # 4: VAR's 512 px teacher forcing under the block-causal bias (the
    # kernel's record), then the decoder's and the encoder's packed views
    # with no bias, whose plain version runs in batch slices of 8 and 4 (its
    # (B, H, N, N) fp32 scores do not fit the card at once)
    bias = build_attn_bias(PNS512).to(dev)
    l512, pairs = bias.shape[-1], int(torch.isfinite(bias).sum())
    q, k, v = _bnhd(gen, 16, l512, l512, VAR_HEADS, bf16, dev)
    out["fused_attention_qblk_fwd"] = _time_kernel(
        "#4 fused_attention_qblk, VAR teacher forcing 512",
        lambda: attn.fused_attention_qblk(q, k, v, bias, 1.0),
        lambda: attn.fused_attention_qblk_reference(q, k, v, bias, 1.0),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=bias.to(bf16), scale=1.0),
        4 * q.numel() * 2 + bias.numel() * 4, 4 * 16 * VAR_HEADS * pairs * HD, bf16,
        f"q, k, v {tuple(q.shape)}, bias {tuple(bias.shape)}", library_call="SDPA")
    _time_lse("#4 fused_attention_qblk, VAR teacher forcing 512",
              lambda: attn.fused_attention_qblk(q, k, v, bias, 1.0),
              lambda: attn.fused_attention_qblk_lse(q, k, v, bias, 1.0),
              out["fused_attention_qblk_fwd"])
    for name, n, chunk in (("decoder", 2050, 8), ("encoder", 3073, 4)):
        q, k, v = _packed_views(gen, BATCH, n, HEADS, bf16, dev)
        _time_kernel(
            f"#4 fused_attention_qblk, {name} 512 packed views (plain in slices of {chunk})",
            lambda: attn.fused_attention_qblk(q, k, v),
            lambda: _in_chunks(attn.fused_attention_qblk_reference, BATCH, chunk, q, k, v),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2)),
            4 * q.numel() * 2, 4 * BATCH * HEADS * n * n * HD, bf16,
            f"q, k, v {tuple(q.shape)} of qkv ({BATCH}, {n}, {3 * HD * HEADS})", reps=5,
            library_call="SDPA")

    # 5: VAR's 512 px training shape, block-causal bias, no dbias, as the
    # train step's autograd calls it: with the forward's saved output and lse
    # (prep, main and dq kernels timed); the plain version in batch slices
    # of 4
    q, k, v = _bnhd(gen, 16, l512, l512, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    o_fwd, lse = attn.fused_attention_qblk_lse(q, k, v, bias, 1.0)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias.to(bf16), scale=1.0)
    lib_g = g.transpose(1, 2)
    out["fused_attention_qblk_bwd"] = _time_kernel(
        "#5 fused_attention_qblk backward, VAR training 512 (plain in slices of 4)",
        lambda: attn.fused_attention_qblk_bwd(q, k, v, bias, g, 1.0, need_dbias=False,
                                              o=o_fwd, lse=lse),
        lambda: _in_chunks(attn.fused_attention_qblk_bwd_reference, 16, 4, q, k, v, bias, g,
                           1.0, need_dbias=False),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        7 * q.numel() * 2 + bias.numel() * 4, 5 * 2 * 16 * VAR_HEADS * pairs * HD, bf16,
        f"q, k, v, g {tuple(q.shape)}", reps=5, library_call="SDPA backward")
    del lib_out, lq, lk, lv, o_fwd, lse

    # 7 and 8: the VQ-4096 decoder's shape, the residual stream fp32 (every
    # block's but the first); the library column is the composed path
    # (cuBLAS GEMMs, #1 and the elementwise passes): no one PyTorch call
    # computes either sublayer
    b, n, c, h, hid = BATCH, 514, 768, HEADS, 3072
    m = b * n
    ops_a = _sublayer_operands(gen, b, n, c, 3 * c, bf16, dev)
    out["attn_sublayer_fused"] = _time_kernel(
        "#7 attn_sublayer_fused, decoder", lambda: block.attn_sublayer_fused(*ops_a, h),
        lambda: block.attn_sublayer_fused_reference(*ops_a, h),
        lambda: block.attn_sublayer(*ops_a, h),
        m * c * (2 + 4 + 4) + (3 * c * c + c * c) * 2 + (4 * c) * 2 + c * 4,
        2 * m * c * 3 * c + 4 * b * h * n * n * HD + 2 * m * c * c, bf16,
        f"xn {(b, n, c)}, {h} heads", library_call="composed path: cuBLAS, #1, elementwise")
    ops_m = _sublayer_operands(gen, b, n, c, hid, bf16, dev)
    out["mlp_sublayer_fused"] = _time_kernel(
        "#8 mlp_sublayer_fused, decoder", lambda: block.mlp_sublayer_fused(*ops_m),
        lambda: block.mlp_sublayer_fused_reference(*ops_m), lambda: block.mlp_sublayer(*ops_m),
        m * c * (2 + 4 + 4) + 2 * c * hid * 2 + (hid + c) * 2 + c * 4, 4 * m * c * hid, bf16,
        f"xn {(b, n, c)}, hidden {hid}", library_call="composed path: cuBLAS, elementwise")
    del ops_a, ops_m

    # 10: scripts/perf.py's probe shape
    m, d, hid, _ = MLP_PROBE
    x = torch.randn((m, d), generator=gen, device=dev).bfloat16()
    w1 = (torch.randn((hid, d), generator=gen, device=dev) * 0.02).bfloat16()
    w2 = (torch.randn((d, hid), generator=gen, device=dev) * 0.02).bfloat16()
    b1, b2 = torch.zeros(hid, device=dev), torch.zeros(d, device=dev)
    out["fused_mlp"] = _time_kernel(
        "#10 fused_mlp, perf.py's probe", lambda: block.fused_mlp(x, w1, b1, w2, b2),
        lambda: block.fused_mlp_reference(x, w1, b1, w2, b2), None,
        2 * m * d * 2 + 2 * d * hid * 2 + (hid + d) * 4, 4 * m * d * hid, bf16,
        f"x ({m}, {d}), hidden {hid}", library_call="none")
    del x

    # 9: the last scale of a B=64 encode
    n, vsz, c = BATCH * PNS[-1] ** 2, 4096, 32
    x = _l2n(torch.randn((n, c), generator=gen, device=dev))
    cb = _l2n(torch.randn((vsz, c), generator=gen, device=dev))
    out["codebook_argmin"] = _time_kernel(
        "#9 codebook_argmin", lambda: codebook.codebook_argmin(x, cb, True),
        lambda: codebook.codebook_argmin_reference(x, cb, True),
        lambda: torch.argmax(x @ cb.T, dim=-1),
        (n * c + vsz * c) * 4 + n * 8, 2 * n * vsz * c, torch.float32,
        f"x ({n}, {c}) codebook ({vsz}, {c})",
        library_call="x @ e.T, argmax")
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
    "fused_attention_qblk_fwd": ("imagefolder_tpu_torch/csrc/attention_qblk.cu",
                                 "imagefolder_tpu/ops/pallas/attention.py:482"),
    "fused_attention_qblk_bwd": ("imagefolder_tpu_torch/csrc/attention_qblk_bwd.cu",
                                 "imagefolder_tpu/ops/pallas/attention.py:589"),
    "codebook_argmin": ("imagefolder_tpu_torch/csrc/codebook_argmin.cu",
                        "imagefolder_tpu/ops/pallas/codebook.py:62"),
    "attn_sublayer_fused": ("imagefolder_tpu_torch/csrc/attn_sublayer.cu",
                            "imagefolder_tpu/ops/pallas/block.py:89"),
    "mlp_sublayer_fused": ("imagefolder_tpu_torch/csrc/mlp_sublayer.cu",
                           "imagefolder_tpu/ops/pallas/block.py:205"),
    "fused_mlp": ("imagefolder_tpu_torch/csrc/mlp_sublayer.cu", "scripts/perf.py:252"),
}

# launches per call of each VAR-side main path, counted from the code: ViT
# blocks (12 per encoder or decoder, ViT-B or, in the 256 px var_sample's
# decoder, ViT-S: also 12 blocks of head dim 64, so #1 12 either way), VAR-d16
# blocks (16), scales of both PQ branches (2 x 10), sampling stages (10). The
# fused sublayers (#7, #8) are off on these paths. At 256 px every attention is
# under the single-block budget (#1, #3, #6); at 512 px the encoder (N =
# 3073), the decoder (N = 2050) and teacher forcing (L = 2240) are past it
# (#4, #5), while the KV-cached decode (at most 1024 x 2240) stays on #3.
VIT_DEPTH = 12
LAUNCHES_256 = {
    "var_sample": {"fused_attention_fwd": VAR_DEPTH * len(PNS), "attention_qkv_fwd": VIT_DEPTH},
    "img_to_idxBl": {"codebook_argmin": 2 * len(PNS), "attention_qkv_fwd": VIT_DEPTH},
    "VAR.forward": {"fused_attention_fwd": VAR_DEPTH},
    "train_step": {"codebook_argmin": 2 * len(PNS), "attention_qkv_fwd": VIT_DEPTH,
                   "fused_attention_fwd": VAR_DEPTH, "fused_attention_bwd": VAR_DEPTH},
    "eval_step": {"codebook_argmin": 2 * len(PNS), "attention_qkv_fwd": VIT_DEPTH,
                  "fused_attention_fwd": VAR_DEPTH},
}
LAUNCHES_512 = {
    "round trip": {"fused_attention_qblk_fwd": 2 * VIT_DEPTH, "codebook_argmin": 2 * len(PNS512)},
    "var_sample": {"fused_attention_fwd": VAR_DEPTH * len(PNS512),
                   "fused_attention_qblk_fwd": VIT_DEPTH},
    "img_to_idxBl": {"codebook_argmin": 2 * len(PNS512), "fused_attention_qblk_fwd": VIT_DEPTH},
    "VAR.forward": {"fused_attention_qblk_fwd": VAR_DEPTH},
    "train_step": {"codebook_argmin": 2 * len(PNS512),
                   "fused_attention_qblk_fwd": VIT_DEPTH + VAR_DEPTH,
                   "fused_attention_qblk_bwd": VAR_DEPTH},
    "eval_step": {"codebook_argmin": 2 * len(PNS512),
                  "fused_attention_qblk_fwd": VIT_DEPTH + VAR_DEPTH},
}
TRAIN_BATCH_512 = 16  # the train step at L = 2240 peaks at 52 GiB of the 80 GB card


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # fp32 on the card means fp32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def lap(what: str):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s")

    phase_device()
    phase_build()
    lap("build")
    errs = {"attention_qkv_fwd": kernels_qkv(dev), "attention_qkv_bwd": kernels_qkv_bwd(dev),
            "fused_attention_fwd": kernels_bnhd(dev),
            "fused_attention_bwd": kernels_bnhd_bwd(dev),
            "fused_attention_qblk_fwd": kernels_qblk(dev),
            "fused_attention_qblk_bwd": kernels_qblk_bwd(dev),
            "codebook_argmin": kernels_codebook(dev), **kernels_sublayers(dev)}
    kernels_bwd_pieces(dev)
    lap("kernels")
    vq_models = phase_model_vq(dev)
    lap("model VQ-4096")
    phase_model_rar(dev, *vq_models)
    del vq_models
    lap("model RAR-B")
    for margs, name in ((msvr_margs("float32"), "MSVR10P2-4096 + VAR-d16"),
                        (msvr512_margs("float32"), "MSVR10P2-4096-512 + VAR-d16")):
        phase_model_train(dev, *phase_model_var(dev, margs, name), name)
        lap(f"model {name}")
    phase_model_gan(dev)
    lap("model GAN step")
    paths = {**main_round_trip(dev), **main_rar_paths(dev), **main_mlp_probe(dev)}
    lap("round trips, RAR sampling, MLP probe")
    paths.update({**main_var_paths(dev, msvr_margs("bfloat16"), "", LAUNCHES_256,
                                   bench_sample_margs("bfloat16")),
                  **main_train_paths(dev, msvr_margs("bfloat16"), "", LAUNCHES_256),
                  **main_gan_paths(dev)})
    lap("main paths at 256 px")
    paths.update({**main_var_paths(dev, msvr512_margs("bfloat16"), "512 ", LAUNCHES_512),
                  **main_train_paths(dev, msvr512_margs("bfloat16"), "512 ", LAUNCHES_512,
                                     TRAIN_BATCH_512)})
    lap("main paths at 512 px")
    times = phase_times(dev)
    lap("times")
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
