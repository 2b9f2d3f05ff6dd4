"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card
    python3 chip_smoke.py times [KERNEL ...]
    python3 chip_smoke.py outputs FILE
    python3 chip_smoke.py same FILE FILE
    python3 chip_smoke.py cli

With ``times``, only phases 1, 2 and 7 run, for the kernel records named
(``TIMES``' keys; all by default), and the last line is their JSON.
``outputs`` saves #3-#6's
results at head dims 48, 64, 80 and 128 from a fixed seed, and ``same`` compares two
such files bit for bit (run each ``outputs`` from its own checkout). To
compare two commits in one chip call, unpack each into a gitignored
directory, copy this script into each, and run it there in the order
parent, change, change, parent: each imports the package beside it.
``cli`` runs phases 1, 2 and 6 alone.

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
     at every VAR sampling stage, the 512 px last one, the teacher-forcing
     shape and edge cases, its backward (#6) at the training shape with and
     without dbias, without a bias, at L = 680, ragged, on strided views, in
     fp32 and through bf16 autograd (one #3 launch saving o and lse, one #6
     launch), the q-blocked
     attention (#4) and its backward (#5) at the 512 px shapes (VAR's L = 2240
     under the block-causal bias, the tokenizer's packed views at N = 2050 and
     3073), ragged past the JAX package's caps, in fp32 and, for #5, with
     dbias and through autograd (fp32, and bf16 at VAR's training shape);
     #4 under each bf16 bias with the blank-tile map against the same
     launch without it, bit for bit; the
     two pieces of the bf16 backward of #2, #5 and #6 (the blank-tile map,
     exact, on VAR's 512 px bias and the ragged encoder masks; the forwards'
     lse, #1, #3 and #4, whose store leaves the output unchanged), the
     codebook search (#9) at every scale of
     both multi-scale encodes, on codebooks whose rows repeat across its
     code ranges and at N below a row tile, and the fused sublayers: attention (#7) at the
     ViT-B decoder's and encoder's and at ViT-S width, the MLP (#8) at ViT-B
     and ViT-S width, the MLP probe (#10) at scripts/perf.py's shape, each
     ragged, with res = 0 and in fp32, LayerScale of order 1, #7 and #8
     through autograd, and the wrappers' refusals; then #3, #4, #5 and #6
     at head dim 48 through the same checks (RAR-B's (64, 258, 16, 48)
     under the causal mask, #4/#5 past the single-block budget); #3 and #6
     at MaskGIT-B's (64, 257, 16, 48) without a bias; #3-#6 at head dims
     32 and 40; #3-#6 at head dims 72-128 (RAR-XL's (64, 258, 16, 80),
     RAR-XXL's 88, and 72, 96, 128: the kD = 128 kernels) and at 36 and
     100 (zero-padded by the wrapper), through the same checks; #3-#6 at
     160 and 256 (the kD = 256 kernels) and the unaligned 250, fp32 and
     bf16, with one bf16 autograd launch each way, and 264 and 512 refused
     with no launch;
  4. models, card against CPU in fp32 from one seed (the RobustTok,
     disc-type, MSBR, variant and 512 px tokenizer checks with their ViTs
     at 4 of 12 blocks and DinoDisc at 6, ``check_depth_cut``: a depth cut
     for time): the VQ-4096 ViT-B
     tokenizer at B=2, then its decode and round trip with the fused
     sublayers on the card; RAR-B at full width with CFG, B=2, the same
     Gumbel noise on both sides, and its tokens decoded by that tokenizer
     (RobustTok at inference) fused on the card; RAR-B's training forward,
     ``ar_loss`` and every parameter's gradient at B=2; MaskGIT-B with each
     trunk (bert, uvit) at B=2: logits, and ``maskgit_generate``'s draws
     and re-masks in lockstep with the same Gumbel draws; one
     ``MaskGITTrainer`` step and two ``RARTrainer`` steps (loss, every
     gradient, parameters, EMA) with the same draws; for MSVR10P2-4096 and
     MSVR10P2-4096-512, each with VAR-d16, ``img_to_idxBl`` codes per scale,
     the round trip image, ``VAR.forward`` logits, greedy ``var_sample``
     tokens and images, then one ``VARTrainer`` step's loss, every
     parameter's gradient, the gradient norm and the updated parameters,
     with the same training masks on both sides; two flagship GAN
     ``TokenizerTrainer`` steps (every metric, every trainable gradient of
     the generator and the disc heads, the updated parameters, with the same
     random draws on both sides); ``configs/RobustTok.yaml`` through the
     port's loader at full width (single-scale VQ, the CLIP detail teacher,
     RobustTok's perturbation with its draws given to both sides): two
     ``TokenizerTrainer`` steps held the same way, with the perturbed codes
     and the nearest-code lists in lockstep, then two micro-steps with
     ``grad_accum_steps=2``; one step each with ``disc_type`` patchgan and
     stylegan (ViT-S tokenizer), and ``reinit_disc_heads`` on DinoDisc;
     RAR-XL's width (1280, 16 heads of 80) at 2 blocks: the training
     forward, loss and every gradient; both MSBR YAMLs built through the
     loader, MSBR10P2-4096 (BSQ) with VAR-d16 as the MSVR checks with LFQ's
     sign bits in lockstep, and one step of its YAML (both teachers,
     DinoDisc, epoch 80); one step each of VQ-4096.yaml with LoRA
     (lat_lora/lora: every frozen parameter bit-unchanged on both sides),
     learned latent pos embeds, the conv head and the siren head, and the
     CNN tokenizer's round trip and step (B=1); a code, sign bit or token
     may differ only at a near-tie, and the card then goes on from the
     CPU's choice;
  5. main paths in bf16, timed with CUDA events (a warm-up call, then
     median, min and max), each with every launch counter set to 0 just
     before its timed calls and read just after: at B=64 the VQ-4096 round
     trip, composed and then fused (``round trip fused``); RAR sampling
     (``rar sample``: ``rar_generate`` with CFG and the fused RobustTok
     decode; then the generator and the decode alone); RAR-B's training
     forward and backward (``rar train fwd+bwd``); MaskGIT-B sampling
     (``maskgit sample``: ``maskgit_generate`` at its defaults and the fused
     RobustTok decode), ``maskgit train step`` and ``rar train step`` (the
     whole trainer steps); the MLP probe (12
     chained #10 calls at scripts/perf.py's shape); for both multi-scale
     configurations ``var_sample`` (cfg 1.5, top-k 900, top-p 0.96; at 256 px
     decoded by bench.py's sample-leg tokenizer, ViT-S), ``img_to_idxBl``,
     the teacher-forcing ``VAR.forward``, ``VARTrainer.train_step`` (B=16 at
     512 px) and ``eval_step``, and the 512 px round trip; the flagship
     GAN ``TokenizerTrainer.train_step``; and ``RobustTok train_step``
     (``configs/RobustTok.yaml`` as the loader gives it, 64 images a
     micro-step with ``grad_accum_steps=2``, at epoch 80 of the anneal
     window), with the perturbed samples checked; RAR-XL's width at 8
     blocks (``rar-xl train fwd+bwd``); MSBR10P2-4096's tokenizer train step
     (``msbr train_step``, epoch 80) and round trip, and ``var_sample``,
     ``img_to_idxBl``, ``VAR.forward`` and VAR's train and eval steps on its
     codes (``var msbr ...``);
     the train step and round trip of VQ-4096.yaml with LoRA, latent pos
     embeds, the conv head and the siren head, and of the CNN tokenizer
     (its train step at B=16), each trainable parameter moved and each
     frozen one unchanged;
  6. the tokenizer's CLIs from their ``main(argv)`` in a temporary
     directory of 128 train and 32 val PNGs (256 px, seed 0) with a seeded
     Inception: ``train_tokenizer`` on configs/RobustTok.yaml at B=64 for 4
     steps (2 epochs, the discriminator on from epoch 1, a checkpoint, the
     best by val rFID over one batch and a recon grid every 2 steps), each
     step's launches (#1 84, #2 48) and time; its exact resume at B=8 (2
     steps, stop, ``--resume`` to 4, against 4 straight, every tensor
     compared); ``eval_reconstruction`` on the trained checkpoint card
     against CPU in fp32 over 8 images (PSNR, SSIM, pool3; codes in
     lockstep), with ``--perturb`` over 32, and on MSVR10P2-4096.yaml from
     a ``hub``-written weight file (#9 20 a batch); ``evaluate_fid`` on two
     npz batches of 64;
  7. times: each kernel (#2, #5 and #6 as training calls them, with the
     forward's saved output and lse, #6 through autograd; #1, #3 and #4
     also with the lse store on, #3 as the train step's autograd runs its
     forward; #3 at the last 256 px sampling stage, teacher forcing, the
     512 px last sampling stage, RAR-B's teacher forcing and MaskGIT-B's
     shape; #6 also at RAR-B's and MaskGIT-B's training shapes; #3 and #6
     at RAR-XL's and RAR-XXL's (64, 258, 16, 80 | 88) and at head dim 256,
     (16, 258, 4, 256); #9 at every
     scale of both encodes, each a CUDA
     graph of 20 calls, with its sums per encode),
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

import contextlib
import copy
import dataclasses
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
from imagefolder_tpu_torch.losses.discriminators import DinoDisc
from imagefolder_tpu_torch.models import build_maskgit, build_rar, build_vae_var
from imagefolder_tpu_torch.models import maskgit as maskgit_mod
from imagefolder_tpu_torch.models import rar as rar_mod
from imagefolder_tpu_torch.models import tokenizer as tokenizer_mod
from imagefolder_tpu_torch.models import vit as vit_mod
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.models.vit import LayerScale, set_fused_sublayers
from imagefolder_tpu_torch.ops import perturb, quantize
from imagefolder_tpu_torch.ops.cuda import _build
from imagefolder_tpu_torch.ops.cuda import attention as attn
from imagefolder_tpu_torch.ops.cuda import block
from imagefolder_tpu_torch.ops.cuda import codebook
from imagefolder_tpu_torch.train import var_train
from imagefolder_tpu_torch.train.rar_train import (MaskGITTrainer, RARTrainConfig, RARTrainer,
                                                   get_rar_random_ratio)
from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer, get_random_ratio
from imagefolder_tpu_torch.train.var_train import VARTrainConfig, VARTrainer
from imagefolder_tpu_torch.utils.config import load_tokenizer_config

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


def _fwd_check(what: str, got: torch.Tensor, want: torch.Tensor,
               hd: int = HD) -> tuple[float, str]:
    """A forward kernel's output against its plain version's: both finite,
    the max abs error within TOL, and in bf16 every element's error within
    BF16_REL * |plain| + ROW_SHARE * (the RMS of its head's ``hd`` outputs
    at that position). The per-element bound follows the size of the values: a
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
    diff = (got.float() - want.float()).abs().reshape(-1, hd)
    err = diff.max().item()
    _check(what, err, TOL[got.dtype])
    if got.dtype != torch.bfloat16:
        return err, f"(tol {TOL[got.dtype]:g})"
    size = want.float().abs().reshape(-1, hd)
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

CARD = ""  # nvidia-smi's "name, power limit" of the card, set by phase_device


def phase_device():
    global CARD
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD = line
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
    for line in _build.compile_seconds():
        print(f"[build] nvcc seconds {line}")
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


def _bnhd(gen, b, lq, lk, h, dtype, dev, l2=True, hd=HD):
    """q (B, Lq, H, hd), k and v (B, Lk, H, hd) as VAR's attention makes them:
    with attn_l2_norm, L2-normed q times its temperature (4 at init) and
    L2-normed k, read at scale 1; with ``l2`` False, unit normals (RAR's
    qk-normed q and k at scale 1/sqrt(hd))."""
    q = torch.randn((b, lq, h, hd), generator=gen, device=dev)
    k = torch.randn((b, lk, h, hd), generator=gen, device=dev)
    v = torch.randn((b, lk, h, hd), generator=gen, device=dev)
    if l2:
        q, k = _l2n(q) * 4.0, _l2n(k)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def kernels_bnhd(dev) -> float:
    """#3 against its plain version; returns the largest bf16 error at the
    main paths' shapes (the 256 px sampling stages, teacher forcing and the
    512 px last sampling stage, whose plain version runs in batch slices)."""
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
    l512 = sum(p * p for p in PNS512)
    cases.append(("512 px last sample stage", *_bnhd(gen, 2 * BATCH, PNS512[-1] ** 2, l512,
                                                     VAR_HEADS, bf16, dev), None, 1.0, True))
    cases.append(("teacher forcing", *_bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev),
                  tf_bias, 1.0, True))
    cases.append(("teacher forcing fp32", *_bnhd(gen, 2, ltot, ltot, VAR_HEADS, f32, dev),
                  tf_bias, 1.0, False))
    cases.append(("last stage fp32", *_bnhd(gen, 4, 121, ltot, VAR_HEADS, f32, dev),
                  None, 1.0, False))
    cases.append(("ragged", *_bnhd(gen, 3, 37, 77, 4, bf16, dev, l2=False), None, None, False))
    cases.append(("Lq=1", *_bnhd(gen, 5, 1, 2, 4, bf16, dev), None, 1.0, False))
    cases.append(("Lq=1 fp32", *_bnhd(gen, 5, 1, 2, 4, f32, dev), None, 1.0, False))
    # the stride of a size-1 axis is never read: this view is not copied
    q1 = torch.randn((2, 4, HD), generator=gen, device=dev).bfloat16()
    cases.append(("Lq=1, odd row stride", q1.as_strided((2, 1, 4, HD), (4 * HD, 3, HD, 1)),
                  *_bnhd(gen, 2, 1, 9, 4, bf16, dev)[1:], None, 1.0, False))
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
        want = _in_chunks(attn.fused_attention_reference, q.shape[0], 16, q, k, v, bias, scale)
        torch.cuda.synchronize()
        err, note = _fwd_check(f"[kernels] #3 {name}", got, want)
        print(f"[kernels] #3 {name:24s} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]:8s} bias={'none' if bias is None else tuple(bias.shape)} "
              f"max_abs_err {err:.3e} {note}")
        if main:
            main_err = max(main_err, err)
        del got, want
    return main_err


def kernels_bnhd_bwd(dev) -> float:
    """#6 against its plain version: for each of dq, dk, dv (and dbias), the
    max abs error over the max abs of the plain result. The bf16 calls
    without dbias run the wgmma backward on #3's o and lse (a direct call
    first runs #3 with its lse store); fp32, dbias and L = 1 calls the
    two-kernel design. dbias sums ds over B*H heads with fp32 atomics in an order that
    changes from run to run; its terms are the same fp32 values as the
    plain version's, so it is held to the same bound. Then bf16 autograd at
    the training shape through ``dot_product_attention``, as the train step
    runs it: one #3 launch (lse saved) and one #6 launch. Returns the
    largest error at the training shape."""
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
    q, k, v = _bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    before = (attn.FUSED_LAUNCHES, attn.FUSED_BWD_LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attn.dot_product_attention(*leaves, tf_bias, 1.0), leaves, g)
    want = attn.fused_attention_bwd_reference(q, k, v, tf_bias, g, 1.0, need_dbias=False)
    torch.cuda.synchronize()
    counts = [attn.FUSED_LAUNCHES - before[0], attn.FUSED_BWD_LAUNCHES - before[1]]
    if counts != [1, 1]:
        raise AssertionError(f"[kernels] #6 bf16 autograd launched #3, #6 {counts}, want [1, 1]")
    errs = _bwd_errs("#6", "bf16 autograd", got, want[:3], ("dq", "dk", "dv"))
    print(f"[kernels] #6 bf16 autograd of dot_product_attention, training shape q "
          f"{tuple(q.shape)}: one #3 launch (lse saved), one #6 launch, error over max |plain| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {TOL[bf16]:g})")
    for what, e in errs.items():
        _check(f"[kernels] #6 bf16 autograd {what}", e, TOL[bf16])
    return max(main_err, *errs.values())


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
    on unaligned rows, and in fp32; then each biased bf16 case with the
    blank-tile map against the launch without one, bit for bit. Returns the
    largest bf16 error at the main paths' shapes."""
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
        ("ragged L=2305, encoder mask", *_bnhd(gen, 3, 2305, 2305, 4, bf16, dev),
         encoder_mask(2305, 768, dev, 64), 1.0, 3, False),
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
    # the blank-tile map changes no bit: each biased bf16 case with the
    # map (the default: the pre-pass writes it, the forward skips the tiles
    # it blanks) against the same launch with none (every tile computed)
    for name, q, k, v, bias, scale, _, _ in cases:
        if bias is None or q.dtype != bf16:
            continue
        skipped = attn._fused_attention_qblk_cuda(q, k, v, bias, scale)
        computed = attn._fused_attention_qblk_cuda(q, k, v, bias, scale, skip_blank=False)
        torch.cuda.synchronize()
        copied = attn.block_key_tiles_reference(bias)
        blank = attn.blank_tile_map_reference(bias)
        if not torch.equal(skipped, computed):
            raise AssertionError(f"[kernels] #4 {name}: the blank-tile map changed "
                                 f"{int((skipped != computed).sum())} outputs")
        print(f"[kernels] #4 {name:28s} with the blank-tile map: bit-equal to every tile "
              f"computed; {int(blank.sum())} of {blank.numel()} (64 q, 64 key) tiles skipped, "
              f"{int(copied.sum())} of {copied.numel()} (128 q, 64 key) block copies made")
        del skipped, computed
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
    """The two pieces that the bf16 backward of #2, #5 and #6 adds, against
    their plain versions: the blank-tile map (exact) on VAR's 512 px block-
    causal bias and on the ragged encoder masks at L = 2049 and 2305; and
    the forwards' lse (#4 on VAR's 512 px shape and the encoder's packed
    views, #1 at the GAN encoder's shape and under its mask, #3 at the last
    256 px sampling stage, teacher forcing, the 512 px last sampling stage
    (streamed k and v) and a ragged shape with a per-(B, H) bias), error
    over the plain lse's max abs within TOL, and the output bit-equal with
    the store on and off."""
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
    cases = []  # (name, q, k, bias, scale, forward with lse, forward without)
    for name, (b, n), dtype, bias in (("#4 VAR 512", (4, ltot), bf16, tf_bias),
                                      ("#4 VAR 512 fp32", (2, ltot), f32, tf_bias)):
        q, k, v = _bnhd(gen, b, n, n, VAR_HEADS, dtype, dev)
        cases.append((name, q, k, bias, 1.0,
                      lambda q=q, k=k, v=v, bias=bias: attn.fused_attention_qblk_lse(
                          q, k, v, bias, 1.0),
                      lambda q=q, k=k, v=v, bias=bias: attn.fused_attention_qblk(
                          q, k, v, bias, 1.0)))
    q, k, v = _packed_views(gen, 2, 3073, HEADS, bf16, dev)
    cases.append(("#4 encoder 512 packed views", q, k, None, None,
                  lambda q=q, k=k, v=v: attn.fused_attention_qblk_lse(q, k, v),
                  lambda q=q, k=k, v=v: attn.fused_attention_qblk(q, k, v)))
    for name, (b, n), dtype, bias in (("#1 encoder MSVR10P2", (BATCH, 499), bf16, None),
                                      ("#1 encoder fp32", (2, 499), f32, None),
                                      ("#1 masked", (8, 513), bf16, encoder_mask(513, 256, dev))):
        qkv = torch.randn((b, n, 3 * HD * HEADS), generator=gen, device=dev).to(dtype)
        cases.append((name, *qkv.view(b, n, 3, HEADS, HD).unbind(2)[:2], bias, None,
                      lambda qkv=qkv, bias=bias: attn.attention_qkv_lse(qkv, HEADS, bias),
                      lambda qkv=qkv, bias=bias: attn.attention_qkv(qkv, HEADS, bias)))
    ltot256 = sum(p * p for p in PNS)
    per_bh = torch.randn((3, 4, 37, 77), generator=gen, device=dev)
    per_bh[:, :, :9, :64] = float("-inf")  # the first key tile blank for the early rows
    for name, (b, lq, lk, h), bias, scale in (
            ("#3 last 256 px sample stage", (2 * BATCH, PNS[-1] ** 2, ltot256, VAR_HEADS), None,
             1.0),
            ("#3 teacher forcing", (BATCH, ltot256, ltot256, VAR_HEADS),
             build_attn_bias(PNS).to(dev), 1.0),
            ("#3 512 px last sample stage", (8, PNS512[-1] ** 2, ltot, VAR_HEADS), None, 1.0),
            ("#3 ragged, per-(B,H) bias", (3, 37, 77, 4), per_bh, None)):
        q, k, v = _bnhd(gen, b, lq, lk, h, bf16, dev, l2=scale is not None)
        cases.append((name, q, k, bias, scale,
                      lambda q=q, k=k, v=v, bias=bias, scale=scale: attn.fused_attention_lse(
                          q, k, v, bias, scale),
                      lambda q=q, k=k, v=v, bias=bias, scale=scale: attn.fused_attention(
                          q, k, v, bias, scale)))
    for name, q, k, bias, scale, with_lse, without in cases:
        out, lse = with_lse()
        want = attn.attention_lse_reference(q, k, bias, scale)
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


RAR_HEADS, RAR_HD = 16, 48  # RAR-B: 768 wide, 16 heads of 48
RAR_SEQ = 258  # RAR-B's training sequence: [cls, cond] and 256 tokens


def _causal(n: int, dev) -> torch.Tensor:
    """RAR's training mask (``RAR.forward``): (1, 1, n, n), -inf above the
    diagonal."""
    pos = torch.arange(n, device=dev)
    return torch.zeros(n, n, device=dev).masked_fill(
        pos[:, None] < pos[None, :], float("-inf"))[None, None]


def _fwd_cases_hd(num: str, fn, ref, cases, hd: int):
    """A forward kernel ``fn`` against its plain version ``ref`` on each
    (name, q, k, v, bias) case at scale 1/sqrt(hd), under ``_fwd_check``."""
    scale = 1.0 / math.sqrt(hd)
    for name, q, k, v, bias in cases:
        got = fn(q, k, v, bias, scale)
        want = ref(q, k, v, bias, scale)
        torch.cuda.synchronize()
        err, note = _fwd_check(f"[kernels] {num} hd {hd} {name}", got, want, hd=hd)
        print(f"[kernels] {num} hd {hd} {name:28s} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]:8s} bias={'none' if bias is None else tuple(bias.shape)} "
              f"max_abs_err {err:.3e} {note}")
        del got, want


def _bwd_cases_hd(num: str, fn, ref, cases, hd: int, gen):
    """A backward kernel ``fn`` against its plain version ``ref`` on each
    (name, q, k, v, bias, dbias) case at scale 1/sqrt(hd): each gradient's
    max abs error over the plain result's max abs within TOL."""
    scale = 1.0 / math.sqrt(hd)
    for name, q, k, v, bias, need_db in cases:
        g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
        got = fn(q, k, v, bias, g, scale, need_dbias=need_db)
        want = ref(q, k, v, bias, g, scale, need_dbias=need_db)
        torch.cuda.synchronize()
        errs = _bwd_errs(num, name, got, want)
        print(f"[kernels] {num} hd {hd} {name:31s} q {tuple(q.shape)} {str(q.dtype)[6:]:8s} "
              f"bias={'none' if bias is None else tuple(bias.shape)}: error over max |plain| "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {TOL[q.dtype]:g})")
        for what, e in errs.items():
            _check(f"[kernels] {num} hd {hd} {name} {what}", e, TOL[q.dtype])
        del got, want


def _autograd_hd(num: str, counters, q, k, v, bias, gen) -> None:
    """bf16 autograd through ``dot_product_attention`` at q's head dim, as a
    training step runs it: one forward launch (lse saved), one backward
    launch (the two ``attn`` counters named), gradients against the plain
    backward within TOL."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    before = [getattr(attn, c) for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attn.dot_product_attention(*leaves, bias, scale), leaves, g)
    want = attn.fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias=False)
    torch.cuda.synchronize()
    counts = [getattr(attn, c) - b for c, b in zip(counters, before)]
    if counts != [1, 1]:
        raise AssertionError(f"[kernels] {num} hd {hd} bf16 autograd launched {counts}, "
                             "want [1, 1]")
    errs = _bwd_errs(num, "bf16 autograd", got, want[:3], ("dq", "dk", "dv"))
    print(f"[kernels] {num} hd {hd} bf16 autograd of dot_product_attention q {tuple(q.shape)} "
          f"bias={'none' if bias is None else tuple(bias.shape)}: one forward launch (lse "
          f"saved), one backward launch, error over max |plain| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {TOL[q.dtype]:g})")
    for what, e in errs.items():
        _check(f"[kernels] {num} hd {hd} bf16 autograd {what}", e, TOL[q.dtype])


def kernels_hd48(dev):
    """#3, #4, #5 and #6 at head dim 48 (RAR-B's 768 / 16, run on the
    kernels' 64-wide tiles zero-padded), through the checks they pass at 64:
    #3 at RAR-B's teacher forcing (64, 258, 16, 48) under the causal mask, in
    fp32, cross-length, with k and v streamed (Lk past the resident 320),
    Lq = 1, a per-(B, H) bias, strided views of a fused qkv, unaligned rows;
    #6 at RAR-B's training shape with dbias off (the wgmma backward) and on,
    with no bias, in fp32, ragged (L = 1, 37, 130) and on strided views; #4
    and #5 at a small L past the single-block budget (2100, 2049 ragged,
    1500 x 2500 for #4), under an encoder mask and in fp32, #4 bit-equal
    with and without its blank-tile map; then bf16 autograd through the
    router for the pair each side of the budget."""
    bf16, f32 = torch.bfloat16, torch.float32
    hd = RAR_HD
    gen = torch.Generator(device=dev).manual_seed(SEED + 48)
    causal = _causal(RAR_SEQ, dev)

    def bnhd(b, lq, lk, h, dtype):
        return _bnhd(gen, b, lq, lk, h, dtype, dev, l2=False, hd=hd)

    rar = (RAR_SEQ, RAR_SEQ, RAR_HEADS)
    qkv = torch.randn((4, 30, 3, RAR_HEADS, hd), generator=gen, device=dev).bfloat16()
    wide = torch.randn((3, 40, 4, hd + 1), generator=gen, device=dev).bfloat16()
    per_bh = torch.randn((2, 4, 37, 45), generator=gen, device=dev)
    per_bh[..., 5:9] = float("-inf")
    _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, [
        ("RAR-B teacher forcing", *bnhd(BATCH, *rar, bf16), causal),
        ("RAR-B teacher forcing fp32", *bnhd(2, *rar, f32), causal),
        ("cross length 37 x 77", *bnhd(3, 37, 77, 4, bf16), None),
        ("streamed k, v: 100 x 700", *bnhd(4, 100, 700, 4, bf16), None),
        ("Lq=1", *bnhd(5, 1, 2, 4, bf16), None),
        ("Lq=1 fp32", *bnhd(5, 1, 2, 4, f32), None),
        ("per-(B,H) bias", *bnhd(2, 37, 45, 4, bf16), per_bh),
        ("per-(B,H) bias fp32", *bnhd(2, 37, 45, 4, f32), per_bh),
        ("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev)),
        ("unaligned rows", wide[:, :21, :, :hd], wide[..., :hd], wide[..., 1:], None)], hd)
    bwd = [
        ("RAR-B training, dbias off", *bnhd(BATCH, *rar, bf16), causal, False),
        ("RAR-B training, dbias on", *bnhd(8, *rar, bf16), causal, True),
        ("RAR-B training, no bias", *bnhd(BATCH, *rar, bf16), None, False),
        ("RAR-B training fp32, dbias on", *bnhd(2, *rar, f32), causal, True)]
    for n in (1, 37, 130):
        bwd.append((f"ragged L={n}", *bnhd(3, n, n, 4, bf16), None, False))
        bwd.append((f"ragged L={n}, bias", *bnhd(3, n, n, 4, bf16),
                    encoder_mask(n, n // 3, dev), True))
    bwd += [("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev), True),
            ("ragged L=37 fp32", *bnhd(3, 37, 37, 4, f32), None, False)]
    _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, bwd,
                    hd, gen)
    _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                   *bnhd(BATCH, *rar, bf16), causal, gen)
    del bwd
    mask = encoder_mask(2100, 700, dev, 64)
    qblk = [("L=2100, encoder mask", *bnhd(2, 2100, 2100, 4, bf16), mask),
            ("ragged L=2049, no bias", *bnhd(2, 2049, 2049, 4, bf16), None),
            ("cross length 1500 x 2500", *bnhd(2, 1500, 2500, 4, bf16), None),
            ("L=2100 fp32, encoder mask", *bnhd(2, 2100, 2100, 4, f32), mask)]
    _fwd_cases_hd("#4", attn.fused_attention_qblk, attn.fused_attention_qblk_reference,
                    qblk, hd)
    _blank_map_bit_equal(qblk[0][0], *qblk[0][1:], hd)
    _bwd_cases_hd("#5", attn.fused_attention_qblk_bwd,
                    attn.fused_attention_qblk_bwd_reference, [
        ("L=2100, encoder mask, dbias off", *qblk[0][1:4], mask, False),
        ("L=2100, encoder mask, dbias on", *qblk[0][1:4], mask, True),
        ("ragged L=2049, no bias", *qblk[1][1:4], None, False),
        ("L=2100 fp32, dbias on", *qblk[3][1:4], mask, True)], hd, gen)
    _autograd_hd("#4/#5", ("QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES"), *qblk[0][1:4], mask, gen)


MASKGIT_SEQ = 257  # MaskGIT-B's sequence: the condition token and 256 image tokens
NARROW_HDS = (32, 40)  # head widths below 48 that the BNHD kernels run on 48's code


def _blank_map_bit_equal(what: str, q, k, v, bias, hd: int):
    """#4 with its blank-tile map against the same launch computing every
    tile: bit-equal."""
    skipped = attn._fused_attention_qblk_cuda(q, k, v, bias, 1.0 / math.sqrt(hd))
    computed = attn._fused_attention_qblk_cuda(q, k, v, bias, 1.0 / math.sqrt(hd),
                                               skip_blank=False)
    torch.cuda.synchronize()
    if not torch.equal(skipped, computed):
        raise AssertionError(f"[kernels] #4 hd {hd} {what}: the blank-tile map changed "
                             f"{int((skipped != computed).sum())} outputs")
    print(f"[kernels] #4 hd {hd} {what}: with the blank-tile map bit-equal to every tile "
          "computed")


def kernels_maskgit_and_narrow_heads(dev):
    """#3 and #6 at MaskGIT-B's (64, 257, 16, 48) with no bias (its
    bidirectional trunk), in bf16 and fp32 and through bf16 autograd (one
    launch each); then the head widths below 48 that run on the kD = 48
    code at run time (``NARROW_HDS``): #3 and #6 at a small shape (L = 130
    under the causal mask and without a bias, cross length, streamed k and
    v, dbias on, fp32, bf16 autograd), and #4 and #5 at head dim 32 past
    the single-block budget (L = 2100 under an encoder mask, ragged 2049
    without a bias, fp32, #4 bit-equal with and without its blank-tile map,
    bf16 autograd)."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + MASKGIT_SEQ)

    def bnhd(b, lq, lk, h, dtype, hd):
        return _bnhd(gen, b, lq, lk, h, dtype, dev, l2=False, hd=hd)

    mg = (MASKGIT_SEQ, MASKGIT_SEQ, RAR_HEADS)
    _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, [
        ("MaskGIT-B, no bias", *bnhd(BATCH, *mg, bf16, RAR_HD), None),
        ("MaskGIT-B fp32, no bias", *bnhd(BATCH, *mg, f32, RAR_HD), None)], RAR_HD)
    _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, [
        ("MaskGIT-B training, no bias", *bnhd(BATCH, *mg, bf16, RAR_HD), None, False),
        ("MaskGIT-B training fp32, no bias", *bnhd(BATCH, *mg, f32, RAR_HD), None, False)],
        RAR_HD, gen)
    _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                 *bnhd(BATCH, *mg, bf16, RAR_HD), None, gen)
    causal = _causal(130, dev)
    for hd in NARROW_HDS:
        _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, [
            ("L=130, causal", *bnhd(4, 130, 130, 4, bf16, hd), causal),
            ("L=130, no bias", *bnhd(4, 130, 130, 4, bf16, hd), None),
            ("L=130 fp32, causal", *bnhd(2, 130, 130, 4, f32, hd), causal),
            ("cross length 37 x 77", *bnhd(3, 37, 77, 4, bf16, hd), None),
            ("streamed k, v: 100 x 700", *bnhd(4, 100, 700, 4, bf16, hd), None)], hd)
        _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, [
            ("L=130, causal, dbias off", *bnhd(4, 130, 130, 4, bf16, hd), causal, False),
            ("L=130, no bias", *bnhd(4, 130, 130, 4, bf16, hd), None, False),
            ("L=130, causal, dbias on", *bnhd(4, 130, 130, 4, bf16, hd), causal, True),
            ("ragged L=37 fp32", *bnhd(3, 37, 37, 4, f32, hd), None, False)], hd, gen)
        _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                     *bnhd(4, 130, 130, 4, bf16, hd), causal, gen)
    hd = NARROW_HDS[0]
    mask = encoder_mask(2100, 700, dev, 64)
    qblk = [("L=2100, encoder mask", *bnhd(2, 2100, 2100, 4, bf16, hd), mask),
            ("ragged L=2049, no bias", *bnhd(2, 2049, 2049, 4, bf16, hd), None),
            ("L=2100 fp32, encoder mask", *bnhd(2, 2100, 2100, 4, f32, hd), mask)]
    _fwd_cases_hd("#4", attn.fused_attention_qblk, attn.fused_attention_qblk_reference,
                  qblk, hd)
    _blank_map_bit_equal(qblk[0][0], *qblk[0][1:], hd)
    _bwd_cases_hd("#5", attn.fused_attention_qblk_bwd,
                  attn.fused_attention_qblk_bwd_reference, [
        ("L=2100, encoder mask, dbias off", *qblk[0][1:4], mask, False),
        ("ragged L=2049, no bias", *qblk[1][1:4], None, False),
        ("L=2100 fp32, dbias on", *qblk[2][1:4], mask, True)], hd, gen)
    _autograd_hd("#4/#5", ("QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES"), *qblk[0][1:4], mask, gen)


RARXL_HEADS, RARXL_HD = 16, 80  # RAR-XL: 1280 wide, 16 heads of 80
RARXXL_HD = 88                  # RAR-XXL: 1408 / 16
WIDE_HDS = (72, 96, 128)        # with 80 and 88: the widths the kD = 128 code runs
UNALIGNED_HDS = (36, 100)       # not multiples of 8: zero-padded to 40 and 104 first


def kernels_wide_heads(dev):
    """#3-#6 at head widths past 64 (the kD = 128 instantiations) and at
    widths that are not a multiple of 8 (the wrapper's zero padding): #3 and
    #6 at RAR-XL's (64, 258, 16, 80) and RAR-XXL's 88 under the causal mask
    and without a bias, bf16 (dbias off: the two-kernel backward; on) and
    fp32, and through bf16 autograd (one launch each); at 72, 96, 128, 36
    and 100 the edge cases of 48's and 64's (cross length, streamed k and
    v, Lq = 1, a per-(B, H) bias, strided and unaligned views, ragged L);
    #4 and #5 past the single-block budget at 80, 128 and 100 (L = 2100
    under an encoder mask, ragged 2049 without a bias, fp32, #4 bit-equal
    with and without its blank-tile map, bf16 autograd). Heads of 136-256
    are ``kernels_hd256``'s."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 128)

    def bnhd(b, lq, lk, h, dtype, hd):
        return _bnhd(gen, b, lq, lk, h, dtype, dev, l2=False, hd=hd)

    rar = (RAR_SEQ, RAR_SEQ, RARXL_HEADS)
    causal = _causal(RAR_SEQ, dev)
    for hd in (RARXL_HD, RARXXL_HD):
        _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, [
            ("RAR-XL/XXL teacher forcing", *bnhd(BATCH, *rar, bf16, hd), causal),
            ("RAR-XL/XXL, no bias", *bnhd(BATCH, *rar, bf16, hd), None),
            ("RAR-XL/XXL fp32", *bnhd(2, *rar, f32, hd), causal)], hd)
        _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, [
            ("RAR-XL/XXL training, dbias off", *bnhd(BATCH, *rar, bf16, hd), causal, False),
            ("RAR-XL/XXL training, no bias", *bnhd(BATCH, *rar, bf16, hd), None, False),
            ("RAR-XL/XXL training, dbias on", *bnhd(8, *rar, bf16, hd), causal, True),
            ("RAR-XL/XXL training fp32", *bnhd(2, *rar, f32, hd), causal, True)], hd, gen)
        _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                     *bnhd(BATCH, *rar, bf16, hd), causal, gen)
    small = _causal(130, dev)
    for hd in WIDE_HDS + UNALIGNED_HDS:
        qkv = torch.randn((4, 30, 3, 4, hd), generator=gen, device=dev).bfloat16()
        wide = torch.randn((3, 40, 4, hd + 1), generator=gen, device=dev).bfloat16()
        per_bh = torch.randn((2, 4, 37, 45), generator=gen, device=dev)
        per_bh[..., 5:9] = float("-inf")
        _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, [
            ("L=130, causal", *bnhd(4, 130, 130, 4, bf16, hd), small),
            ("L=130, no bias", *bnhd(4, 130, 130, 4, bf16, hd), None),
            ("L=130 fp32, causal", *bnhd(2, 130, 130, 4, f32, hd), small),
            ("cross length 37 x 77", *bnhd(3, 37, 77, 4, bf16, hd), None),
            ("streamed k, v: 100 x 700", *bnhd(4, 100, 700, 4, bf16, hd), None),
            ("Lq=1", *bnhd(5, 1, 2, 4, bf16, hd), None),
            ("per-(B,H) bias", *bnhd(2, 37, 45, 4, bf16, hd), per_bh),
            ("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev)),
            ("unaligned rows", wide[:, :21, :, :hd], wide[..., :hd], wide[..., 1:], None)], hd)
        _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, [
            ("L=130, causal, dbias off", *bnhd(4, 130, 130, 4, bf16, hd), small, False),
            ("L=130, no bias", *bnhd(4, 130, 130, 4, bf16, hd), None, False),
            ("L=130, causal, dbias on", *bnhd(4, 130, 130, 4, bf16, hd), small, True),
            ("ragged L=1", *bnhd(3, 1, 1, 4, bf16, hd), None, False),
            ("ragged L=37 fp32", *bnhd(3, 37, 37, 4, f32, hd), None, False),
            ("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev), True)],
            hd, gen)
        _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                     *bnhd(4, 130, 130, 4, bf16, hd), small, gen)
    mask = encoder_mask(2100, 700, dev, 64)
    for hd in (RARXL_HD, 128, UNALIGNED_HDS[1]):
        qblk = [("L=2100, encoder mask", *bnhd(2, 2100, 2100, 4, bf16, hd), mask),
                ("ragged L=2049, no bias", *bnhd(2, 2049, 2049, 4, bf16, hd), None),
                ("L=2100 fp32, encoder mask", *bnhd(1, 2100, 2100, 4, f32, hd), mask)]
        _fwd_cases_hd("#4", attn.fused_attention_qblk, attn.fused_attention_qblk_reference,
                      qblk, hd)
        _blank_map_bit_equal(qblk[0][0], *qblk[0][1:], hd)
        _bwd_cases_hd("#5", attn.fused_attention_qblk_bwd,
                      attn.fused_attention_qblk_bwd_reference, [
            ("L=2100, encoder mask, dbias off", *qblk[0][1:4], mask, False),
            ("ragged L=2049, no bias", *qblk[1][1:4], None, False),
            ("L=2100 fp32, dbias on", *qblk[2][1:4], mask, True)], hd, gen)
        _autograd_hd("#4/#5", ("QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES"), *qblk[0][1:4], mask, gen)
        del qblk



HD256 = 256                    # a generator of hidden 1024 over 4 heads
HD256_BATCH, HD256_HEADS = 16, 4
HD256_HDS = (160, HD256)       # multiples of 8 that the kD = 256 kernels run
HD256_UNALIGNED = 250          # zero-padded to 256 by the wrapper
TOO_WIDE_HDS = (264, 512)      # past the widest instantiation: refused


def kernels_hd256(dev):
    """#3-#6 at head widths 136-256 (the kD = 256 FMA kernels of
    csrc/attention_wide.cuh), against their plain versions: at 160 and 256,
    #3 and #6 at (16, 258, 4, hd) under the causal mask and without a bias,
    bf16 (dbias off and on) and fp32, cross length, Lq = 1, a per-(B, H)
    bias, strided qkv views, ragged L; #4 and #5 past the single-block
    budget (L = 2100 under an encoder mask, ragged 2049 without a bias, fp32
    with dbias); one bf16 autograd launch each way through each router; at
    the unaligned 250 (zero-padded to 256) the same through a smaller set;
    then heads of 264 and 512 refused by #3-#6 with no launch."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 256)

    def bnhd(b, lq, lk, h, dtype, hd):
        return _bnhd(gen, b, lq, lk, h, dtype, dev, l2=False, hd=hd)

    rar = (RAR_SEQ, RAR_SEQ, HD256_HEADS)
    causal = _causal(RAR_SEQ, dev)
    mask = encoder_mask(2100, 700, dev, 64)
    for hd in HD256_HDS + (HD256_UNALIGNED,):
        full = hd in HD256_HDS
        qkv = torch.randn((2, 30, 3, 4, hd), generator=gen, device=dev).bfloat16()
        per_bh = torch.randn((2, 4, 37, 45), generator=gen, device=dev)
        per_bh[..., 5:9] = float("-inf")
        fwd = [("causal L=258", *bnhd(HD256_BATCH, *rar, bf16, hd), causal),
               ("fp32, causal L=258", *bnhd(2, *rar, f32, hd), causal)]
        if full:
            fwd += [("no bias L=258", *bnhd(HD256_BATCH, *rar, bf16, hd), None),
                    ("cross length 37 x 77", *bnhd(3, 37, 77, 4, bf16, hd), None),
                    ("Lq=1", *bnhd(5, 1, 2, 4, bf16, hd), None),
                    ("per-(B,H) bias", *bnhd(2, 37, 45, 4, bf16, hd), per_bh),
                    ("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev))]
        _fwd_cases_hd("#3", attn.fused_attention, attn.fused_attention_reference, fwd, hd)
        bwd = [("causal L=258, dbias off", *bnhd(HD256_BATCH, *rar, bf16, hd), causal, False),
               ("fp32, causal L=258, dbias on", *bnhd(2, *rar, f32, hd), causal, True)]
        if full:
            bwd += [("no bias L=258", *bnhd(HD256_BATCH, *rar, bf16, hd), None, False),
                    ("causal L=258, dbias on", *bnhd(4, *rar, bf16, hd), causal, True),
                    ("ragged L=37 fp32", *bnhd(3, 37, 37, 4, f32, hd), None, False),
                    ("strided qkv views", *qkv.unbind(2), build_attn_bias((1, 2, 3, 4)).to(dev),
                     True)]
        _bwd_cases_hd("#6", attn.fused_attention_bwd, attn.fused_attention_bwd_reference, bwd,
                      hd, gen)
        _autograd_hd("#3/#6", ("FUSED_LAUNCHES", "FUSED_BWD_LAUNCHES"),
                     *bnhd(HD256_BATCH, *rar, bf16, hd), causal, gen)
        qblk = [("L=2100, encoder mask", *bnhd(1, 2100, 2100, 2, bf16, hd), mask),
                ("L=2100 fp32, encoder mask", *bnhd(1, 2100, 2100, 2, f32, hd), mask)]
        if full:
            qblk.append(("ragged L=2049, no bias", *bnhd(1, 2049, 2049, 2, bf16, hd), None))
        _fwd_cases_hd("#4", attn.fused_attention_qblk, attn.fused_attention_qblk_reference,
                      qblk, hd)
        _bwd_cases_hd("#5", attn.fused_attention_qblk_bwd,
                      attn.fused_attention_qblk_bwd_reference,
                      [(name + (", dbias on" if q.dtype == f32 else ", dbias off"), q, k, v, b,
                        q.dtype == f32) for name, q, k, v, b in qblk], hd, gen)
        _autograd_hd("#4/#5", ("QBLK_LAUNCHES", "QBLK_BWD_LAUNCHES"), *qblk[0][1:4], mask, gen)
        del qblk, fwd, bwd
    # wider heads are refused before any launch
    reset_counts()
    for hd in TOO_WIDE_HDS:
        q, k, v = bnhd(2, 70, 70, 2, bf16, hd)
        for num, fn in (("#3", attn.fused_attention), ("#4", attn.fused_attention_qblk)):
            _expect_refusal(f"{num} hd {hd}", NotImplementedError, lambda: fn(q, k, v))
        for num, fn in (("#6", attn.fused_attention_bwd), ("#5", attn.fused_attention_qblk_bwd)):
            _expect_refusal(f"{num} hd {hd}", NotImplementedError,
                            lambda: fn(q, k, v, None, q, need_dbias=False))
    check_launches("[kernels] refused head dims", 1, {})


def _score_gap(x: torch.Tensor, cb: torch.Tensor, maximize: bool, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """|score(a) - score(b)| per row in fp64, the score being the kernel's
    |e|^2 - 2 x.e (or -2 x.e when maximizing)."""
    x, cb = x.double(), cb.double()
    s = -2.0 * (x @ cb.T)
    if not maximize:
        s = s + cb.square().sum(-1)
    return (s.gather(1, a[:, None]) - s.gather(1, b[:, None])).abs()[:, 0]


# codebook rows planted twice by ``kernels_codebook``: (first, copy) pairs
# across the boundaries of the code ranges the kernel splits a 4096 book into
# (512 codes a range at 8 ranges, 1024 at 4, 2048 at 2), and one far apart;
# each line names the ranges the call took (``codebook.code_ranges``)
DUPLICATE_CODES = ((511, 512), (1023, 1024), (2047, 2048), (100, 3000))


def kernels_codebook(dev) -> float:
    """#9 against its plain version: indices equal except at near-ties,
    where the fp64 score gap must be <= NEAR_TIE, at every scale of both
    encodes, V off the tile, each C, N below one row tile; then codebooks
    holding ``DUPLICATE_CODES`` at pn = 2, 11 and 13, whose planted rows
    must take the first copy, as the plain version does; those calls must
    split the book in at least two ways, one of them into several ranges.
    Returns the largest gap at the main path's shapes (0 when every index
    agrees)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = [(f"scale pn={pn}", BATCH * pn * pn, 4096, 32, maximize, True, None)
             for pn in sorted(set(PNS) | set(PNS512)) for maximize in (True, False)]
    cases += [("V off the tile", 1000, 4000, 32, True, False, None),
              ("C=8", 777, 4096, 8, False, False, None),
              ("C=16", 777, 1024, 16, True, False, None),
              ("C=64", 777, 4096, 64, True, False, None),
              ("N below a row tile", 5, 4096, 32, True, False, None),
              ("x off 16 bytes", 300, 4096, 32, False, False, "unaligned")]
    cases += [(f"duplicates pn={pn}", BATCH * pn * pn, 4096, 32, maximize, False, "dup")
              for pn in (2, 11, 13) for maximize in (True, False)]
    main_gap, dup_splits = 0.0, set()
    for name, n, v, c, maximize, main, kind in cases:
        x = torch.randn((n, c), generator=gen, device=dev)
        cb = torch.randn((v, c), generator=gen, device=dev)
        if kind == "unaligned":  # the wrapper copies it to a 16-byte boundary
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(n, c)
        dup = kind == "dup"
        if dup:  # row i sits on the planted pair i (plus a little noise)
            for i, (a, b) in enumerate(DUPLICATE_CODES):
                cb[b] = cb[a]
                x[i] = cb[a] + 1e-3 * x[i]
        if maximize:  # the quantizer passes L2-normalised rows
            x, cb = _l2n(x), _l2n(cb)
        got = codebook.codebook_argmin(x, cb, maximize)
        want = codebook.codebook_argmin_reference(x, cb, maximize)
        torch.cuda.synchronize()
        diff = (got != want).nonzero()[:, 0]
        gap = _score_gap(x[diff], cb, maximize, got[diff], want[diff]).max().item() \
            if diff.numel() else 0.0
        print(f"[kernels] #9 {name:18s} x ({n}, {c}) codebook ({v}, {c}) "
              f"maximize={maximize!s:5s} {codebook.code_ranges(n, v, c, maximize)} code "
              f"ranges, {n - diff.numel()}/{n} equal, max fp64 score gap {gap:.3e} "
              f"(near-tie <= {NEAR_TIE:g})")
        if not (0 <= int(got.min()) and int(got.max()) < v):
            raise AssertionError(f"[kernels] #9 {name}: index out of range")
        _check(f"[kernels] #9 {name} score gap", gap, NEAR_TIE)
        if dup:
            dup_splits.add(codebook.code_ranges(n, v, c, maximize))
            first = torch.tensor([a for a, _ in DUPLICATE_CODES], device=dev)
            planted = got[:len(DUPLICATE_CODES)]
            if not (torch.equal(planted, first) and torch.equal(want[:len(first)], first)):
                raise AssertionError(f"[kernels] #9 {name}: planted rows took "
                                     f"{planted.tolist()}, plain {want[:len(first)].tolist()}, "
                                     f"want the first copies {first.tolist()}")
        if main:
            main_gap = max(main_gap, gap)
    if len(dup_splits) < 2 or max(dup_splits) < 2:
        raise AssertionError(f"[kernels] #9 the duplicate cases split the book into "
                             f"{sorted(dup_splits)} ranges: they cover too few splits")
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
    summed in 64-wide k-tiles, #1's tiled attention), which must pass, and
    against the model with a fault planted (the last k/v tile or GEMM
    k-tile dropped, a bias omitted, LayerScale skipped, the last partial
    row tile unstored), which must fail; tests/test_torch_gemm_sm90.py
    holds it against a model of the GEMM's tiles and schedule, and
    tests/test_torch_block_fused.py the same bound against the Pallas
    kernels on the CPU."""
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
    ragged, with res = 0, and in fp32; #8 with fc2 (K = 3072, N = 768) at a
    ragged M of 2331 rows, and #10 at 1000 rows, where both GEMMs have
    fewer tiles than the card has SMs (96 and 24); then autograd through
    each fused sublayer on the card (one forward launch; gradients against
    the composed path's) and the wrappers' refusals. Returns the largest
    bf16 max abs error of each at the main paths' shapes."""
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
        ("fc2 at a ragged M", (7, 333, 768), 3072, bf16, f32, False),
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
                                 ("ragged", 77, bf16, False),
                                 ("tiles below the SM count", 1000, bf16, False),
                                 ("fp32", 300, f32, False),
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


# depth cuts of card-vs-CPU checks whose CPU side set the script's time:
# RAR-B's 256-step CFG sampling, the RARTrainer steps and MaskGIT-B's
# checks (both trunks, the trainer step) at 8 of their 24 blocks, and the 512
# px VAR checks with VAR-d16 cut to 4 blocks (the timed paths keep 24 and 16)
CHECK_RAR_DEPTH = 8
CHECK_VAR_DEPTH_512 = 4
# and the tokenizers' ViTs (DINOv2 ViT-S and ViT-B, CLIP
# ViT-B/16) at 4 of their 12 blocks and DinoDisc's trunk at 6 of 12 (heads
# at blocks 2 and 5 stay) in the fp32 RobustTok, disc-type, MSBR, variant
# and 512 px tokenizer checks (the bf16 paths and the CLI phase run all 12)
CHECK_TOK_DEPTH = 4
CHECK_DINO_DEPTH = 6
CUT_PRESETS = ("vit_small_patch14_dinov2.lvd142m", "vit_base_patch14_dinov2.lvd142m",
               "vit_base_patch16_clip_224.openai")


@contextlib.contextmanager
def check_depth_cut():
    """While in use, the tokenizers' ViT presets at ``CHECK_TOK_DEPTH``
    blocks and the loaded YAMLs' DinoDisc at ``CHECK_DINO_DEPTH``: a depth
    cut for time of fp32 card-vs-CPU checks, whose CPU side set the
    script's time; the widths stay."""
    global load_tokenizer_config
    saved, load = {n: vit_mod.VIT_PRESETS[n] for n in CUT_PRESETS}, load_tokenizer_config

    def load_cut(*a, **k):
        mcfg, tcfg, run = load(*a, **k)
        return mcfg, dataclasses.replace(tcfg, dino_depth=CHECK_DINO_DEPTH), run

    for n in CUT_PRESETS:
        vit_mod.VIT_PRESETS[n] = {**saved[n], "depth": CHECK_TOK_DEPTH}
    load_tokenizer_config = load_cut
    try:
        yield
    finally:
        vit_mod.VIT_PRESETS.update(saved)
        load_tokenizer_config = load


def phase_model_rar(dev, vq_cpu: VQModel, vq_card: VQModel):
    """RAR-B at full width (768 wide, 16 heads, 256 tokens, 4096 codes; 8 of
    its 24 blocks, ``CHECK_RAR_DEPTH``) in fp32, B=2 with CFG at ``configs/generator/robustTok-rar.yaml``'s
    settings, card against the same weights on the CPU, with the Gumbel noise
    drawn once on the CPU and handed to both: every pick equal except at a
    near-tie (the card then goes on from the CPU's pick), the CFG logits of
    the first and the last step; then the tokens decoded by the RobustTok
    tokenizer of ``phase_model_vq``, fused sublayers on the card against
    the composed path on the CPU."""
    gen = torch.Generator().manual_seed(SEED + 10)
    rar_cpu = build_rar(vq_cpu.config, depth=CHECK_RAR_DEPTH, generator=gen,
                        device="cpu").eval()
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


# RAR's k_norm bias adds q.b to every score of a query row, which the softmax
# cancels: its gradient is 0 in exact arithmetic
RAR_ZERO_GRAD = r"blocks\.\d+\.attn\.k_norm\.bias"


def _rar_batch(cfg, batch: int, gen: torch.Generator):
    """Training inputs for RAR from ``gen`` on the CPU: tokens, condition-
    token ids and per-sample orders (a raster order first, the rest random
    permutations, as RAR's training draws them)."""
    ids = torch.randint(0, cfg.codebook_size, (batch, cfg.image_seq_len), generator=gen)
    cond = torch.randint(0, cfg.condition_num_classes, (batch,), generator=gen) + \
        cfg.codebook_size + 1
    orders = torch.argsort(torch.rand((batch, cfg.image_seq_len), generator=gen), dim=1)
    orders[0] = torch.arange(cfg.image_seq_len)
    return ids, cond, orders


def phase_model_rar_train(dev):
    """RAR-B at full width (768 wide, 24 deep, 16 heads of 48, 256 tokens,
    4096 codes) in fp32, B=2: the teacher-forcing forward over per-sample
    orders under the causal mask, ``ar_loss`` and its backward, card against
    the same weights on the CPU: logits, loss and every parameter's
    gradient (max abs error over the CPU's max abs) within MODEL_TOL, the
    k_norm biases (0 in exact arithmetic) to ZERO_GRAD_TOL of their weights'
    gradients. On the card one #3 and one #6 launch per block (fp32: the
    FMA forward, the two-kernel backward)."""
    gen = torch.Generator().manual_seed(SEED + 12)
    rar_cpu = build_rar(bench_margs("float32"), generator=gen, device="cpu")
    _excite_adaln(rar_cpu, gen)
    rar_card = copy.deepcopy(rar_cpu).to(dev)
    cfg = rar_cpu.config
    batch = _rar_batch(cfg, 2, gen)

    def run(model, device):
        logits, labels = model(*(t.to(device) for t in batch))
        loss, _ = rar_mod.ar_loss(logits, labels)
        loss.backward()
        return logits.detach(), loss.detach()

    reset_counts()
    logits_card, loss_card = run(rar_card, dev)
    torch.cuda.synchronize()
    check_launches("[model] RAR-B training fp32", 1, {"fused_attention_fwd": cfg.depth,
                                                      "fused_attention_bwd": cfg.depth})
    logits_cpu, loss_cpu = run(rar_cpu, "cpu")
    grad_errs, zero = _grad_errs("RAR-B training", rar_cpu.named_parameters(),
                                 rar_card.parameters(), list(rar_cpu.parameters()),
                                 RAR_ZERO_GRAD)
    worst = max(grad_errs, key=grad_errs.get)
    errs = {"logits": _max_err(logits_card, logits_cpu) / logits_cpu.abs().max().item(),
            "loss": abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item()),
            f"gradient of {worst}": grad_errs[worst]}
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] RAR-B training fp32 B=2 (forward, ar_loss, backward) card vs CPU "
          f"(relative): {shown} (tol {MODEL_TOL:g}; {len(grad_errs)} parameter gradients, "
          f"median error {statistics.median(grad_errs.values()):.3e}; {len(zero)} k_norm "
          f"biases at most {max(zero.values()):.3e} of their weights' gradients, tol "
          f"{ZERO_GRAD_TOL:g}); loss {loss_cpu.item():.6f}; #3 and #6 {cfg.depth} launches each")
    for k, v in errs.items():
        _check(f"[model] RAR-B training {k}", v, MODEL_TOL)


# maskgit_generate's defaults, as scripts/train_rar.py's MaskGIT preview
# samples: 8 steps, constant guidance 3.0, randomize_temperature 4.5
MASKGIT_SAMPLING = dict(guidance_scale=3.0, guidance_decay="constant",
                        randomize_temperature=4.5, num_sample_steps=8)
MASKGIT_STEPS = MASKGIT_SAMPLING["num_sample_steps"]


def _maskgit_blocks(cfg) -> int:
    """Blocks a MaskGIT forward runs, one #3 launch each: depth, or for
    U-ViT depth / 2 in, one mid and depth / 2 out."""
    return cfg.depth + (cfg.arch == "uvit")


def _draw_gap(args, want, got, diff):
    """draw_tokens(logits, gumbel, T): the gap between the two picks'
    scores logits + T g, in fp64."""
    score = (args[0].double() + args[2] * args[1].double())[diff]
    return (score.gather(-1, want[:, None]) - score.gather(-1, got[:, None])).abs()[:, 0]


def _remask_gap(args, want, got, diff):
    """remask(confidence, mask_len): how far a position that flips lies
    from its row's cut, in fp64."""
    conf, mask_len = args[0].double(), args[1]
    cut = torch.sort(conf, dim=-1).values[:, mask_len - 1:mask_len]
    return (conf - cut).abs()[diff]


def phase_model_maskgit(dev):
    """MaskGIT-B at full width (768 wide, 16 heads of 48, 256 tokens, 4096
    codes; 8 of its 24 blocks, ``CHECK_RAR_DEPTH``) with each trunk,
    ``bert`` and ``uvit`` (9 blocks),
    in fp32 at B=2, card against the same weights on the CPU: the logits of
    a partly masked input, conditioned and with every condition dropped;
    then ``maskgit_generate``'s tokens at its defaults with the same Gumbel
    draws on both sides, every draw and re-mask equal except at a near-tie
    (the card then goes on from the CPU's choice). One #3 launch per block
    and forward, two forwards (CFG) per step."""
    margs = bench_margs("float32")
    for i, arch in enumerate(("bert", "uvit")):
        gen = torch.Generator().manual_seed(SEED + 20 + i)
        cpu = build_maskgit(margs, arch=arch, depth=CHECK_RAR_DEPTH, generator=gen,
                            device="cpu").eval()
        card = copy.deepcopy(cpu).to(dev)
        cfg, blocks = cpu.config, _maskgit_blocks(cpu.config)
        l, v = cfg.image_seq_len, cfg.codebook_size
        labels = torch.tensor([207, 980])
        ids = torch.randint(0, v, (2, l), generator=gen)
        ids[:, ::3] = cfg.mask_token_id
        errs = {}
        with torch.no_grad():
            for name, p in (("logits", 0.0), ("logits, condition dropped", 1.0)):
                want = cpu(ids, labels, cond_drop_prob=p)
                reset_counts()
                got = card(ids.to(dev), labels.to(dev), cond_drop_prob=p)
                torch.cuda.synchronize()
                check_launches(f"[model] MaskGIT-B {arch} forward", 1,
                               {"fused_attention_fwd": blocks})
                errs[name] = _max_err(got, want) / want.abs().max().item()
        noise = [(maskgit_mod._gumbel((2, l, v), gen, "cpu"),
                  maskgit_mod._gumbel((2, l), gen, "cpu")) for _ in range(MASKGIT_STEPS)]
        draws = Lockstep(maskgit_mod, "draw_tokens", _draw_gap, LOGIT_NEAR_TIE)
        again = Lockstep(maskgit_mod, "remask", _remask_gap, LOGIT_NEAR_TIE)
        tok_cpu = draws.on_cpu(lambda: again.on_cpu(lambda: maskgit_mod.maskgit_generate(
            cpu, labels, noise=noise, **MASKGIT_SAMPLING)))
        reset_counts()
        tok_card = draws.on_card(lambda: again.on_card(lambda: maskgit_mod.maskgit_generate(
            card, labels.to(dev), noise=[(a.to(dev), b.to(dev)) for a, b in noise],
            **MASKGIT_SAMPLING)))
        torch.cuda.synchronize()
        check_launches(f"[model] MaskGIT-B {arch} maskgit_generate", 1,
                       {"fused_attention_fwd": 2 * MASKGIT_STEPS * blocks})
        if not torch.equal(tok_card.cpu(), tok_cpu):
            raise AssertionError(f"[model] MaskGIT-B {arch}: the card's tokens are not the "
                                 "CPU's")
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[model] MaskGIT-B {arch} ({blocks} blocks) fp32 B=2 card vs CPU: {shown} "
              f"(tol {MODEL_TOL:g}, relative to their max abs); maskgit_generate "
              f"({MASKGIT_STEPS} steps, CFG {MASKGIT_SAMPLING['guidance_scale']:g}): tokens "
              f"{draws.compared - draws.flips}/{draws.compared} drawn alike, re-masks "
              f"{again.compared - again.flips}/{again.compared} alike, max near-tie gap "
              f"{max(draws.max_gap, again.max_gap):.3e} (<= {LOGIT_NEAR_TIE:g}); "
              f"{torch.unique(tok_cpu).numel()} distinct tokens; #3 "
              f"{2 * MASKGIT_STEPS * blocks} launches")
        for k, e in errs.items():
            _check(f"[model] MaskGIT-B {arch} {k}", e, MODEL_TOL)


def phase_model_maskgit_train(dev):
    """One ``MaskGITTrainer`` step of MaskGIT-B (bert; 8 of 24 blocks) in fp32 at B=2, card
    against CPU from the same weights with the same masking draws (t,
    scores) and condition drop, at ``total_steps`` 10 (no warmup: the step
    runs at the peak lr, 2e-4): loss, every parameter's gradient (max abs
    error over the CPU's max abs; the key third of each qkv bias, 0 in
    exact arithmetic, to ZERO_GRAD_TOL of the qkv weight's gradient on both
    sides) and the updated parameters. One #3 and one #6 launch per block
    (fp32: the FMA forward, the two-kernel backward)."""
    gen = torch.Generator().manual_seed(SEED + 22)
    cpu = build_maskgit(bench_margs("float32"), depth=CHECK_RAR_DEPTH, generator=gen,
                        device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    cfg = cpu.config
    l = cfg.image_seq_len
    tokens = torch.randint(0, cfg.codebook_size, (2, l), generator=gen)
    labels = torch.tensor([207, 980])
    draws = dict(t=torch.rand(2, generator=gen), scores=torch.rand((2, l), generator=gen),
                 drop=torch.tensor([False, True]))
    tr_cpu, tr_card = MaskGITTrainer(cpu, 10), MaskGITTrainer(card, 10)
    reset_counts()
    m_card = tr_card.train_step(tokens.to(dev), labels.to(dev),
                                **{k: x.to(dev) for k, x in draws.items()})
    torch.cuda.synchronize()
    check_launches("[model] MaskGIT-B train step fp32", 1,
                   {"fused_attention_fwd": cfg.depth, "fused_attention_bwd": cfg.depth})
    m_cpu = tr_cpu.train_step(tokens, labels, **draws)
    grad_errs, zero = {}, {}
    for (name, p_cpu), p_card in zip(cpu.named_parameters(), card.parameters()):
        g_cpu, g_card = p_cpu.grad, p_card.grad.cpu()
        if name.endswith("attn.qkv.bias"):  # the key third shifts a row's scores
            d = g_cpu.shape[0] // 3
            ref = dict(cpu.named_parameters())[name[:-4] + "weight"].grad.abs().max().item()
            zero[name] = max(g_cpu[d:2 * d].abs().max().item(),
                             g_card[d:2 * d].abs().max().item()) / ref
            _check(f"[model] MaskGIT-B train step {name} key third", zero[name], ZERO_GRAD_TOL)
            keep = torch.ones(3 * d, dtype=torch.bool)
            keep[d:2 * d] = False
            g_cpu, g_card = g_cpu[keep], g_card[keep]
        grad_errs[name] = _max_err(g_card, g_cpu) / max(g_cpu.abs().max().item(), 1e-30)
    worst = max(grad_errs, key=grad_errs.get)
    step_err = max(_max_err(a, b) for a, b in zip(cpu.parameters(), card.parameters()))
    errs = {"loss": abs(m_card["loss"].item() - m_cpu["loss"].item()) / m_cpu["loss"].item(),
            "grad_norm": abs(m_card["grad_norm"].item() - m_cpu["grad_norm"].item())
            / m_cpu["grad_norm"].item(),
            f"gradient of {worst}": grad_errs[worst]}
    shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
    print(f"[model] MaskGIT-B MaskGITTrainer step fp32 B=2 card vs CPU (relative): {shown} "
          f"(tol {MODEL_TOL:g}; {len(grad_errs)} parameter gradients, median error "
          f"{statistics.median(grad_errs.values()):.3e}; {len(zero)} qkv biases' key thirds "
          f"at most {max(zero.values()):.3e} of their weights' gradients, tol "
          f"{ZERO_GRAD_TOL:g}); loss {m_cpu['loss'].item():.6f}; updated parameters max abs "
          f"diff {step_err:.3e}; #3 and #6 {cfg.depth} launches each")
    for k, e in errs.items():
        _check(f"[model] MaskGIT-B train step {k}", e, MODEL_TOL)
    _check("[model] MaskGIT-B train step updated parameters", step_err, MODEL_TOL)


def phase_model_rar_trainer(dev):
    """Two ``RARTrainer`` steps of RAR-B (8 of 24 blocks) in fp32 at B=2, card against CPU
    from the same weights (AdaLN drawn at random) with the same condition
    drops and orders (one raster, one random), at a warmup of 1 step (the
    first at lr 0, the second at the peak, 4e-4) with AdamW, the clip at 1
    and the EMA: loss, ``correct_tokens`` (within one token's share),
    ``grad_norm`` and every parameter's clipped gradient (k_norm's biases
    to ZERO_GRAD_TOL) after each step, then the parameters and the EMA. One
    #3 and one #6 launch per block and step."""
    gen = torch.Generator().manual_seed(SEED + 23)
    cpu = build_rar(bench_margs("float32"), depth=CHECK_RAR_DEPTH, generator=gen, device="cpu")
    _excite_adaln(cpu, gen)
    card = copy.deepcopy(cpu).to(dev)
    cfg = cpu.config
    tcfg = RARTrainConfig(warmup_steps=1, total_steps=10)
    tr_cpu, tr_card = RARTrainer(cpu, tcfg), RARTrainer(card, tcfg)
    share = 1.0 / (2 * cfg.image_seq_len)
    for step in range(2):
        tokens = torch.randint(0, cfg.codebook_size, (2, cfg.image_seq_len), generator=gen)
        labels = torch.randint(0, cfg.condition_num_classes, (2,), generator=gen)
        drop = torch.tensor([step == 1, False])
        orders = cpu.sample_orders(2, 0.5, gen, uniforms=torch.tensor([0.5, 0.0]))
        reset_counts()
        m_card = tr_card.train_step(tokens.to(dev), labels.to(dev), 0.5, drop=drop.to(dev),
                                    orders=orders.to(dev))
        torch.cuda.synchronize()
        check_launches(f"[model] RARTrainer step {step + 1} fp32", 1,
                       {"fused_attention_fwd": cfg.depth, "fused_attention_bwd": cfg.depth})
        m_cpu = tr_cpu.train_step(tokens, labels, 0.5, drop=drop, orders=orders)
        grad_errs, zero = _grad_errs("RARTrainer", cpu.named_parameters(), card.parameters(),
                                     list(cpu.parameters()), RAR_ZERO_GRAD)
        worst = max(grad_errs, key=grad_errs.get)
        errs = {k: abs(m_card[k].item() - m_cpu[k].item()) / m_cpu[k].item()
                for k in ("loss", "grad_norm")}
        errs[f"gradient of {worst}"] = grad_errs[worst]
        acc_diff = abs(m_card["correct_tokens"].item() - m_cpu["correct_tokens"].item())
        shown = ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        print(f"[model] RAR-B RARTrainer step {step + 1} fp32 B=2 card vs CPU (relative): "
              f"{shown} (tol {MODEL_TOL:g}; {len(grad_errs)} parameter gradients, median "
              f"{statistics.median(grad_errs.values()):.3e}; {len(zero)} k_norm biases at most "
              f"{max(zero.values()):.3e} of their weights', tol {ZERO_GRAD_TOL:g}); loss "
              f"{m_cpu['loss'].item():.6f}, correct_tokens {m_cpu['correct_tokens'].item():.6f} "
              f"(card {acc_diff:.2e} off, <= {share:.2e}), grad norm "
              f"{m_cpu['grad_norm'].item():.6f}, lr {tr_cpu.opt.lr_schedule(step):g}")
        for k, e in errs.items():
            _check(f"[model] RARTrainer step {step + 1} {k}", e, MODEL_TOL)
        _check(f"[model] RARTrainer step {step + 1} correct_tokens", acc_diff, share)
    step_err = max(_max_err(a, b) for a, b in zip(cpu.parameters(), card.parameters()))
    ema_err = max(_max_err(a, b) for a, b in zip(tr_cpu.ema, tr_card.ema))
    print(f"[model] RAR-B RARTrainer after two steps: parameters max abs diff {step_err:.3e}, "
          f"EMA {ema_err:.3e} (tol {MODEL_TOL:g})")
    _check("[model] RARTrainer updated parameters", step_err, MODEL_TOL)
    _check("[model] RARTrainer EMA", ema_err, MODEL_TOL)


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


def _code_lockstep():
    """The multi-scale VQ's codes (``_codebook_lookup``) in lockstep."""
    return Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)


def phase_model_var(dev, margs: ModelArgs, name: str, lockstep=_code_lockstep,
                    var_depth: int = VAR_DEPTH):
    """A multi-scale tokenizer with VAR (d16, or ``var_depth`` blocks) in fp32 at B=2,
    card against the same weights on the CPU: the encoder's latents,
    ``img_to_idxBl``'s codes per scale, the round trip image, the VAR input,
    ``VAR.forward`` logits and greedy ``var_sample`` tokens and images. The
    codes go in ``lockstep()`` (VQ's lookups, or LFQ's sign bits)."""
    gen = torch.Generator().manual_seed(SEED)
    vae_cpu, var_cpu = build_vae_var(margs, var_depth, generator=gen, device="cpu")
    _excite_layerscale(vae_cpu, gen)
    vae_cpu.eval()
    var_cpu.eval()
    vae_card, var_card = copy.deepcopy(vae_cpu).to(dev), copy.deepcopy(var_cpu).to(dev)
    x = torch.rand((2, margs.image_size, margs.image_size, 3), generator=gen) * 2 - 1
    label = torch.tensor([207, 980])
    codes = lockstep()
    picks = Lockstep(var_train, "sample_with_top_k_top_p", _logit_gap, LOGIT_NEAR_TIE)
    errs = {}
    with torch.inference_mode():
        errs["latents"] = _max_err(vae_cpu.encode(x), vae_card.encode(x.to(dev)))
        idx_cpu = codes.on_cpu(lambda: vae_cpu.img_to_idxBl(x))
        idx_card = codes.on_card(lambda: vae_card.img_to_idxBl(x.to(dev)))
        rec = lockstep()
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


def phase_model_train(dev, cpu_models, card_models, name: str, lockstep=_code_lockstep):
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
    codes = lockstep()
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


def _grad_errs(what: str, named_cpu, params_card, trainable: list,
               zero_grad: str = ZERO_GRAD, by_weight: str = r"^$") -> tuple:
    """Each trainable parameter's gradient, card against CPU: the max abs
    error over the CPU gradient's max abs. Every trainable parameter must
    have a gradient (AdamW would skip one that has none, optax decays it). A
    gradient that is zero in exact arithmetic (names matching ``zero_grad``,
    each a bias) is held, on both sides, to ``ZERO_GRAD_TOL`` of its
    weight's gradient instead; one whose terms cancel to a small share
    (names matching ``by_weight``, each a bias) is divided by its weight's
    gradient's max abs where that is larger."""
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
        if re.fullmatch(zero_grad, name):
            ref = weight_max[name[:-len("bias")] + "weight"]
            zero[name] = max(p_cpu.grad.abs().max().item(),
                             p_card.grad.abs().max().item()) / ref
            _check(f"[model] {what} {name} (zero in exact arithmetic)", zero[name],
                   ZERO_GRAD_TOL)
            continue
        scale = p_cpu.grad.abs().max().item()
        if re.fullmatch(by_weight, name):
            scale = max(scale, weight_max[name[:-len("bias")] + "weight"])
        errs[name] = _max_err(p_card.grad, p_cpu.grad) / max(scale, 1e-30)
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


ROBUSTTOK_YAML = ROOT / "configs" / "RobustTok.yaml"


def _dist_gap(args, want, got, diff):
    """``quantize._nearest_code(flat, emb)`` or ``perturb._nearest_codes(flat,
    emb, k)``: the fp64 distance gap between the CPU's and the card's code."""
    flat, emb = args[0].double(), args[1].double()
    x = flat[diff.nonzero()[:, 0]]
    return (((x - emb[want]) ** 2).sum(-1) - ((x - emb[got]) ** 2).sum(-1)).abs()


def robusttok_draws(batch: int, px: int, tokens: int, gen: torch.Generator) -> dict:
    """Every random draw of one RobustTok ``TokenizerTrainer.train_step``,
    made on the CPU: the perturbation's two uniforms, the three DiffAug
    calls and the disc's crop-or-resize (a single scale draws no dropout)."""
    cpu = torch.device("cpu")
    return {"perturb": perturb.draw_perturbation(batch * tokens, gen, cpu),
            **{k: draw_aug(batch, gen, cpu) for k in ("aug_g", "aug_f", "aug_r")},
            "crop": draw_crop(px, gen, cpu)}


class PerturbRecorder:
    """Wraps the tokenizer's ``add_perturbation`` and keeps, per call, how
    many tokens of each sample it moved to another code: the rows that
    differ from the quantizer's output (a token that keeps its nearest code
    gets a bit-equal row, as both compute z + sg(e - z) the same way)."""

    def __enter__(self):
        self.orig, self.moved = tokenizer_mod.add_perturbation, []

        def record(z, z_q, *args, **kwargs):
            out = self.orig(z, z_q, *args, **kwargs)
            self.moved.append((out.detach() != z_q.detach()).any(-1).flatten(1).sum(1).cpu())
            return out

        tokenizer_mod.add_perturbation = record
        return self

    def __exit__(self, *exc):
        tokenizer_mod.add_perturbation = self.orig


def _trainer_pair(mcfg, tcfg, dev, gen):
    """A trainer on the CPU with LayerScale raised (and LoRA B factors drawn,
    where there are any), and one on the card with the same weights."""
    tr_cpu = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED),
                              device="cpu")
    _excite_layerscale(tr_cpu.model, gen)
    _excite_lora(tr_cpu.model, gen)
    tr_cpu.sync_ema()
    tr_card = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED),
                               device=dev)
    for name in ("model", "lpips", "disc"):
        getattr(tr_card, name).load_state_dict(getattr(tr_cpu, name).state_dict())
    tr_card.sync_ema()
    return tr_cpu, tr_card


def _lockstep_step(tr_cpu, tr_card, x, dev, draws, kw, lookups):
    """One ``train_step`` on the CPU and then on the card with the same
    draws, each ``Lockstep`` in ``lookups`` and the piecewise-linear ops
    (``KinkLockstep``) in lockstep; returns both metrics and the kink
    lockstep."""
    kinks = KinkLockstep(KINK_NEAR_TIE)

    def cpu():
        return tr_cpu.train_step(x, draws=draws, **kw)

    def card():
        return tr_card.train_step(x.to(dev), draws=_to(draws, dev), **kw)

    for ls in lookups:
        cpu, card = (lambda f=cpu, ls=ls: ls.on_cpu(f)), (lambda f=card, ls=ls: ls.on_card(f))
    with kinks.record():
        m_cpu = cpu()
    with kinks.replay():
        m_card = card()
    if kinks.calls != len(kinks.branches):
        raise AssertionError(f"[model] the card made {kinks.calls} piecewise-linear calls, "
                             f"the CPU {len(kinks.branches)}")
    torch.cuda.synchronize()
    if sorted(m_cpu) != sorted(m_card):
        raise AssertionError(f"[model] train step metrics {sorted(m_card)}")
    return m_cpu, m_card, kinks


def _check_step_metrics(what: str, m_cpu: dict, m_card: dict) -> str:
    for k, want in m_cpu.items():
        _check(f"[model] {what} {k}", _max_err(m_card[k], want) / max(want.abs().max().item(), 1.0),
               MODEL_TOL)
    worst = max(m_cpu, key=lambda k: _max_err(m_card[k], m_cpu[k]))
    return f"worst metric {worst} abs err {_max_err(m_card[worst], m_cpu[worst]):.3e}"


def _state_err(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max(_max_err(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))


def phase_model_robusttok(dev):
    """``configs/RobustTok.yaml`` at full width through the port's loader, in
    fp32 (``mixed_precision=none``) at B=2 with TF32 off, card against CPU
    from the same weights, every draw made once on the CPU and given to both
    sides (the perturbation's uniforms included). Two steps with alpha 1,
    beta 0.5 (so that one of the two samples is perturbed: floor(2 beta))
    and delta_ratio 0.75, held as ``phase_model_gan`` holds the flagship's:
    every metric (``detail_loss`` included), every trainable gradient after
    the first step, the parameters after the second; ``SingleVQ``'s codes
    and the perturbation's nearest-code lists in lockstep (equal but at
    counted near ties, and the card goes on from the CPU's). Then two
    micro-steps with ``grad_accum_steps=2`` and ``lr_scheduler: none``:
    after the first the card's parameters are bit-unchanged, after the
    second they equal the CPU's. Returns the card trainer of the first
    pair."""
    mcfg, tcfg, _ = load_tokenizer_config(str(ROBUSTTOK_YAML), {"mixed_precision": "none"})
    gen = torch.Generator().manual_seed(SEED + 21)
    tr_cpu, tr_card = _trainer_pair(mcfg, tcfg, dev, gen)
    px, nl = mcfg.image_size, mcfg.num_latent_tokens
    x = torch.rand((2, px, px, 3), generator=gen) * 2 - 1
    kw = dict(alpha=1.0, beta=0.5, delta_ratio=0.75)
    shown, codes_eq, codes_n, tops_eq, tops_n, flips, gap = [], 0, 0, 0, 0, 0, 0.0
    for step in range(2):
        draws = robusttok_draws(2, px, nl, gen)
        if draws["crop"] is not None:  # above 224 px: the crop, then the area resize
            draws["crop"] = (torch.tensor(step == 0), *draws["crop"][1:])
        codes = Lockstep(quantize, "_nearest_code", _dist_gap, NEAR_TIE)
        tops = Lockstep(perturb, "_nearest_codes", _dist_gap, NEAR_TIE)
        with PerturbRecorder() as rec:
            m_cpu, m_card, kinks = _lockstep_step(tr_cpu, tr_card, x, dev, draws, kw,
                                                  (codes, tops))
        moved = rec.moved[0]  # the CPU's call, then the card's from the CPU's lists
        if not (moved[0] > 0 and moved[1] == 0 and torch.equal(rec.moved[1], moved)):
            raise AssertionError(f"[model] RobustTok perturbation moved {moved.tolist()} tokens "
                                 f"per sample on the CPU, {rec.moved[1].tolist()} on the card; "
                                 "want the same, some in sample 0 and none in sample 1")
        codes_eq, codes_n = codes_eq + codes.compared - codes.flips, codes_n + codes.compared
        tops_eq, tops_n = tops_eq + tops.compared - tops.flips, tops_n + tops.compared
        flips, gap = flips + kinks.flips, max(gap, kinks.max_gap, codes.max_gap, tops.max_gap)
        shown.append(f"step {step}: " + ", ".join(
            f"{k} {m_cpu[k].item():.6f}" for k in ("gen_loss", "detail_loss", "sem_loss",
                                                   "disc_loss", "grad_norm"))
            + f", {int(moved[0])} of {nl} tokens of sample 0 perturbed, "
            + _check_step_metrics(f"RobustTok step {step}", m_cpu, m_card))
        if step == 0:
            g_errs, _ = _grad_errs("generator", tr_cpu.model.named_parameters(),
                                   tr_card.model.parameters(), tr_cpu.gen_opt.params)
            d_errs, _ = _grad_errs("disc", tr_cpu.disc.named_parameters(),
                                   tr_card.disc.parameters(), tr_cpu.disc_opt.params)
    step_err = max(_state_err(tr_cpu.model, tr_card.model), _state_err(tr_cpu.disc, tr_card.disc))
    print("[model] RobustTok.yaml fp32 B=2 card vs CPU (alpha 1, beta 0.5, delta_ratio 0.75): "
          + "; ".join(shown) + f" (tol {MODEL_TOL:g} of max(|value|, 1))")
    for what, errs in (("generator", g_errs), ("disc heads", d_errs)):
        worst = max(errs, key=errs.get)
        print(f"[model] RobustTok step {what}: {len(errs)} parameter gradients within "
              f"{errs[worst]:.3e} of their max abs (worst {worst}, median "
              f"{statistics.median(errs.values()):.3e}; tol {MODEL_TOL:g})")
        _check(f"[model] RobustTok step {what} gradient of {worst}", errs[worst], MODEL_TOL)
    print(f"[model] RobustTok after two steps: parameters and spectral state max abs diff "
          f"{step_err:.3e} (tol {MODEL_TOL:g}); SingleVQ codes {codes_eq}/{codes_n} equal, "
          f"perturbation nearest-code lists {tops_eq}/{tops_n} equal; {flips} relu, leaky-relu "
          f"or max-pool elements took the CPU's branch; max near-tie gap {gap:.3e}")
    _check("[model] RobustTok updated parameters", step_err, MODEL_TOL)

    acc_cfg = dataclasses.replace(tcfg, grad_accum_steps=2, lr_scheduler="none")
    a_cpu, a_card = _trainer_pair(mcfg, acc_cfg, dev, gen)
    before = [p.detach().clone() for p in a_card.model.parameters()]
    for step in range(2):
        draws = robusttok_draws(2, px, nl, gen)
        codes = Lockstep(quantize, "_nearest_code", _dist_gap, NEAR_TIE)
        tops = Lockstep(perturb, "_nearest_codes", _dist_gap, NEAR_TIE)
        m_cpu, m_card, _ = _lockstep_step(a_cpu, a_card, x if step == 0 else x.flip(1), dev,
                                          draws, kw, (codes, tops))
        _check_step_metrics(f"RobustTok micro-step {step}", m_cpu, m_card)
        if step == 0 and not all(torch.equal(a, p) for a, p in zip(before,
                                                                   a_card.model.parameters())):
            raise AssertionError("[model] grad_accum_steps=2: the first micro-step moved a "
                                 "parameter")
    moved = sum(not torch.equal(a, p) for a, p in zip(before, a_card.model.parameters()))
    acc_err = max(_state_err(a_cpu.model, a_card.model), _state_err(a_cpu.disc, a_card.disc))
    if a_card.gen_opt.count != 1 or a_card.disc_opt.count != 1 or not moved:
        raise AssertionError(f"[model] grad_accum_steps=2: {a_card.gen_opt.count} generator "
                             f"updates, {moved} parameter tensors moved after two micro-steps")
    print(f"[model] RobustTok grad_accum_steps=2, lr_scheduler none: after micro-step 1 every "
          f"card parameter bit-unchanged; after micro-step 2 one update each, {moved} "
          f"parameter tensors moved, card vs CPU max abs diff {acc_err:.3e} (tol {MODEL_TOL:g})")
    _check("[model] RobustTok accumulated update", acc_err, MODEL_TOL)
    return tr_card


def phase_model_disc_types(dev, dino_trainer: TokenizerTrainer):
    """One ``TokenizerTrainer`` step (a generator and a disc update) with
    ``disc_type`` patchgan and stylegan, card against CPU in fp32 at B=2 and
    256 px, the tokenizer at the smallest ViT preset the port has (ViT-S,
    12 blocks), the same draws on both sides and the codes and the
    piecewise-linear branches in lockstep: every metric, every trainable
    gradient of the generator and of the discriminator, and the
    discriminator's state after the step (PatchGAN's running statistics).
    The CPU's convs take PyTorch's native path: oneDNN's fp32 conv weight
    gradients are TF32-like on some CPUs. Then ``reinit_disc_heads`` on the
    card's RobustTok trainer (DinoDisc): the trunk bit-unchanged, every head
    kernel drawn afresh, the spectral state kept and the disc optimizer
    empty."""
    vit_s = "vit_small_patch14_dinov2.lvd142m"
    for kind in ("patchgan", "stylegan"):
        mcfg, tcfg = flagship_gan_recipe(
            2, margs_overrides={"dtype_str": "float32", "encoder_model": vit_s,
                                "decoder_model": vit_s},
            tcfg_overrides={"loss_dtype": "float32", "disc_type": kind})
        gen = torch.Generator().manual_seed(SEED + 22)
        with torch.backends.mkldnn.flags(enabled=False):
            tr_cpu, tr_card = _trainer_pair(mcfg, tcfg, dev, gen)
            px = mcfg.image_size
            x = torch.rand((2, px, px, 3), generator=gen) * 2 - 1
            codes = Lockstep(quantize, "_codebook_lookup", _code_gap, NEAR_TIE)
            m_cpu, m_card, kinks = _lockstep_step(tr_cpu, tr_card, x, dev, gan_draws(2, px, gen),
                                                  {}, (codes,))
        shown = _check_step_metrics(f"{kind} step", m_cpu, m_card)
        g_errs, _ = _grad_errs("generator", tr_cpu.model.named_parameters(),
                               tr_card.model.parameters(), tr_cpu.gen_opt.params)
        # conv_out's bias: each logit inside the hinge margin adds +-1 / N,
        # the real and fake ones cancel, and LeCam's small share is left
        d_errs, _ = _grad_errs(kind, tr_cpu.disc.named_parameters(),
                               tr_card.disc.parameters(), tr_cpu.disc_opt.params,
                               by_weight=r"conv_out\.bias")
        state_err = _state_err(tr_cpu.disc, tr_card.disc)
        worst_g, worst_d = max(g_errs, key=g_errs.get), max(d_errs, key=d_errs.get)
        print(f"[model] disc_type={kind} step fp32 B=2 card vs CPU (ViT-S tokenizer): "
              f"disc_loss {m_cpu['disc_loss'].item():.6f}, gen_adv_loss "
              f"{m_cpu['gen_adv_loss'].item():.6f}, {shown}; {len(g_errs)} generator gradients "
              f"within {g_errs[worst_g]:.3e} of their max abs (worst {worst_g}), {len(d_errs)} "
              f"{kind} gradients within {d_errs[worst_d]:.3e} (worst {worst_d}); {kind} state "
              f"after the step max abs diff {state_err:.3e} (tol {MODEL_TOL:g}); codes "
              f"{codes.compared - codes.flips}/{codes.compared} equal, {kinks.flips} leaky-relu "
              f"elements took the CPU's branch")
        _check(f"[model] {kind} generator gradient of {worst_g}", g_errs[worst_g], MODEL_TOL)
        _check(f"[model] {kind} gradient of {worst_d}", d_errs[worst_d], MODEL_TOL)
        _check(f"[model] {kind} state", state_err, MODEL_TOL)
        del tr_cpu, tr_card

    tr = dino_trainer
    params = {n: p.detach().clone() for n, p in tr.disc.named_parameters()}
    buffers = {n: b.clone() for n, b in tr.disc.named_buffers()}
    tr.reinit_disc_heads(torch.Generator().manual_seed(SEED + 23))
    fresh = dict(DinoDisc(tr.tcfg.dino_depth,
                          generator=torch.Generator().manual_seed(SEED + 23)).named_parameters())
    heads = 0
    for n, p in tr.disc.named_parameters():
        if n.startswith("dino."):
            ok = torch.equal(p, params[n])
        else:
            ok = torch.equal(p.cpu(), fresh[n]) and (p.ndim < 2 or not torch.equal(p, params[n]))
            heads += 1
        if not ok:
            raise AssertionError(f"[model] reinit_disc_heads: {n}")
    if not all(torch.equal(b, buffers[n]) for n, b in tr.disc.named_buffers()) or (
            tr.disc_opt.count or tr.disc_opt.opt.state):
        raise AssertionError("[model] reinit_disc_heads: the spectral state moved or the disc "
                             "optimizer is not empty")
    print(f"[model] reinit_disc_heads (DinoDisc, on the card): trunk bit-unchanged, {heads} head "
          "parameters drawn afresh, spectral state kept, disc optimizer empty")


# ------------------------- tokenizer variants ------------------------- #

MSBR_YAMLS = (ROOT / "configs" / "MSBR10P2-4096.yaml", ROOT / "configs" / "MSBR10P2-16384.yaml")
VQ_YAML = ROOT / "configs" / "VQ-4096.yaml"
SIGN_TIE = 1e-6  # |x| under which an LFQ sign bit may differ card against CPU
MSBR_EPOCH = 80  # past the YAML's disc_epoch_start 64: DinoDisc and LeCam live
# the variants' fp32 step checks: the teachers and DinoDisc are the
# flagship's and RobustTok's checks; these take PatchGAN, and no teacher
LIGHT = {"mixed_precision": "none", "semantic_guide": "none", "detail_guide": "none",
         "disc_type": "patchgan"}
# scripts/e2e_pipeline.py's tokenizer overrides (:211-219)
E2E_CNN = {"enc_type": "cnn", "dec_type": "cnn", "vq_model": "VQ-16",
           "semantic_guide": "none", "detail_guide": "none", "disc_type": "patchgan"}
VARIANTS = {  # name -> ModelArgs fields set on VQ-4096.yaml's (to_pixel is no YAML key)
    "lora": {"enc_tuning_method": "lat_lora", "dec_tuning_method": "lora"},
    "latent pos": {"abs_pos_embed": False},
    "topixel conv": {"to_pixel": "conv"},
    "topixel siren": {"to_pixel": "siren"},
}


def _sign_gap(args, want, got, diff):
    """``quantize._sign_bits(rest)``: |x| of each flipped bit."""
    return args[0].detach().double().cpu()[diff].abs()


def _sign_lockstep():
    """LFQ's sign bits in lockstep: equal but where |x| < SIGN_TIE."""
    return Lockstep(quantize, "_sign_bits", _sign_gap, SIGN_TIE)


def _single_vq_lockstep():
    return Lockstep(quantize, "_nearest_code", _dist_gap, NEAR_TIE)


def load_yaml(path: Path, overrides=None):
    """(ModelArgs, TokenizerTrainConfig) of a YAML through the port's
    loader. A weight decay that PyYAML reads as a string (the MSBR YAMLs'
    ``5e-5``; the JAX loader leaves it so too) becomes a float."""
    mcfg, tcfg, _ = load_tokenizer_config(str(path), overrides)
    return mcfg, dataclasses.replace(tcfg, weight_decay=float(tcfg.weight_decay))


def msbr_margs(dtype_str: str) -> ModelArgs:
    """configs/MSBR10P2-4096.yaml's tokenizer at inference, through the
    port's loader: two PQ branches of 121 latents, ten scales of BSQ
    (12 bits, l2-normed, soft entropy 0.1), DINOv2 ViT-B/16 encoder and
    decoder, 256 px. The teachers feed only training losses and are left
    out, as ``msvr_margs`` leaves them."""
    mcfg, _ = load_yaml(MSBR_YAMLS[0])
    return dataclasses.replace(mcfg, dtype_str=dtype_str, semantic_guide="none",
                               detail_guide="none")


def _excite_lora(model: torch.nn.Module, gen: torch.Generator):
    """The LoRA B factors start at 0, which leaves the A factors without a
    gradient: draw them (on the CPU, from ``gen``) so that both carry one."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".lora_b." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


def _step_check(dev, what: str, mcfg, tcfg, lockstep, kw=None, zero_grad=ZERO_GRAD,
                frozen: bool = False, batch: int = 2):
    """One ``TokenizerTrainer`` step in fp32 at ``batch`` (a generator and a disc
    update), card against CPU from the same weights (LayerScale raised, LoRA
    B factors drawn) and the same draws, the codes in ``lockstep()`` and the
    piecewise-linear branches in ``KinkLockstep``: every metric, every
    trainable gradient of the generator (``zero_grad``: those 0 in exact
    arithmetic) and of the disc, and the state after the step. With
    ``frozen`` (a step that moves: ``lr_scheduler`` none), every frozen
    parameter bit-unchanged on both sides and every trainable one moved.
    The CPU's convs take PyTorch's native path."""
    gen = torch.Generator().manual_seed(SEED + 41)
    with torch.backends.mkldnn.flags(enabled=False):
        tr_cpu, tr_card = _trainer_pair(mcfg, tcfg, dev, gen)
        before = {n: p.detach().clone() for n, p in tr_cpu.model.named_parameters()}
        px = mcfg.image_size
        x = torch.rand((batch, px, px, 3), generator=gen) * 2 - 1
        codes = lockstep()
        m_cpu, m_card, kinks = _lockstep_step(tr_cpu, tr_card, x, dev, gan_draws(batch, px, gen),
                                              kw or {}, (codes,))
    shown = _check_step_metrics(what, m_cpu, m_card)
    g_errs, g_zero = _grad_errs(f"{what} generator", tr_cpu.model.named_parameters(),
                                tr_card.model.parameters(), tr_cpu.gen_opt.params, zero_grad)
    d_errs, _ = _grad_errs(f"{what} disc", tr_cpu.disc.named_parameters(),
                           tr_card.disc.parameters(), tr_cpu.disc_opt.params,
                           by_weight=r"conv_out\.bias")
    state_err = max(_state_err(tr_cpu.model, tr_card.model), _state_err(tr_cpu.disc, tr_card.disc))
    worst_g, worst_d = max(g_errs, key=g_errs.get), max(d_errs, key=d_errs.get)
    note = ""
    if frozen:
        n_frozen = n_moved = 0
        for tr in (tr_cpu, tr_card):
            for n, p in tr.model.named_parameters():
                same = torch.equal(p.detach().cpu(), before[n])
                if p.requires_grad == same:
                    raise AssertionError(f"[model] {what}: {n} is "
                                         f"{'trainable' if p.requires_grad else 'frozen'} "
                                         f"and {'unchanged' if same else 'moved'}")
                n_frozen, n_moved = n_frozen + same, n_moved + (not same)
        note = (f"; {n_frozen // 2} frozen parameter tensors bit-unchanged and {n_moved // 2} "
                "trainable ones moved, on both sides")
    head = f"{mcfg.dec_type} decoder" + (f", {mcfg.to_pixel} head" if mcfg.dec_type == "dinov2"
                                         else "")
    print(f"[model] {what} ({head}) fp32 B={batch} card vs CPU: gen_loss {m_cpu['gen_loss'].item():.6f}, "
          f"disc_adaptive_weight {m_cpu['disc_adaptive_weight'].item():.6f}, entropy_loss "
          f"{m_cpu['entropy_loss'].item():.6f}, {shown}; {len(g_errs)} generator gradients "
          f"within {g_errs[worst_g]:.3e} of their max abs (worst {worst_g}, median "
          f"{statistics.median(g_errs.values()):.3e}), {len(g_zero)} zero in exact arithmetic, "
          f"{len(d_errs)} disc gradients within {d_errs[worst_d]:.3e} (worst {worst_d}); state "
          f"after the step max abs diff {state_err:.3e} (tol {MODEL_TOL:g}); codes "
          f"{codes.compared - codes.flips}/{codes.compared} equal (max near-tie gap "
          f"{codes.max_gap:.3e}), {kinks.flips} piecewise-linear elements took the CPU's "
          f"branch" + note)
    _check(f"[model] {what} generator gradient of {worst_g}", g_errs[worst_g], MODEL_TOL)
    _check(f"[model] {what} disc gradient of {worst_d}", d_errs[worst_d], MODEL_TOL)
    _check(f"[model] {what} state after the step", state_err, MODEL_TOL)


def phase_model_msbr(dev):
    """The MSBR (BSQ) slice: both MSBR YAMLs build through the port's loader
    (the -16384 one on the card: its codes are 14 bits, in [0, 16384));
    MSBR10P2-4096 with VAR-d16 card against CPU as the MSVR checks
    (``phase_model_var``, ``phase_model_train``) with LFQ's sign bits in
    lockstep; and one ``TokenizerTrainer`` step of MSBR10P2-4096.yaml as it
    stands (DINOv2 and CLIP teachers, DinoDisc, LeCam; fp32, B=2, epoch 80).
    Returns nothing: the models are freed."""
    m16, _ = load_yaml(MSBR_YAMLS[1])
    vae16 = VQModel(dataclasses.replace(m16, dtype_str="float32", semantic_guide="none",
                                        detail_guide="none"),
                    generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    with torch.inference_mode():
        idx = vae16.img_to_idxBl(x.to(dev))
    top = max(int(i.max()) for b in idx for i in b)
    if not (m16.lfq and m16.codebook_size == 2 ** 14 and 0 <= min(int(i.min()) for b in idx
                                                                   for i in b) and top < 2 ** 14):
        raise AssertionError(f"[model] MSBR10P2-16384: codes up to {top}")
    print(f"[model] MSBR10P2-16384.yaml built through the port's loader: BSQ of "
          f"{m16.codebook_embed_dim} bits, codes of 2 branches x {len(m16.v_patch_nums)} scales "
          f"in [0, {top}]")
    del vae16, idx
    name = "MSBR10P2-4096 + VAR-d16"
    phase_model_train(dev, *phase_model_var(dev, msbr_margs("float32"), name, _sign_lockstep),
                      name, _sign_lockstep)
    mcfg, tcfg = load_yaml(MSBR_YAMLS[0], {"mixed_precision": "none"})
    _step_check(dev, "MSBR10P2-4096.yaml step (epoch 80)", mcfg, tcfg, _sign_lockstep,
                kw={"epoch": MSBR_EPOCH})


def phase_model_variants(dev):
    """LoRA finetuning (``enc_tuning_method=lat_lora``, ``dec_tuning_method=
    lora``, rank 8: a step that moves, with every frozen parameter
    bit-unchanged), learned latent pos embeds and the conv and siren ToPixel
    heads (the adaptive weight anchored at each head's last layer), each one
    ``_step_check`` of configs/VQ-4096.yaml with its overrides (``LIGHT``);
    then the identity head's round trip (its anchor refused), and the CNN
    tokenizer (the e2e pipeline's overrides) at B=1 (its CPU
    side is the slowest of the script's checks): the round trip card against
    CPU and one step (its attention's k biases 0 in exact arithmetic)."""
    for name, over in VARIANTS.items():
        extra = {"lr_scheduler": "none"} if name == "lora" else {}
        mcfg, tcfg = load_yaml(VQ_YAML, {**LIGHT, **extra})
        _step_check(dev, f"{name} step", dataclasses.replace(mcfg, **over), tcfg,
                    _single_vq_lockstep, frozen=name == "lora")
    _identity_round_trip_check(dev)
    mcfg, tcfg = load_yaml(VQ_YAML, {"mixed_precision": "none", **E2E_CNN})
    gen = torch.Generator().manual_seed(SEED + 43)
    with torch.backends.mkldnn.flags(enabled=False):
        cpu = VQModel(mcfg, generator=torch.Generator().manual_seed(SEED), device="cpu").eval()
        card = copy.deepcopy(cpu).to(dev)
        x = torch.rand((1, 256, 256, 3), generator=gen) * 2 - 1
        codes = _single_vq_lockstep()
        with torch.inference_mode():
            want = codes.on_cpu(lambda: cpu.img_to_reconstructed_img(x))
            got = codes.on_card(lambda: card.img_to_reconstructed_img(x.to(dev)))
    err = _max_err(got, want)
    print(f"[model] CNN tokenizer (VQ-4096.yaml, e2e overrides: ch 128, ch_mult "
          f"{tuple(mcfg.encoder_ch_mult)}, z {mcfg.z_channels}, 16 x 16 latents) round trip "
          f"fp32 B=1 card vs CPU: max abs err {err:.3e} (tol {MODEL_TOL:g}); codes "
          f"{codes.compared - codes.flips}/{codes.compared} equal")
    _check("[model] CNN round trip", err, MODEL_TOL)
    del cpu, card
    _step_check(dev, "CNN step", mcfg, tcfg, _single_vq_lockstep,
                zero_grad=r"(encoder|decoder)\..*\.k\.bias", batch=1)


def _identity_margs(dtype_str: str) -> ModelArgs:
    """VQ-4096.yaml's tokenizer (no teachers) with the ``identity`` head:
    its round trip returns the decoder's image tokens."""
    mcfg, _ = load_yaml(VQ_YAML, {"semantic_guide": "none", "detail_guide": "none"})
    return dataclasses.replace(mcfg, to_pixel="identity", dtype_str=dtype_str)


def _identity_round_trip_check(dev):
    """The ``identity`` head's round trip in fp32 at B=2, card against CPU
    (the decoder's (B, 256, 768) image tokens, clamped as every round trip
    is), and its adaptive-weight anchor refused on the card, as the JAX
    trainer refuses it."""
    cpu = VQModel(_identity_margs("float32"), generator=torch.Generator().manual_seed(SEED),
                  device="cpu").eval()
    card = copy.deepcopy(cpu).to(dev)
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(SEED + 46)) * 2 - 1
    codes = _single_vq_lockstep()
    with torch.inference_mode():
        want = codes.on_cpu(lambda: cpu.img_to_reconstructed_img(x))
        got = codes.on_card(lambda: card.img_to_reconstructed_img(x.to(dev)))
    err = _max_err(got, want)
    if tuple(got.shape) != (2, 256, 768):
        raise AssertionError(f"[model] identity head round trip {tuple(got.shape)}")
    try:
        card.last_layer
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("[model] the identity head's adaptive-weight anchor not refused")
    print(f"[model] topixel identity round trip fp32 B=2 card vs CPU: tokens {tuple(got.shape)}, "
          f"max abs err {err:.3e} (tol {MODEL_TOL:g}); codes {codes.compared - codes.flips}/"
          f"{codes.compared} equal; the anchor refused ({refusal})")
    _check("[model] identity head round trip", err, MODEL_TOL)


RARXL_DEPTH_CHECK = 2   # blocks of the fp32 card-vs-CPU check
RARXL_DEPTH = 8         # blocks of the timed path (RAR-XL has 32): depth cut for time


def phase_model_rar_xl(dev):
    """RAR-XL's width (1280 wide, 16 heads of 80: the kD = 128 kernels) at
    ``RARXL_DEPTH_CHECK`` blocks in fp32, B=2: the teacher-forcing forward,
    ``ar_loss`` and its backward, card against CPU (logits, loss, every
    gradient; the k_norm biases to ZERO_GRAD_TOL of their weights'), one #3
    and one #6 launch per block."""
    gen = torch.Generator().manual_seed(SEED + 44)
    rar_cpu = build_rar(bench_margs("float32"), hidden=1280, heads=RARXL_HEADS,
                        depth=RARXL_DEPTH_CHECK, generator=gen, device="cpu")
    _excite_adaln(rar_cpu, gen)
    rar_card = copy.deepcopy(rar_cpu).to(dev)
    cfg = rar_cpu.config
    batch = _rar_batch(cfg, 2, gen)

    def run(model, device):
        logits, labels = model(*(t.to(device) for t in batch))
        loss, _ = rar_mod.ar_loss(logits, labels)
        loss.backward()
        return logits.detach(), loss.detach()

    reset_counts()
    logits_card, loss_card = run(rar_card, dev)
    torch.cuda.synchronize()
    check_launches("[model] RAR-XL training fp32", 1, {"fused_attention_fwd": cfg.depth,
                                                       "fused_attention_bwd": cfg.depth})
    logits_cpu, loss_cpu = run(rar_cpu, "cpu")
    grad_errs, zero = _grad_errs("RAR-XL training", rar_cpu.named_parameters(),
                                 rar_card.parameters(), list(rar_cpu.parameters()),
                                 RAR_ZERO_GRAD)
    worst = max(grad_errs, key=grad_errs.get)
    errs = {"logits": _max_err(logits_card, logits_cpu) / logits_cpu.abs().max().item(),
            "loss": abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item()),
            f"gradient of {worst}": grad_errs[worst]}
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[model] RAR-XL width (1280, 16 heads of 80), {cfg.depth} blocks, training fp32 B=2 "
          f"card vs CPU (relative): {shown} (tol {MODEL_TOL:g}; {len(grad_errs)} parameter "
          f"gradients, median {statistics.median(grad_errs.values()):.3e}; {len(zero)} k_norm "
          f"biases at most {max(zero.values()):.3e} of their weights'); loss "
          f"{loss_cpu.item():.6f}")
    for k, v in errs.items():
        _check(f"[model] RAR-XL training {k}", v, MODEL_TOL)


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


def main_rar_train(dev) -> dict:
    """RAR-B's training forward and backward at B=64 in bf16 (``rar train
    fwd+bwd``): ``RAR.forward`` over per-sample orders under the causal
    mask, ``ar_loss``, and its backward, with the parameters' gradients set
    to None before each call. Per call one #3 launch with the lse store and
    one #6 launch per block (24 each); every parameter gets a finite
    gradient. The optimizer step (RAR's trainer) is not part of the path."""
    gen = torch.Generator().manual_seed(SEED + 13)
    rar = build_rar(bench_margs("bfloat16"), dtype_str="bfloat16", generator=gen, device="cpu")
    _excite_adaln(rar, gen)
    rar.to(dev)
    cfg = rar.config
    ids, cond, orders = (t.to(dev) for t in _rar_batch(cfg, BATCH, gen))

    def step():
        rar.zero_grad(set_to_none=True)
        loss, _ = rar_mod.ar_loss(*rar(ids, cond, orders))
        loss.backward()
        return loss.detach()

    r = time_calls("rar train fwd+bwd", step, 5, {"fused_attention_fwd": cfg.depth,
                                                 "fused_attention_bwd": cfg.depth}, dev)
    loss = r.pop("out")
    bad = [n for n, p in rar.named_parameters() if p.grad is None or
           not bool(torch.isfinite(p.grad).all())]
    if not bool(torch.isfinite(loss)) or bad:
        raise AssertionError(f"[main] rar train fwd+bwd: loss {loss.item()}, parameters "
                             f"without a finite gradient {bad[:5]}")
    _report("RAR-B train forward + ar_loss + backward (hd 48)", r, BATCH,
            f"loss {loss.item():.4f}, every parameter's gradient finite")
    return {"rar train fwd+bwd": r}


def main_maskgit_paths(dev) -> dict:
    """MaskGIT-B (bert) at B=64 in bf16: ``maskgit sample``,
    ``maskgit_generate`` at its defaults (8 steps, constant guidance 3.0,
    temperature 4.5; two forwards a step) with the Gumbel draws from a card
    generator, and ``decode_tokens`` on the RobustTok tokenizer with the
    fused sublayers; then ``maskgit train step``, one ``MaskGITTrainer``
    step (masking, forward with the condition dropped at 0.1, ``mlm_loss``,
    backward, AdamW) with its draws from a card generator. Per call: #3
    384, #7 12, #8 12; then #3 24 (lse stored) and #6 24."""
    margs = bench_margs("bfloat16")
    vae = VQModel(margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    set_fused_sublayers(vae, True, True)
    model = build_maskgit(margs, dtype_str="bfloat16",
                          generator=torch.Generator().manual_seed(SEED + 24), device=dev)
    cfg = model.config
    labels = torch.arange(BATCH, device=dev) % 1000
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    depth = len(vae.decoder.model.blocks)
    out = {}
    with torch.inference_mode():
        out["maskgit sample"] = r = time_calls(
            "maskgit sample",
            lambda: vae.decode_tokens(maskgit_mod.maskgit_generate(model, labels, sgen)),
            3, {"fused_attention_fwd": 2 * MASKGIT_STEPS * cfg.depth,
                "attn_sublayer_fused": depth, "mlp_sublayer_fused": depth}, dev)
        _check_images("maskgit sample", r.pop("out"), BATCH, margs.image_size)
        _report("MaskGIT-B maskgit_generate (8 steps, CFG 3) + fused decode_tokens", r, BATCH,
                "images in [-1, 1]")
    tr = MaskGITTrainer(model, 250_000)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.codebook_size, (BATCH, cfg.image_seq_len), generator=tgen,
                           device=dev)
    out["maskgit train step"] = r = time_calls(
        "maskgit train step", lambda: tr.train_step(tokens, labels, tgen), 5,
        {"fused_attention_fwd": cfg.depth, "fused_attention_bwd": cfg.depth}, dev)
    _check_metrics("maskgit train step", r.pop("out"), model)
    _report("MaskGIT-B MaskGITTrainer.train_step (mask, forward, mlm_loss, backward, AdamW)",
            r, BATCH, "loss and grad norm finite, every parameter finite")
    return out


def main_rar_train_step(dev) -> dict:
    """``rar train step``: one ``RARTrainer.train_step`` of RAR-B at B=64 in
    bf16 at the RAR recipe's settings (``RARTrainConfig``'s defaults):
    condition dropout, per-sample orders at random ratio 1 (the annealing's
    start), forward, ``ar_loss``, backward, AdamW with the clip, EMA; its
    draws from a card generator. Per call #3 24 (lse stored) and #6 24."""
    gen = torch.Generator().manual_seed(SEED + 25)
    rar = build_rar(bench_margs("bfloat16"), dtype_str="bfloat16", generator=gen, device="cpu")
    _excite_adaln(rar, gen)
    rar.to(dev)
    cfg, tcfg = rar.config, RARTrainConfig()
    tr = RARTrainer(rar, tcfg)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.codebook_size, (BATCH, cfg.image_seq_len), generator=tgen,
                           device=dev)
    labels = torch.arange(BATCH, device=dev) % 1000
    ratio = get_rar_random_ratio(tcfg.random_ratio_anneal_start, tcfg.random_ratio_anneal_end, 0)
    r = time_calls("rar train step", lambda: tr.train_step(tokens, labels, ratio, tgen), 5,
                   {"fused_attention_fwd": cfg.depth, "fused_attention_bwd": cfg.depth}, dev)
    _check_metrics("rar train step", r.pop("out"), rar)
    if not all(bool(torch.isfinite(e).all()) for e in tr.ema):
        raise AssertionError("[main] rar train step: a non-finite EMA parameter")
    _report("RAR-B RARTrainer.train_step (drop, orders, forward, ar_loss, backward, AdamW, "
            "EMA)", r, BATCH, "loss and grad norm finite, every parameter and EMA finite")
    return {"rar train step": r}


def _check_metrics(path: str, metrics: dict, model: torch.nn.Module):
    """A train step's loss and grad norm finite, and every parameter."""
    bad = [n for n, p in model.named_parameters() if not bool(torch.isfinite(p).all())]
    if not all(bool(torch.isfinite(metrics[k])) for k in ("loss", "grad_norm")) or bad:
        raise AssertionError(f"[main] {path}: loss {metrics['loss'].item()}, grad norm "
                             f"{metrics['grad_norm'].item()}, non-finite parameters {bad[:5]}")


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


def robusttok_launches(tr: TokenizerTrainer) -> dict:
    """Kernel launches of one RobustTok ``train_step`` (a micro-step), from
    the code: #1 in the encoder and decoder (again in the backward with
    remat), both teachers (DINOv2 and CLIP), DinoDisc in the generator pass
    and on the fake and real images; #2 as in ``gan_launches``; no #9 (a
    single-scale VQ takes its own argmin)."""
    m, cfg = tr.model, tr.model_cfg
    enc, dec = len(m.encoder.model.blocks), len(m.decoder.model.blocks)
    sem, det = len(m.semantic_model.blocks), len(m.detail_model.blocks)
    disc = len(tr.disc.dino.blocks)
    disc_bwd = max(tr.disc.kd) + 1 if tr.disc.kd else 0
    remat = 2 if cfg.remat else 1
    return {"attention_qkv_fwd": remat * (enc + dec) + sem + det + 3 * disc,
            "attention_qkv_bwd": enc + dec + 2 * disc_bwd}


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


def main_robusttok_paths(dev) -> dict:
    """``RobustTok train_step``: ``TokenizerTrainer.train_step`` on
    ``configs/RobustTok.yaml`` as the port's loader gives it (full width,
    bf16 activations and loss stack, the loader's remat), 64 images per
    micro-step with ``grad_accum_steps=2``, at epoch 80 inside the anneal
    window (ratio 0.75: alpha 0.75, beta 0.1, delta_ratio 0.75, so that
    floor(64 x 0.1) = 6 samples a micro-batch are perturbed), its draws from
    a card generator. Held: the exact launches (``robusttok_launches``),
    finite metrics, every trainable parameter changed over the 11
    micro-steps and every frozen one (both teachers, the VGG, DinoDisc's
    trunk) bit-unchanged; then, on one more micro-step, the perturbation
    moved tokens in each of the first 6 samples and in no other."""
    mcfg, tcfg, run = load_tokenizer_config(str(ROBUSTTOK_YAML))
    tcfg = dataclasses.replace(tcfg, grad_accum_steps=2)
    epoch = 80
    ratio = get_random_ratio(run.anneal_start, run.anneal_end, run.end_ratio, epoch)
    kw = dict(epoch=epoch, alpha=run.alpha * ratio, beta=run.beta, delta_ratio=ratio)
    tr = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    px = mcfg.image_size
    x = torch.rand((BATCH, px, px, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    named = [*(("model." + n, p) for n, p in tr.model.named_parameters()),
             *(("lpips." + n, p) for n, p in tr.lpips.named_parameters()),
             *(("disc." + n, p) for n, p in tr.disc.named_parameters())]
    before = {n: p.detach().clone() for n, p in named}
    per_call = robusttok_launches(tr)
    r = time_calls("RobustTok train_step", lambda: tr.train_step(x, **kw), 10, per_call, dev)
    updates = tr.gen_opt.count
    m = {k: v.float().mean().item() for k, v in r["out"].items()}
    changed = {n: not torch.equal(before[n], p) for n, p in named}
    trainable = {n: p.requires_grad for n, p in named}
    if not (all(math.isfinite(v) for v in m.values()) and changed == trainable):
        bad = sorted(n for n in changed if changed[n] != trainable[n])
        raise AssertionError(f"[main] RobustTok train_step metrics {m}; changed != trainable at "
                             f"{bad[:10]} ({len(bad)})")
    del before
    n_pert = math.floor(BATCH * run.beta)
    with PerturbRecorder() as rec:
        tr.train_step(x, **kw)
    moved = rec.moved[0]
    if not (bool((moved[:n_pert] > 0).all()) and not bool(moved[n_pert:].any())):
        raise AssertionError(f"[main] RobustTok perturbation moved {moved.tolist()} tokens per "
                             f"sample; want some in each of the first {n_pert}, none after")
    _report(f"RobustTok TokenizerTrainer.train_step (configs/RobustTok.yaml, grad_accum_steps=2, "
            f"epoch {epoch})", r, BATCH,
            ", ".join(f"{k} {v:.4f}" for k, v in m.items())
            + f"; {sum(changed.values())} trainable parameter tensors changed over 11 micro-steps "
            f"({updates} updates), {sum(not t for t in trainable.values())} frozen ones "
            f"(both teachers, VGG, DinoDisc trunk) unchanged; perturbation moved "
            f"{moved[:n_pert].tolist()} of {mcfg.num_latent_tokens} tokens in samples 0-"
            f"{n_pert - 1} and none in the other {BATCH - n_pert}; {CARD}")
    print(f"[main] RobustTok train_step: {r['ms']:.3f} ms per micro-step of {BATCH} images, "
          f"{BATCH / r['ms'] * 1e3:.1f} img/s, peak {r['peak'] / 2**30:.2f} GiB, remat "
          f"{mcfg.remat}; {CARD}")
    return {"RobustTok train_step": r}


CNN_TRAIN_BATCH = 16  # the CNN's 256 x 256 x 128 activations: a batch that fits with room


def _light_launches(tr: TokenizerTrainer) -> dict:
    """Launches of one ``train_step`` of a ViT tokenizer with no teacher and
    the PatchGAN disc: #1 in the encoder and decoder (again in the backward
    with remat), #2 in their backward; a CNN side launches none."""
    m = tr.model
    vits = [len(s.model.blocks) for s in (m.encoder, m.decoder) if hasattr(s, "model")]
    remat = 2 if tr.model_cfg.remat else 1
    return {"attention_qkv_fwd": remat * sum(vits), "attention_qkv_bwd": sum(vits)}


def _main_step(dev, path: str, mcfg, tcfg, batch: int, launches, kw=None) -> dict:
    """``TokenizerTrainer.train_step`` in bf16 (activations and loss stack)
    at ``batch`` from seeded weights and draws on the card, at the YAML's lr
    without its warm-up (``lr_scheduler`` none: a warm-up's first steps
    move a weight of 1 by less than its fp32 ulp): exact launches
    (``launches(trainer)``), finite metrics, every trainable parameter of
    the tokenizer and the disc moved after the timed steps and every frozen
    one bit-unchanged; then the round trip of the trained tokenizer at
    B=64, timed with its launches (#1 in every ViT block, none on a CNN
    side)."""
    iters = 5
    mcfg = dataclasses.replace(mcfg, dtype_str="bfloat16")
    tcfg = dataclasses.replace(tcfg, loss_dtype="bfloat16", lr_scheduler="none")
    tr = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    _excite_lora(tr.model, torch.Generator().manual_seed(SEED))
    px = mcfg.image_size
    x = torch.rand((BATCH, px, px, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    named = [*(("model." + n, p) for n, p in tr.model.named_parameters()),
             *(("disc." + n, p) for n, p in tr.disc.named_parameters())]
    before = {n: p.detach().clone() for n, p in named}
    xb = x[:batch]
    r = time_calls(path, lambda: tr.train_step(xb, **(kw or {})), iters, launches(tr), dev)
    m = {k: v.float().mean().item() for k, v in r.pop("out").items()}
    changed = {n: not torch.equal(before[n], p) for n, p in named}
    trainable = {n: p.requires_grad for n, p in named}
    if not (all(math.isfinite(v) for v in m.values()) and changed == trainable):
        bad = sorted(n for n in changed if changed[n] != trainable[n])
        raise AssertionError(f"[main] {path} metrics {m}; changed != trainable at {bad[:10]} "
                             f"({len(bad)})")
    del before
    _report(f"{path} (TokenizerTrainer.train_step)", r, batch,
            ", ".join(f"{k} {m[k]:.4f}" for k in ("gen_loss", "disc_loss", "entropy_loss",
                                                 "disc_adaptive_weight", "grad_norm"))
            + f"; {sum(changed.values())} trainable parameter tensors moved over "
            f"{iters + 1} steps, {sum(not t for t in trainable.values())} frozen ones unchanged")
    out = {path: r}
    vit = {"attention_qkv_fwd": sum(len(s.model.blocks) for s in (tr.model.encoder,
                                                                  tr.model.decoder)
                                    if hasattr(s, "model"))}
    model = tr.model.eval()
    name = path.replace("train_step", "round trip")
    with torch.inference_mode():
        out[name] = r = time_calls(name, lambda: model.img_to_reconstructed_img(x), iters,
                                   {k: v for k, v in vit.items() if v}, dev)
    y = r.pop("out")
    if not bool(torch.isfinite(y).all()) or (
            tuple(y.shape) != (BATCH, px, px, 3) or y.abs().max().item() > 1.0):
        raise AssertionError(f"[main] {name} output {tuple(y.shape)} malformed")
    _report(name, r, BATCH, f"images {tuple(y.shape)} in [{y.min().item():.3f}, "
                            f"{y.max().item():.3f}]")
    return out


def main_msbr_paths(dev) -> dict:
    """The BSQ slice in bf16 at B=64: the tokenizer's train step of
    MSBR10P2-4096.yaml as it stands at epoch 80 (both teachers, DinoDisc,
    LeCam; ``msbr train_step``) and its round trip (``msbr round trip``);
    ``var_sample``, ``img_to_idxBl`` and ``VAR.forward`` of VAR-d16 on its
    codes, and VAR's train and eval steps (``var msbr ...``,
    ``LAUNCHES_MSBR``)."""
    out = _main_step(dev, "msbr train_step", *load_yaml(MSBR_YAMLS[0]), BATCH,
                     robusttok_launches, {"epoch": MSBR_EPOCH})
    out.update({**main_var_paths(dev, msbr_margs("bfloat16"), "var msbr ", LAUNCHES_MSBR),
                **main_train_paths(dev, msbr_margs("bfloat16"), "var msbr ", LAUNCHES_MSBR)})
    return out


def main_variant_paths(dev) -> dict:
    """LoRA finetuning, learned latent pos embeds and the conv and siren
    heads in bf16 at B=64: each a train step of configs/VQ-4096.yaml with
    its overrides (both teachers and DinoDisc, as the YAML has them) and the
    round trip; the CNN tokenizer's train step at ``CNN_TRAIN_BATCH`` and
    round trip at B=64 (PatchGAN; no attention kernel on its path); the
    identity head's round trip (the decoder's image tokens) at B=64."""
    out = {}
    mcfg, tcfg = load_yaml(VQ_YAML)
    for name, over in VARIANTS.items():
        out.update(_main_step(dev, f"{name} train_step", dataclasses.replace(mcfg, **over), tcfg,
                              BATCH, robusttok_launches))
    mcfg, tcfg = load_yaml(VQ_YAML, E2E_CNN)
    out.update(_main_step(dev, "cnn train_step", mcfg, tcfg, CNN_TRAIN_BATCH, _light_launches))
    model = VQModel(_identity_margs("bfloat16"), generator=torch.Generator().manual_seed(SEED),
                    device=dev).eval()
    x = torch.rand((BATCH, 256, 256, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    with torch.inference_mode():
        out["topixel identity round trip"] = r = time_calls(
            "topixel identity round trip", lambda: model.img_to_reconstructed_img(x), 5,
            {"attention_qkv_fwd": 2 * VIT_DEPTH}, dev)
    y = r.pop("out")
    if tuple(y.shape) != (BATCH, 256, 768) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"[main] topixel identity round trip output {tuple(y.shape)}")
    _report("topixel identity round trip", r, BATCH, f"image tokens {tuple(y.shape)}")
    return out


def main_rar_xl_train(dev) -> dict:
    """RAR-XL's training forward and backward at B=64 in bf16 (``rar-xl
    train fwd+bwd``) at RAR-XL's width (1280, 16 heads of 80) and
    ``RARXL_DEPTH`` blocks: one #3 launch with the lse store and one #6
    launch (the two-kernel backward at kD = 128) per block; every
    parameter gets a finite gradient."""
    gen = torch.Generator().manual_seed(SEED + 45)
    rar = build_rar(bench_margs("bfloat16"), hidden=1280, heads=RARXL_HEADS, depth=RARXL_DEPTH,
                    dtype_str="bfloat16", generator=gen, device="cpu")
    _excite_adaln(rar, gen)
    rar.to(dev)
    cfg = rar.config
    ids, cond, orders = (t.to(dev) for t in _rar_batch(cfg, BATCH, gen))

    def step():
        rar.zero_grad(set_to_none=True)
        loss, _ = rar_mod.ar_loss(*rar(ids, cond, orders))
        loss.backward()
        return loss.detach()

    r = time_calls("rar-xl train fwd+bwd", step, 5, {"fused_attention_fwd": cfg.depth,
                                                    "fused_attention_bwd": cfg.depth}, dev)
    loss = r.pop("out")
    bad = [n for n, p in rar.named_parameters() if p.grad is None or
           not bool(torch.isfinite(p.grad).all())]
    if not bool(torch.isfinite(loss)) or bad:
        raise AssertionError(f"[main] rar-xl train fwd+bwd: loss {loss.item()}, parameters "
                             f"without a finite gradient {bad[:5]}")
    _report(f"RAR-XL width, {cfg.depth} blocks: train forward + ar_loss + backward (hd 80)", r,
            BATCH, f"loss {loss.item():.4f}, every parameter's gradient finite")
    return {"rar-xl train fwd+bwd": r}


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


def _time_graph_ms(fn, reps: int = 20) -> float:
    """``fn`` captured ``reps`` times into one CUDA graph and the graph's
    replay timed: the device time of the calls with no host gap between
    them (a small launch takes the card less time than Python takes to
    issue it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_kernel(name: str, kernel, plain, library, nbytes: float, ops: float,
                 dtype: torch.dtype, shape: str, reps: int = 20,
                 library_call: str = "one PyTorch call", timer=_time_ms) -> dict:
    """Kernel and plain version in the order plain, kernel, kernel, plain;
    then the library call (``library_call`` says what it is; None where no
    PyTorch call computes the same function); beside the bound for the
    same work. ``timer`` times ``reps`` calls of one of them."""
    with torch.inference_mode():
        p1, k1, k2, p2 = (timer(fn, reps) for fn in (plain, kernel, kernel, plain))
    # outside inference mode: a library backward needs autograd
    lib = None if library is None else timer(library, reps)
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
    time, from ``_time_kernel``). Not in inference mode: ``on`` may be the
    forward as autograd runs it when a gradient is wanted."""
    a1, b1, b2, a2 = (_time_ms(fn, reps) for fn in (off, on, on, off))
    rec["lse_off_ms"], rec["lse_on_ms"] = (a1 + a2) / 2, (b1 + b2) / 2
    print(f"[times] {name}: lse store off {a1:.4f}/{a2:.4f} ms, on {b1:.4f}/{b2:.4f} ms "
          f"(order off, on, on, off): {(rec['lse_on_ms'] / rec['lse_off_ms'] - 1) * 100:+.2f}%")


def times_qkv_fwd(dev, gen) -> dict:
    """#1 at the VQ-4096 decoder's shape, with the lse store off and on."""
    b, n, h = BATCH, 514, HEADS
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, HD).permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, hd) views
    rec = _time_kernel(
        "#1 attention_qkv", lambda: attn.attention_qkv(qkv, h),
        lambda: attn.attention_qkv_reference(qkv, h),
        lambda: F.scaled_dot_product_attention(q, k, v),
        (qkv.numel() + b * n * h * HD) * 2, 4 * b * h * n * n * HD, torch.bfloat16,
        str(tuple(qkv.shape)), library_call="SDPA")
    _time_lse("#1 attention_qkv", lambda: attn.attention_qkv(qkv, h),
              lambda: attn.attention_qkv_lse(qkv, h), rec)
    return rec


def times_qkv_bwd(dev, gen) -> dict:
    """#2 at the encoder's shape, no bias, as the GAN step's autograd calls
    it: with the forward's saved output and lse (prep, main and dq kernels
    timed); the library call is the backward only of SDPA on the q, k, v
    views of the same qkv."""
    b, n, h = BATCH, 499, HEADS
    qkv = torch.randn((b, n, 3 * HD * h), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((b, n, HD * h), generator=gen, device=dev).to(torch.bfloat16)
    o_fwd, lse = attn.attention_qkv_lse(qkv, h)
    lq, lk, lv = (t.detach().requires_grad_()
                  for t in qkv.view(b, n, 3, h, HD).permute(2, 0, 3, 1, 4).unbind(0))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    lib_g = g.view(b, n, h, HD).transpose(1, 2)
    return _time_kernel(
        "#2 attention_qkv backward",
        lambda: attn.attention_qkv_bwd(qkv, h, None, g, o=o_fwd, lse=lse),
        lambda: attn.attention_qkv_bwd_reference(qkv, h, None, g),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        (2 * qkv.numel() + g.numel()) * 2, 5 * 2 * b * h * n * n * HD, torch.bfloat16,
        f"qkv {tuple(qkv.shape)}, g {tuple(g.shape)}", library_call="SDPA backward")


def times_bnhd_fwd(dev, gen) -> dict:
    """#3 at the last 256 px sampling stage (most bytes of the path: the
    kernel's record), teacher forcing (and there the lse store's cost: the
    forward as the train step's autograd runs it, against the forward
    alone), the 512 px last sampling stage (bound by operations; the plain
    version in batch slices of 16); each shape's record also under
    "shapes"."""
    bf16 = torch.bfloat16
    ltot = sum(p * p for p in PNS)
    l512 = sum(p * p for p in PNS512)
    shapes = {}
    for name, (b, lq, lk), bias, chunk, reps in (
            ("last 256 px sampling stage", (2 * BATCH, PNS[-1] ** 2, ltot), None, 2 * BATCH, 20),
            ("teacher forcing", (BATCH, ltot, ltot), build_attn_bias(PNS).to(dev), BATCH, 20),
            ("512 px last sampling stage", (2 * BATCH, PNS512[-1] ** 2, l512), None, 16, 5)):
        q, k, v = _bnhd(gen, b, lq, lk, VAR_HEADS, bf16, dev)
        pairs = lq * lk if bias is None else int(torch.isfinite(bias).sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (
            0 if bias is None else bias.numel() * 4)
        shapes[name] = rec = _time_kernel(
            f"#3 fused_attention, {name}", lambda: attn.fused_attention(q, k, v, bias, 1.0),
            lambda: _in_chunks(attn.fused_attention_reference, b, chunk, q, k, v, bias, 1.0),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=None if bias is None else bias.to(bf16), scale=1.0),
            nbytes, 4 * b * VAR_HEADS * pairs * HD, bf16,
            f"q {tuple(q.shape)} k {tuple(k.shape)}", reps=reps, library_call="SDPA")
        if bias is not None:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            _time_lse(f"#3 fused_attention, {name}",
                      lambda: attn.fused_attention(q, k, v, bias, 1.0),
                      lambda: attn.fused_attention(qg, kg, vg, bias, 1.0), rec)
    return {**shapes["last 256 px sampling stage"], "shapes": shapes}


def times_bnhd_bwd(dev, gen) -> dict:
    """#6 at the training shape, block-causal bias, no dbias, as the train
    step calls it: the backward of ``fused_attention`` through autograd
    (with #3's saved output and lse: prep, main and dq kernels timed), as
    the library call is SDPA's backward through autograd."""
    bf16 = torch.bfloat16
    bias = build_attn_bias(PNS).to(dev)
    ltot = bias.shape[-1]
    q, k, v = _bnhd(gen, BATCH, ltot, ltot, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn.fused_attention(qg, kg, vg, bias, 1.0)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias.to(bf16), scale=1.0)
    lib_g = g.transpose(1, 2)
    pairs = int(torch.isfinite(bias).sum())
    return _time_kernel(
        "#6 fused_attention backward, training shape",
        lambda: torch.autograd.grad(out, (qg, kg, vg), g, retain_graph=True),
        lambda: attn.fused_attention_bwd_reference(q, k, v, bias, g, 1.0, need_dbias=False),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        7 * q.numel() * 2 + bias.numel() * 4, 5 * 2 * BATCH * VAR_HEADS * pairs * HD, bf16,
        f"q, k, v, g {tuple(q.shape)}", library_call="SDPA backward")


def _times_bnhd_fwd_at(dev, gen, what: str, seq: int, causal: bool,
                       hd: int = RAR_HD, batch: int = BATCH, heads: int = RAR_HEADS) -> dict:
    """#3 at head dim ``hd`` (48 by default), (batch, seq, heads, hd) bf16 at scale
    1/sqrt(hd), under the causal mask or with no bias, with the lse store off
    and on (on: the forward as a training step's autograd runs it)."""
    bf16 = torch.bfloat16
    bias = _causal(seq, dev) if causal else None
    q, k, v = _bnhd(gen, batch, seq, seq, heads, bf16, dev, l2=False, hd=hd)
    scale = 1.0 / math.sqrt(hd)
    pairs = int(torch.isfinite(bias).sum()) if causal else seq * seq
    rec = _time_kernel(
        f"#3 fused_attention, {what} (hd {hd})",
        lambda: attn.fused_attention(q, k, v, bias, scale),
        lambda: attn.fused_attention_reference(q, k, v, bias, scale),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=None if bias is None else bias.to(bf16), scale=scale),
        4 * q.numel() * 2 + (bias.numel() * 4 if causal else 0),
        4 * batch * heads * pairs * hd, bf16,
        f"q, k, v {tuple(q.shape)}, bias {'none' if bias is None else tuple(bias.shape)}",
        library_call="SDPA")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    _time_lse(f"#3 fused_attention, {what} (hd {hd})",
              lambda: attn.fused_attention(q, k, v, bias, scale),
              lambda: attn.fused_attention(qg, kg, vg, bias, scale), rec)
    return rec


def _times_bnhd_bwd_at(dev, gen, what: str, seq: int, causal: bool,
                       hd: int = RAR_HD, batch: int = BATCH, heads: int = RAR_HEADS) -> dict:
    """#6 at head dim ``hd`` (48 by default), (batch, seq, heads, hd) bf16 under
    the causal mask or with no bias, no dbias, through autograd with #3's
    saved output and lse (at 48: prep, main and dq kernels timed; past 64
    the two-kernel design, which reads neither), as the library call is
    SDPA's backward through autograd."""
    bf16 = torch.bfloat16
    bias = _causal(seq, dev) if causal else None
    q, k, v = _bnhd(gen, batch, seq, seq, heads, bf16, dev, l2=False, hd=hd)
    scale = 1.0 / math.sqrt(hd)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn.fused_attention(qg, kg, vg, bias, scale)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=None if bias is None else bias.to(bf16), scale=scale)
    pairs = int(torch.isfinite(bias).sum()) if causal else seq * seq
    return _time_kernel(
        f"#6 fused_attention backward, {what} (hd {hd})",
        lambda: torch.autograd.grad(out, (qg, kg, vg), g, retain_graph=True),
        lambda: attn.fused_attention_bwd_reference(q, k, v, bias, g, scale, need_dbias=False),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g.transpose(1, 2), retain_graph=True),
        7 * q.numel() * 2 + (bias.numel() * 4 if causal else 0),
        5 * 2 * batch * heads * pairs * hd, bf16,
        f"q, k, v, g {tuple(q.shape)}", library_call="SDPA backward")


def times_bnhd_fwd_hd48(dev, gen) -> dict:
    """#3 at RAR-B's teacher forcing, (64, 258, 16, 48) under the causal mask."""
    return _times_bnhd_fwd_at(dev, gen, "RAR-B teacher forcing", RAR_SEQ, True)


def times_bnhd_bwd_hd48(dev, gen) -> dict:
    """#6 at RAR-B's training shape, (64, 258, 16, 48) under the causal mask."""
    return _times_bnhd_bwd_at(dev, gen, "RAR-B training", RAR_SEQ, True)


def times_bnhd_fwd_maskgit(dev, gen) -> dict:
    """#3 at MaskGIT-B's shape, (64, 257, 16, 48) with no bias: each forward
    of sampling and of the training step."""
    return _times_bnhd_fwd_at(dev, gen, "MaskGIT-B", MASKGIT_SEQ, False)


def times_bnhd_bwd_maskgit(dev, gen) -> dict:
    """#6 at MaskGIT-B's training shape, (64, 257, 16, 48) with no bias."""
    return _times_bnhd_bwd_at(dev, gen, "MaskGIT-B training", MASKGIT_SEQ, False)


def times_bnhd_fwd_rarxl(dev, gen) -> dict:
    """#3 at RAR-XL's teacher forcing, (64, 258, 16, 80) under the causal mask."""
    return _times_bnhd_fwd_at(dev, gen, "RAR-XL teacher forcing", RAR_SEQ, True, RARXL_HD)


def times_bnhd_bwd_rarxl(dev, gen) -> dict:
    """#6 at RAR-XL's training shape, (64, 258, 16, 80) under the causal mask."""
    return _times_bnhd_bwd_at(dev, gen, "RAR-XL training", RAR_SEQ, True, RARXL_HD)


def times_bnhd_fwd_rarxxl(dev, gen) -> dict:
    """#3 at RAR-XXL's teacher forcing, (64, 258, 16, 88) under the causal mask."""
    return _times_bnhd_fwd_at(dev, gen, "RAR-XXL teacher forcing", RAR_SEQ, True, RARXXL_HD)


def times_bnhd_bwd_rarxxl(dev, gen) -> dict:
    """#6 at RAR-XXL's training shape, (64, 258, 16, 88) under the causal mask."""
    return _times_bnhd_bwd_at(dev, gen, "RAR-XXL training", RAR_SEQ, True, RARXXL_HD)


def times_bnhd_fwd_hd256(dev, gen) -> dict:
    """#3 at head dim 256 (a generator of hidden 1024 over 4 heads), (16,
    258, 4, 256) under the causal mask: the kD = 256 FMA kernel."""
    return _times_bnhd_fwd_at(dev, gen, "hidden 1024 / 4 heads", RAR_SEQ, True, HD256,
                              HD256_BATCH, HD256_HEADS)


def times_bnhd_bwd_hd256(dev, gen) -> dict:
    """#6 at head dim 256, (16, 258, 4, 256) under the causal mask."""
    return _times_bnhd_bwd_at(dev, gen, "hidden 1024 / 4 heads", RAR_SEQ, True, HD256,
                              HD256_BATCH, HD256_HEADS)


def times_qblk_fwd(dev, gen) -> dict:
    """#4 at VAR's 512 px teacher forcing under the block-causal bias (the
    kernel's record, and the lse store's cost), then the decoder's and the
    encoder's packed views with no bias, whose plain version runs in batch
    slices of 8 and 4 (its (B, H, N, N) fp32 scores do not fit the card at
    once); each shape's record also under "shapes"."""
    bf16 = torch.bfloat16
    bias = build_attn_bias(PNS512).to(dev)
    l512, pairs = bias.shape[-1], int(torch.isfinite(bias).sum())
    q, k, v = _bnhd(gen, 16, l512, l512, VAR_HEADS, bf16, dev)
    rec = _time_kernel(
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
              lambda: attn.fused_attention_qblk_lse(q, k, v, bias, 1.0), rec)
    del q, k, v
    shapes = {"VAR teacher forcing 512": rec}
    for name, n, chunk in (("decoder", 2050, 8), ("encoder", 3073, 4)):
        q, k, v = _packed_views(gen, BATCH, n, HEADS, bf16, dev)
        shapes[f"{name} 512 packed views"] = _time_kernel(
            f"#4 fused_attention_qblk, {name} 512 packed views (plain in slices of {chunk})",
            lambda: attn.fused_attention_qblk(q, k, v),
            lambda: _in_chunks(attn.fused_attention_qblk_reference, BATCH, chunk, q, k, v),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2)),
            4 * q.numel() * 2, 4 * BATCH * HEADS * n * n * HD, bf16,
            f"q, k, v {tuple(q.shape)} of qkv ({BATCH}, {n}, {3 * HD * HEADS})", reps=5,
            library_call="SDPA")
        del q, k, v
    return {**rec, "shapes": shapes}


def times_qblk_bwd(dev, gen) -> dict:
    """#5 at VAR's 512 px training shape, block-causal bias, no dbias, as
    the train step's autograd calls it: with the forward's saved output and
    lse (prep, main and dq kernels timed); the plain version in batch
    slices of 4."""
    bf16 = torch.bfloat16
    bias = build_attn_bias(PNS512).to(dev)
    l512, pairs = bias.shape[-1], int(torch.isfinite(bias).sum())
    q, k, v = _bnhd(gen, 16, l512, l512, VAR_HEADS, bf16, dev)
    g = torch.randn(q.shape, generator=gen, device=dev).to(bf16)
    o_fwd, lse = attn.fused_attention_qblk_lse(q, k, v, bias, 1.0)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias.to(bf16), scale=1.0)
    lib_g = g.transpose(1, 2)
    return _time_kernel(
        "#5 fused_attention_qblk backward, VAR training 512 (plain in slices of 4)",
        lambda: attn.fused_attention_qblk_bwd(q, k, v, bias, g, 1.0, need_dbias=False,
                                              o=o_fwd, lse=lse),
        lambda: _in_chunks(attn.fused_attention_qblk_bwd_reference, 16, 4, q, k, v, bias, g,
                           1.0, need_dbias=False),
        lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_g, retain_graph=True),
        7 * q.numel() * 2 + bias.numel() * 4, 5 * 2 * 16 * VAR_HEADS * pairs * HD, bf16,
        f"q, k, v, g {tuple(q.shape)}", reps=5, library_call="SDPA backward")


# #7 and #8 at the VQ-4096 decoder's shape, the residual stream fp32 (every
# block's but the first); the library column is the composed path (cuBLAS
# GEMMs, #1 and the elementwise passes): no one PyTorch call computes either
# sublayer
SUBLAYER = (BATCH, 514, 768, HEADS, 3072)  # b, n, c, heads, hidden


def times_attn_sublayer(dev, gen) -> dict:
    b, n, c, h, _ = SUBLAYER
    m = b * n
    ops = _sublayer_operands(gen, b, n, c, 3 * c, torch.bfloat16, dev)
    return _time_kernel(
        "#7 attn_sublayer_fused, decoder", lambda: block.attn_sublayer_fused(*ops, h),
        lambda: block.attn_sublayer_fused_reference(*ops, h),
        lambda: block.attn_sublayer(*ops, h),
        m * c * (2 + 4 + 4) + (3 * c * c + c * c) * 2 + (4 * c) * 2 + c * 4,
        2 * m * c * 3 * c + 4 * b * h * n * n * HD + 2 * m * c * c, torch.bfloat16,
        f"xn {(b, n, c)}, {h} heads", library_call="composed path: cuBLAS, #1, elementwise")


def times_mlp_sublayer(dev, gen) -> dict:
    b, n, c, _, hid = SUBLAYER
    m = b * n
    ops = _sublayer_operands(gen, b, n, c, hid, torch.bfloat16, dev)
    return _time_kernel(
        "#8 mlp_sublayer_fused, decoder", lambda: block.mlp_sublayer_fused(*ops),
        lambda: block.mlp_sublayer_fused_reference(*ops), lambda: block.mlp_sublayer(*ops),
        m * c * (2 + 4 + 4) + 2 * c * hid * 2 + (hid + c) * 2 + c * 4, 4 * m * c * hid,
        torch.bfloat16, f"xn {(b, n, c)}, hidden {hid}",
        library_call="composed path: cuBLAS, elementwise")


def times_fused_mlp(dev, gen) -> dict:
    """#10 at scripts/perf.py's probe shape."""
    m, d, hid, _ = MLP_PROBE
    x = torch.randn((m, d), generator=gen, device=dev).bfloat16()
    w1 = (torch.randn((hid, d), generator=gen, device=dev) * 0.02).bfloat16()
    w2 = (torch.randn((d, hid), generator=gen, device=dev) * 0.02).bfloat16()
    b1, b2 = torch.zeros(hid, device=dev), torch.zeros(d, device=dev)
    return _time_kernel(
        "#10 fused_mlp, perf.py's probe", lambda: block.fused_mlp(x, w1, b1, w2, b2),
        lambda: block.fused_mlp_reference(x, w1, b1, w2, b2), None,
        2 * m * d * 2 + 2 * d * hid * 2 + (hid + d) * 4, 4 * m * d * hid, torch.bfloat16,
        f"x ({m}, {d}), hidden {hid}", library_call="none")


def times_codebook(dev, gen) -> dict:
    """#9 at every scale of both multi-scale encodes at B=64 (N = 64 pn^2
    rows per PQ branch against a 4096 x 32 codebook, the cosine search the
    quantizer runs), each kernel, plain version and library call timed as a
    CUDA graph of 20 calls (``_time_graph_ms``); then per encode the sums
    over its 20 launches (two branches a scale), under "encodes". The
    record's own numbers are the last 256 px scale's (N = 7744); every
    scale's record is under "shapes"."""
    vsz, c = 4096, 32
    cb = _l2n(torch.randn((vsz, c), generator=gen, device=dev))
    shapes = {}
    for pn in sorted(set(PNS) | set(PNS512)):
        n = BATCH * pn * pn
        x = _l2n(torch.randn((n, c), generator=gen, device=dev))
        shapes[f"pn={pn}"] = _time_kernel(
            f"#9 codebook_argmin, pn={pn}", lambda: codebook.codebook_argmin(x, cb, True),
            lambda: codebook.codebook_argmin_reference(x, cb, True),
            lambda: torch.argmax(x @ cb.T, dim=-1),
            (n * c + vsz * c) * 4 + n * 8, 2 * n * vsz * c, torch.float32,
            f"x ({n}, {c}) codebook ({vsz}, {c})", library_call="x @ e.T, argmax",
            timer=_time_graph_ms)
    encodes = {}
    for px, pns in (("256 px", PNS), ("512 px", PNS512)):
        encodes[px] = {k: sum(2 * shapes[f"pn={pn}"][k] for pn in pns)
                       for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        e = encodes[px]
        print(f"[times] #9 codebook_argmin, one {px} encode at B={BATCH} (2 x {len(pns)} "
              f"launches, pn {pns}): kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
              f"library {e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms; kernel at "
              f"{e['bound_ms'] / e['ms'] * 100:.1f}% of the bound")
    return {**shapes[f"pn={PNS[-1]}"], "shapes": shapes, "encodes": encodes}


TIMES = {"attention_qkv_fwd": times_qkv_fwd, "attention_qkv_bwd": times_qkv_bwd,
         "fused_attention_fwd": times_bnhd_fwd, "fused_attention_bwd": times_bnhd_bwd,
         "fused_attention_qblk_fwd": times_qblk_fwd, "fused_attention_qblk_bwd": times_qblk_bwd,
         "attn_sublayer_fused": times_attn_sublayer, "mlp_sublayer_fused": times_mlp_sublayer,
         "fused_mlp": times_fused_mlp, "codebook_argmin": times_codebook,
         "fused_attention_fwd_hd48": times_bnhd_fwd_hd48,
         "fused_attention_bwd_hd48": times_bnhd_bwd_hd48,
         "fused_attention_fwd_maskgit": times_bnhd_fwd_maskgit,
         "fused_attention_bwd_maskgit": times_bnhd_bwd_maskgit,
         "fused_attention_fwd_rarxl": times_bnhd_fwd_rarxl,
         "fused_attention_bwd_rarxl": times_bnhd_bwd_rarxl,
         "fused_attention_fwd_rarxxl": times_bnhd_fwd_rarxxl,
         "fused_attention_bwd_rarxxl": times_bnhd_bwd_rarxxl,
         "fused_attention_fwd_hd256": times_bnhd_fwd_hd256,
         "fused_attention_bwd_hd256": times_bnhd_bwd_hd256}
# records timed at head dims 48, 80, 88 and 256, filed with their kernel's
# record under "shapes" in the kernels line
SHAPE_TIMES = {
    "fused_attention_fwd_rarxl": ("fused_attention_fwd", "RAR-XL teacher forcing, hd 80"),
    "fused_attention_bwd_rarxl": ("fused_attention_bwd", "RAR-XL training, hd 80"),
    "fused_attention_fwd_rarxxl": ("fused_attention_fwd", "RAR-XXL teacher forcing, hd 88"),
    "fused_attention_bwd_rarxxl": ("fused_attention_bwd", "RAR-XXL training, hd 88"),
    "fused_attention_fwd_hd48": ("fused_attention_fwd", "RAR-B teacher forcing, hd 48"),
    "fused_attention_bwd_hd48": ("fused_attention_bwd", "RAR-B training, hd 48"),
    "fused_attention_fwd_maskgit": ("fused_attention_fwd", "MaskGIT-B, no bias, hd 48"),
    "fused_attention_bwd_maskgit": ("fused_attention_bwd", "MaskGIT-B training, no bias, hd 48"),
    "fused_attention_fwd_hd256": ("fused_attention_fwd", "hidden 1024 / 4 heads, hd 256"),
    "fused_attention_bwd_hd256": ("fused_attention_bwd", "hidden 1024 / 4 heads training, hd 256")}


def phase_times(dev, names=tuple(TIMES)) -> dict:
    """Each named kernel's record (``TIMES``), in the order given, on inputs
    from one generator."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return {name: TIMES[name](dev, gen) for name in names}


SAME_HDS = (48, 64, 80, 128)  # the widths whose results ``same`` holds bit for bit


def phase_outputs(dev, path: str):
    """Every BNHD kernel (#3-#6) at head dims 48, 64, 80 and 128 on inputs from a
    fixed seed, saved to ``path``: #3 with and without the causal mask and
    its lse, #6 on the wgmma backward (o and lse from #3), with dbias (its
    dq, dk and dv: dbias is summed by atomicAdd in no fixed order) and in
    fp32, #4 and #5 past the single-block budget under an encoder mask.
    Two checkouts' files compared by ``same`` show whether a change left
    the kernels' results bit for bit as they were."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4864)
    out = {}
    for hd in SAME_HDS:
        scale = 1.0 / math.sqrt(hd)
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"hd {hd} {str(dtype)[6:]}"
            causal = _causal(130, dev)
            q, k, v = _bnhd(gen, 4, 130, 130, 4, dtype, dev, l2=False, hd=hd)
            g = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            out[f"#3 causal {tag}"] = attn.fused_attention(q, k, v, causal, scale)
            out[f"#3 no bias {tag}"] = attn.fused_attention(q, k, v, None, scale)
            kw = {}
            if dtype == torch.bfloat16:
                kw["o"], kw["lse"] = attn.fused_attention_lse(q, k, v, causal, scale)
                out[f"#3 lse {tag}"] = kw["lse"]
            out[f"#6 {tag}"] = attn.fused_attention_bwd(q, k, v, causal, g, scale, False, **kw)[:3]
            # dbias itself sums by atomicAdd in no fixed order: not compared
            out[f"#6 dbias {tag}"] = attn.fused_attention_bwd(q, k, v, causal, g, scale,
                                                              True)[:3]
            mask = encoder_mask(2100, 700, dev, 64)
            q, k, v = _bnhd(gen, 2, 2100, 2100, 4, dtype, dev, l2=False, hd=hd)
            g = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            out[f"#4 {tag}"] = attn.fused_attention_qblk(q, k, v, mask, scale)
            out[f"#5 {tag}"] = attn.fused_attention_qblk_bwd(q, k, v, mask, g, scale, False)[:3]
    torch.cuda.synchronize()
    torch.save(_to(out, torch.device("cpu")), path)
    print(f"[outputs] {len(out)} results at head dims {SAME_HDS} saved to {path}")


def phase_same(a: str, b: str) -> int:
    """Whether two ``outputs`` files hold the same results bit for bit."""
    ra, rb = torch.load(a), torch.load(b)
    if set(ra) != set(rb):
        raise AssertionError(f"[same] the files name different results: {set(ra) ^ set(rb)}")
    differ = []
    for key in ra:
        xs, ys = ra[key], rb[key]
        xs, ys = (xs, ys) if isinstance(xs, (tuple, list)) else ((xs,), (ys,))
        if any((x is None) != (y is None) or (x is not None and not torch.equal(x, y))
               for x, y in zip(xs, ys)):
            differ.append(key)
    print(f"[same] {len(ra) - len(differ)} of {len(ra)} results bit-equal"
          + (f"; differ: {differ}" if differ else ""))
    return 1 if differ else 0


# ------------------------------ CLI paths ------------------------------- #

CLI_TRAIN_PNGS, CLI_VAL_PNGS = 128, 32   # 2 steps an epoch at B=64
CLI_RESUME_BATCH = 8                      # the exact-resume check, on the first 16 PNGs
CLI_COMPARE_IMAGES = 8                    # eval_reconstruction card against CPU
CLI_FID_IMAGES = 64                       # each evaluate_fid npz batch
MSVR_YAML = ROOT / "configs" / "MSVR10P2-4096.yaml"
RESUME_TOL = 1e-5                         # of a tensor's max abs, where not bit-equal
# the CLI runs' shared settings: 2 epochs of 2 steps, the discriminator on
# from epoch 1, a checkpoint (and the best by rFID over one val batch) and a
# recon grid every 2 steps
CLI_TRAIN_OVERRIDES = ["epochs=2", "disc_epoch_start=1", "ckpt_every=2", "vis_every=2",
                       "log_every=2"]


def _write_pngs(root: Path, n: int, seed: int, px: int = 256):
    """n seeded px x px RGB PNGs in two class folders: smooth colour fields
    with noise, so that a reconstruction has structure to keep."""
    from PIL import Image

    g = torch.Generator().manual_seed(seed)
    for i in range(n):
        d = root / f"class_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        low = torch.rand((3, 4, 4), generator=g)[None]
        img = F.interpolate(low, size=(px, px), mode="bilinear", align_corners=False)[0]
        img = (img + 0.1 * torch.randn((3, px, px), generator=g)).clamp(0, 1)
        Image.fromarray((img.permute(1, 2, 0) * 255).to(torch.uint8).numpy()).save(
            d / f"{i:04d}.png")


class StepRecorder:
    """Wraps ``TokenizerTrainer.train_step`` while in use: every call runs
    with the launch counters set to 0 just before and read just after, and
    is timed between CUDA events (synchronised, so that the next call's
    counts are its own)."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        orig = self.orig = TokenizerTrainer.train_step

        def step(tr, *a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            reset_counts()
            start.record()
            out = orig(tr, *a, **k)
            end.record()
            torch.cuda.synchronize()
            self.steps.append((read_counts(), start.elapsed_time(end), robusttok_launches(tr)))
            return out

        TokenizerTrainer.train_step = step
        return self

    def __exit__(self, *exc):
        TokenizerTrainer.train_step = self.orig


class _Stop(Exception):
    pass


def _cli_train(dev, root: Path, inception: Path) -> dict:
    """``train_tokenizer.main`` on configs/RobustTok.yaml at B=64 for 4
    steps from the PNG folder: each step's launches exactly RobustTok's
    (#1 84, #2 48), its time; checkpoints at steps 2 and 4, the best by the
    val rFID (one val batch of 32, the seeded Inception), the recon grids."""
    from imagefolder_tpu_torch.scripts import train_tokenizer

    out = root / "train_out"
    argv = ["--config", str(ROBUSTTOK_YAML), "--inception_ckpt", str(inception),
            "--val_batch_size", str(CLI_VAL_PNGS), "--val_batches", "1",
            f"data_path={root / 'train'}", f"val_data_path={root / 'val'}",
            f"cloud_save_path={out}", f"global_batch_size={BATCH}", *CLI_TRAIN_OVERRIDES]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with StepRecorder() as rec:
        r = train_tokenizer.main(argv)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for i, (got, _, want) in enumerate(rec.steps):
        full = {k: want.get(k, 0) for k in COUNTERS}
        if got != full:
            raise AssertionError(f"[cli] train_tokenizer step {i}: launches {got}, want {full}")
    grids = sorted(p.name for p in (out / "vis").iterdir())
    vals = r["val"]
    if not (r["step"] == 4 and r["ckpt"].steps() == [2, 4] and (out / "best.pt").exists()
            and grids == ["recon_0000002.png", "recon_0000004.png"]
            and [v[:2] for v in vals] == [(2, "val_rfid"), (4, "val_rfid")]
            and all(math.isfinite(v[2]) for v in vals)):
        raise AssertionError(f"[cli] train_tokenizer wrote steps {r['ckpt'].steps()}, grids "
                             f"{grids}, validations {vals}")
    m = {k: v.float().mean().item() for k, v in r["metrics"].items()}
    if not all(math.isfinite(v) for v in m.values()) or m["disc_weight"] <= 0:
        raise AssertionError(f"[cli] train_tokenizer last metrics {m}")
    ms = [t for _, t, _ in rec.steps]
    warm = statistics.median(ms[1:])  # the first step pays the first calls' set-up
    per_step = {k: v for k, v in rec.steps[0][0].items() if v}
    print(f"[cli] train_tokenizer RobustTok.yaml B={BATCH}, {len(ms)} steps: {secs:.1f} s in "
          f"main (the trainer built, {CLI_TRAIN_PNGS} PNGs decoded by 8 workers, 2 val rFIDs, "
          f"2 grids, 3 checkpoints); steps {', '.join(f'{t:.1f}' for t in ms)} ms (median "
          f"after the first {warm:.1f} ms, {BATCH / warm * 1e3:.1f} img/s); "
          f"peak {peak / 2**30:.2f} GiB allocated; launches per step {per_step}; val rFID "
          f"{', '.join(f'{v[2]:.3f}' for v in vals)} (seeded Inception: plumbing, not a number "
          f"to report); last gen_loss {m['gen_loss']:.4f}, disc_loss {m['disc_loss']:.4f}; "
          f"{CARD}")
    totals = {k: sum(s[0][k] for s in rec.steps) for k in COUNTERS}
    del r
    return {"cli train_tokenizer": {"launches": totals, "ms": warm, "peak": peak}}


def _cli_resume(dev, root: Path) -> None:
    """Exact resume on the card at B=8 over the first 16 PNGs (2 steps an
    epoch): a run stopped after its step-2 checkpoint and resumed with
    ``--resume`` against the straight 4-step run, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: every
    parameter, the EMA, the discriminator's state, both optimizers' state
    and the last metrics bit-equal, or within RESUME_TOL of each tensor's
    max abs where an op has no deterministic kernel (PyTorch warns which)."""
    import shutil
    import warnings

    from imagefolder_tpu_torch.scripts import train_tokenizer

    sub = root / "train16" / "class_0"
    sub.mkdir(parents=True)
    for p in sorted((root / "train").rglob("*.png"))[:16]:
        shutil.copy(p, sub / p.name)

    def argv(out, *extra):
        return ["--config", str(ROBUSTTOK_YAML), *extra, f"data_path={root / 'train16'}",
                f"cloud_save_path={out}", f"global_batch_size={CLI_RESUME_BATCH}",
                "save_best=false", *CLI_TRAIN_OVERRIDES[:3], "vis_every=0", "log_every=100"]

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    orig = TokenizerTrainer.train_step
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            want = train_tokenizer.main(argv(root / "straight"))

            def stop_at_2(tr, *a, **k):
                if tr.step == 2:
                    raise _Stop
                return orig(tr, *a, **k)

            TokenizerTrainer.train_step = stop_at_2
            try:
                train_tokenizer.main(argv(root / "resumed"))
            except _Stop:
                pass
            TokenizerTrainer.train_step = orig
            got = train_tokenizer.main(argv(root / "resumed", "--resume"))
            secs = time.perf_counter() - t0
            for run in ("straight", "resumed"):
                shutil.rmtree(root / run)
    finally:
        TokenizerTrainer.train_step = orig
        torch.use_deterministic_algorithms(det)
    a, b = want["trainer"], got["trainer"]
    pairs = [*(("model." + n, p, q) for (n, p), q in zip(a.model.state_dict().items(),
                                                           b.model.state_dict().values())),
             *(("disc." + n, p, q) for (n, p), q in zip(a.disc.state_dict().items(),
                                                          b.disc.state_dict().values())),
             *((f"ema.{i}", p, q) for i, (p, q) in enumerate(zip(a.ema_params, b.ema_params))),
             *((f"metric.{k}", v, got["metrics"][k]) for k, v in want["metrics"].items())]
    for tag, oa, ob in (("gen_opt", a.gen_opt, b.gen_opt), ("disc_opt", a.disc_opt, b.disc_opt)):
        sa, sb = oa.opt.state_dict()["state"], ob.opt.state_dict()["state"]
        pairs += [(f"{tag}.{i}.{n}", sa[i][n], sb[i][n]) for i in sa
                  for n in ("exp_avg", "exp_avg_sq")]
        if oa.count != ob.count:
            raise AssertionError(f"[cli] resume: {tag} counts {oa.count} and {ob.count}")
    equal = sum(torch.equal(p, q) for _, p, q in pairs)
    errs = {n: ((p.float() - q.float()).abs().max() / p.float().abs().max().clamp_min(1e-30)
                ).item() for n, p, q in pairs if not torch.equal(p, q)}
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    if got["step"] != 4 or [h["step"] for h in got["history"]] != [2, 3]:
        raise AssertionError(f"[cli] resume ran steps {[h['step'] for h in got['history']]}")
    worst = max(errs, key=errs.get) if errs else None
    print(f"[cli] exact resume B={CLI_RESUME_BATCH} (2 steps, stop, --resume to 4, against 4 "
          f"straight; three runs in {secs:.1f} s): {equal} of {len(pairs)} tensors "
          + ("bit-equal" if not errs else
             f"bit-equal, the rest within {errs[worst]:.3e} of their max abs (worst {worst}; "
             f"tol {RESUME_TOL:g}), as ops without a deterministic CUDA kernel ran: {nondet}")
          + f"; {CARD}")
    if errs:
        _check(f"[cli] resume {worst}", errs[worst], RESUME_TOL)
    del want, got, a, b


class Clock:
    """Adds up the card time of every call of ``owner.name`` while in use
    (synchronised around each call) and the images it took (its second
    positional argument: ``InceptionV3.forward(model, x)``,
    ``VQModel.img_to_reconstructed_img(model, x)``, ``rec_perturbed(model,
    x, ...)``)."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.orig = owner, name, getattr(owner, name)
        self.secs, self.images = 0.0, 0

    def __enter__(self):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.secs += time.perf_counter() - t
            self.images += a[1].shape[0]
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _inception_clock() -> Clock:
    from imagefolder_tpu_torch.eval.inception import InceptionV3

    return Clock(InceptionV3, "forward")


def _cli_eval_card(dev, path: str, argv: list, batches: int, per_batch: dict, images: int,
                   lockstep=None) -> tuple:
    """``eval_reconstruction.main`` on the card with the counters set to 0
    just before and read just after, its time, Inception's share, its peak."""
    from imagefolder_tpu_torch.scripts import eval_reconstruction

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    rec_owner, rec_name = ((eval_reconstruction, "rec_perturbed") if "--perturb" in argv
                           else (VQModel, "img_to_reconstructed_img"))
    with _inception_clock() as incep, Clock(rec_owner, rec_name) as rec:
        run = (lambda: eval_reconstruction.main(argv))
        out = lockstep.on_card(run) if lockstep is not None else run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = check_launches(f"cli {path}", batches, per_batch)
    peak = torch.cuda.max_memory_allocated(dev)
    work = rec.secs + incep.secs
    share = (f", Inception {incep.secs * 1e3:.1f} ms ({incep.images} images: "
             f"{incep.secs / work * 100:.1f}% of the two)" if incep.images else "")
    print(f"[cli] {path}: {images} images in {secs:.2f} s of main (the model's build and load "
          f"included); the reconstructions {rec.secs * 1e3:.1f} ms ({images / rec.secs:.1f} "
          f"img/s){share}; peak {peak / 2**30:.2f} GiB "
          f"allocated; launches {dict((k, v) for k, v in launches.items() if v)}; PSNR "
          f"{out['psnr']:.4f}, SSIM {out['ssim']:.4f}"
          + "".join(f", {k} {out[k]:.4f}" for k in ("rfid", "pfid") if k in out) + f"; {CARD}")
    if not (out["images"] == images and math.isfinite(out["psnr"])
            and math.isfinite(out["ssim"])):
        raise AssertionError(f"[cli] {path}: {out['images']} images, PSNR {out['psnr']}")
    return out, {"launches": launches, "s": secs, "peak": peak, "rec_s": rec.secs,
                 "inception_s": incep.secs}


def _cli_eval(dev, root: Path, inception: Path) -> dict:
    """``eval_reconstruction.main``: on the trained checkpoint (its EMA) in
    fp32, on the card against ``device="cpu"`` over 8 val images with the
    codes in lockstep (PSNR, SSIM within 1e-4, both image sets' pool3
    within 1e-3 of their max), then with ``--perturb`` on the card over the
    32 val images (#1 36 a batch: ``encode`` and ``_branch_fhats`` each
    encode); and on MSVR10P2-4096.yaml with a weight file that
    ``hub.save_pretrained_weight`` wrote from a seeded model (#1 24, #9 20 a
    batch)."""
    from imagefolder_tpu_torch.scripts import eval_reconstruction
    from imagefolder_tpu_torch.utils import hub

    ckpt = root / "train_out" / "ckpts" / "step_00000004.pt"
    base = ["--config", str(ROBUSTTOK_YAML), "--vq_ckpt", str(ckpt), "--val_data",
            str(root / "val"), "--inception_ckpt", str(inception)]
    cmp = base + ["--batch_size", str(CLI_COMPARE_IMAGES), "--max_images",
                  str(CLI_COMPARE_IMAGES)]
    codes = _single_vq_lockstep()
    t0 = time.perf_counter()
    cpu = codes.on_cpu(lambda: eval_reconstruction.main(cmp, device="cpu"))
    cpu_secs = time.perf_counter() - t0
    vit = {"attention_qkv_fwd": 2 * VIT_DEPTH}
    card, plain = _cli_eval_card(dev, "eval_reconstruction", cmp, 1, vit, CLI_COMPARE_IMAGES,
                                 codes)
    errs = {k: abs(card[k] - cpu[k]) for k in ("psnr", "ssim")}
    feats = {k: _max_err(torch.from_numpy(card[k]), torch.from_numpy(cpu[k]))
             / float(abs(cpu[k]).max()) for k in ("feats_real", "feats_fake")}
    print(f"[cli] eval_reconstruction card vs CPU ({cpu_secs:.1f} s on the CPU), fp32, "
          f"{CLI_COMPARE_IMAGES} images: PSNR {card['psnr']:.6f} vs {cpu['psnr']:.6f}, SSIM "
          f"{card['ssim']:.6f} vs {cpu['ssim']:.6f} (tol 1e-4); pool3 of the images "
          f"{feats['feats_real']:.3e} and of the reconstructions {feats['feats_fake']:.3e} of "
          f"their max (tol 1e-3); rFID {card['rfid']:.4f} vs {cpu['rfid']:.4f}; SingleVQ codes "
          f"{codes.compared - codes.flips}/{codes.compared} equal (max near-tie gap "
          f"{codes.max_gap:.3e})")
    for k, e in errs.items():
        _check(f"[cli] eval_reconstruction {k} card vs CPU", e, 1e-4)
    for k, e in feats.items():
        _check(f"[cli] eval_reconstruction {k} card vs CPU", e, 1e-3)
    per = ["--batch_size", str(CLI_VAL_PNGS), "--perturb", "1.0", "0.1", "100"]
    _, perturbed = _cli_eval_card(dev, "eval_reconstruction --perturb", base + per, 1,
                                  {"attention_qkv_fwd": 3 * VIT_DEPTH}, CLI_VAL_PNGS)
    mcfg, _, _ = load_tokenizer_config(str(MSVR_YAML), {"dtype_str": "float32"})
    weights = hub.save_pretrained_weight(
        root / "msvr.safetensors",
        VQModel(mcfg, generator=torch.Generator().manual_seed(SEED), device="cpu"))
    _, msvr = _cli_eval_card(
        dev, "eval_reconstruction MSVR10P2-4096", ["--config", str(MSVR_YAML), "--vq_ckpt",
                                                   str(weights), "--val_data", str(root / "val"),
                                                   "--batch_size", str(CLI_VAL_PNGS)],
        1, {"attention_qkv_fwd": 2 * VIT_DEPTH, "codebook_argmin": 2 * len(PNS)}, CLI_VAL_PNGS)
    return {"cli eval_reconstruction": plain, "cli eval_reconstruction --perturb": perturbed,
            "cli eval_reconstruction MSVR10P2-4096": msvr}


def _cli_fid(dev, root: Path, inception: Path) -> dict:
    """``evaluate_fid.main`` on two seeded npz batches of 64 uint8 images
    (256 px) with the seeded Inception: the five metrics finite, precision
    and recall in [0, 1]."""
    import contextlib
    import io

    from imagefolder_tpu_torch.scripts import evaluate_fid

    import numpy as np

    g = torch.Generator().manual_seed(SEED + 7)
    for name in ("ref", "sample"):
        low = torch.rand((CLI_FID_IMAGES, 3, 8, 8), generator=g)
        img = F.interpolate(low, size=(256, 256), mode="bilinear", align_corners=False)
        np.savez(root / f"{name}.npz",
                 arr_0=(img.permute(0, 2, 3, 1) * 255).to(torch.uint8).numpy())
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with _inception_clock() as clock, contextlib.redirect_stderr(io.StringIO()) as err:
        m = evaluate_fid.main([str(root / "ref.npz"), str(root / "sample.npz"),
                               "--inception_ckpt", str(inception), "--batch_size", "64"])
    secs = time.perf_counter() - t0
    launches = check_launches("cli evaluate_fid", 1, {})
    peak = torch.cuda.max_memory_allocated(dev)
    if not (all(math.isfinite(v) for v in m.values()) and 0 <= m["precision"] <= 1
            and 0 <= m["recall"] <= 1 and "NOT been validated" in err.getvalue()):
        raise AssertionError(f"[cli] evaluate_fid metrics {m}; stderr {err.getvalue()!r}")
    n = 2 * CLI_FID_IMAGES
    print(f"[cli] evaluate_fid: {n} images in {secs:.2f} s of main, Inception "
          f"{clock.secs * 1e3:.1f} ms of it ({n / clock.secs:.1f} img/s; the rest is the npz "
          f"reads and the host's statistics: two 2048-wide sqrtm); peak "
          f"{peak / 2**30:.2f} GiB allocated; no kernel of this port launched (Inception runs "
          f"cuDNN); " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
          + f" (seeded Inception: plumbing, not numbers to report); {CARD}")
    return {"cli evaluate_fid": {"launches": launches, "s": secs, "peak": peak}}


def main_cli_paths(dev) -> dict:
    """The tokenizer's CLIs on the card from the shell's entry points
    (``main(argv)``), in a temporary directory: 128 train and 32 val PNGs
    (256 px, seed 0) and a seeded Inception ``.pth``; then
    ``train_tokenizer`` (``_cli_train``), its exact resume
    (``_cli_resume``), ``eval_reconstruction`` (``_cli_eval``) and
    ``evaluate_fid`` (``_cli_fid``)."""
    import tempfile

    from imagefolder_tpu_torch.eval.inception import InceptionV3

    with tempfile.TemporaryDirectory(prefix="imagefolder_cli_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        _write_pngs(root / "train", CLI_TRAIN_PNGS, SEED)
        _write_pngs(root / "val", CLI_VAL_PNGS, SEED + 1)
        inception = root / "pt_inception_seed0.pth"
        torch.save(InceptionV3(generator=torch.Generator().manual_seed(SEED),
                               device="cpu").state_dict(), inception)
        print(f"[cli] {CLI_TRAIN_PNGS} train and {CLI_VAL_PNGS} val PNGs and a seeded "
              f"Inception written in {time.perf_counter() - t0:.1f} s")
        paths = _cli_train(dev, root, inception)
        # checkpoints are gigabytes: keep only the one evaluated below
        for old in ("best.pt", "ckpts/step_00000002.pt"):
            (root / "train_out" / old).unlink()
        _cli_resume(dev, root)
        paths.update(_cli_eval(dev, root, inception))
        paths.update(_cli_fid(dev, root, inception))
    return paths


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
# A counter counts calls of its wrapper: a bf16 #4 call under VAR's bias is
# two kernels (the blank-tile map's pre-pass, then the forward) counted as
# one, as each call of #2, #5 and #6 is three (prep, main, dq).
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

# launches per call of the VAR paths on MSBR10P2-4096: as LAUNCHES_256, with
# no #9 (LFQ takes sign bits and searches no codebook)
LAUNCHES_MSBR = {
    "var_sample": {"fused_attention_fwd": VAR_DEPTH * len(PNS), "attention_qkv_fwd": VIT_DEPTH},
    "img_to_idxBl": {"attention_qkv_fwd": VIT_DEPTH},
    "VAR.forward": {"fused_attention_fwd": VAR_DEPTH},
    "train_step": {"attention_qkv_fwd": VIT_DEPTH, "fused_attention_fwd": VAR_DEPTH,
                   "fused_attention_bwd": VAR_DEPTH},
    "eval_step": {"attention_qkv_fwd": VIT_DEPTH, "fused_attention_fwd": VAR_DEPTH},
}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    if argv and not ((argv[0] == "times" and set(argv[1:]) <= set(TIMES))
                     or (argv[0] == "outputs" and len(argv) == 2)
                     or (argv[0] == "same" and len(argv) == 3) or argv == ["cli"]):
        raise SystemExit("usage: chip_smoke.py [outputs FILE | same FILE FILE | cli | "
                         f"times [{' '.join(TIMES)} ...]]")
    if argv[:1] == ["same"]:
        return phase_same(*argv[1:])
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
    if argv[:1] == ["outputs"]:
        phase_outputs(dev, argv[1])
        return 0
    if argv == ["cli"]:  # the CLI paths alone
        main_cli_paths(dev)
        lap("CLI paths")
        return 0
    if argv:  # the times phase alone, for the kernels named (all by default)
        times = phase_times(dev, argv[1:] or tuple(TIMES))
        print(json.dumps({"times": times}))
        return 0
    errs = {"attention_qkv_fwd": kernels_qkv(dev), "attention_qkv_bwd": kernels_qkv_bwd(dev),
            "fused_attention_fwd": kernels_bnhd(dev),
            "fused_attention_bwd": kernels_bnhd_bwd(dev),
            "fused_attention_qblk_fwd": kernels_qblk(dev),
            "fused_attention_qblk_bwd": kernels_qblk_bwd(dev),
            "codebook_argmin": kernels_codebook(dev), **kernels_sublayers(dev)}
    kernels_bwd_pieces(dev)
    kernels_hd48(dev)
    kernels_maskgit_and_narrow_heads(dev)
    kernels_wide_heads(dev)
    kernels_hd256(dev)
    lap("kernels")
    vq_models = phase_model_vq(dev)
    lap("model VQ-4096")
    phase_model_rar(dev, *vq_models)
    del vq_models
    phase_model_rar_train(dev)
    lap("model RAR-B")
    phase_model_rar_xl(dev)
    lap("model RAR-XL width")
    phase_model_maskgit(dev)
    phase_model_maskgit_train(dev)
    phase_model_rar_trainer(dev)
    lap("model MaskGIT-B and the trainers")
    for margs, name, depth, cut in (
            (msvr_margs, "MSVR10P2-4096 + VAR-d16", VAR_DEPTH, contextlib.nullcontext),
            (msvr512_margs, "MSVR10P2-4096-512 (4 ViT blocks) + VAR (4 blocks)",
             CHECK_VAR_DEPTH_512, check_depth_cut)):
        with cut():
            phase_model_train(dev, *phase_model_var(dev, margs("float32"), name,
                                                    var_depth=depth), name)
        lap(f"model {name}")
    phase_model_gan(dev)
    lap("model GAN step")
    with check_depth_cut():
        phase_model_disc_types(dev, phase_model_robusttok(dev))
    lap("model RobustTok step and disc types (4 ViT blocks, DinoDisc 6)")
    with check_depth_cut():
        phase_model_msbr(dev)
    lap("model MSBR (BSQ) with VAR-d16, MSBR step (4 ViT blocks)")
    with check_depth_cut():
        phase_model_variants(dev)
    lap("model LoRA, latent pos, conv and siren heads, CNN (4 ViT blocks)")
    paths = {**main_round_trip(dev), **main_rar_paths(dev), **main_rar_train(dev),
             **main_rar_xl_train(dev), **main_mlp_probe(dev)}
    lap("round trips, RAR sampling and training (RAR-B, RAR-XL width), MLP probe")
    paths.update({**main_maskgit_paths(dev), **main_rar_train_step(dev)})
    lap("MaskGIT sampling and training, RAR train step")
    paths.update({**main_var_paths(dev, msvr_margs("bfloat16"), "", LAUNCHES_256,
                                   bench_sample_margs("bfloat16")),
                  **main_train_paths(dev, msvr_margs("bfloat16"), "", LAUNCHES_256),
                  **main_gan_paths(dev)})
    lap("main paths at 256 px")
    paths.update(main_robusttok_paths(dev))
    lap("RobustTok train step")
    paths.update(main_msbr_paths(dev))
    lap("MSBR (BSQ) paths with VAR-d16")
    paths.update(main_variant_paths(dev))
    lap("LoRA, latent pos, conv and siren heads, CNN paths")
    paths.update({**main_var_paths(dev, msvr512_margs("bfloat16"), "512 ", LAUNCHES_512),
                  **main_train_paths(dev, msvr512_margs("bfloat16"), "512 ", LAUNCHES_512,
                                     TRAIN_BATCH_512)})
    lap("main paths at 512 px")
    paths.update(main_cli_paths(dev))
    lap("CLI paths: train_tokenizer, its resume, eval_reconstruction, evaluate_fid")
    times = phase_times(dev)
    for key, (name, label) in SHAPE_TIMES.items():
        times[name].setdefault("shapes", {})[label] = times.pop(key)
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
    sys.exit(main(sys.argv[1:]))
