"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, each printing one line of what it found (any failure ends the run with
a non-zero exit):
  1. device: the card's name and power limit, as nvidia-smi gives them;
  2. build: compile ``imagefolder_tpu_torch/csrc/*.cu`` (into the gitignored
     ``imagefolder_tpu_torch/_build/``) and load it;
  3. kernels: the packed-qkv attention kernel against its plain PyTorch version
     on the card, at the main path's shapes, a ragged and two masked shapes;
  4. model: the full-width VQ-4096 ViT-B tokenizer at B=2 in fp32, card against
     CPU, from one seed;
  5. main path: ``img_to_reconstructed_img`` at B=64 in bf16, timed with CUDA
     events, and ``encode_to_tokens`` -> ``decode_tokens``; the attention
     kernel must launch 24 times per round trip;
  6. times: the kernel and its plain version at the decoder's shape.
Then one JSON line per kernel record and, last, the device JSON line.

Imports nothing of JAX: the card's machine has none. JAX parity lives in the
CPU tests (tests/test_torch_*.py).
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.vit import LayerScale
from imagefolder_tpu_torch.ops.cuda import _build
from imagefolder_tpu_torch.ops.cuda import attention as attn

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
ITERS = 20
HEADS = 12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
# card vs CPU, fp32 throughout: only summation order differs, compounded over
# 24 blocks of width 768 with LayerScale raised to O(1)
MODEL_TOL = 1e-3
NEAR_TIE = 1e-5


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


def encoder_mask(n: int, nl: int, device, block_first: int = 0) -> torch.Tensor:
    """The encoder's shared use_attn_mask bias: rows before the last nl cannot
    attend to the last nl columns. block_first > 0 also keeps the last nl rows
    from the first block_first columns, so that their first k/v tiles are
    all -inf."""
    idx = torch.arange(n, device=device)
    blocked = (idx[:, None] < n - nl) & (idx[None, :] >= n - nl)
    blocked |= (idx[:, None] >= n - nl) & (idx[None, :] < block_first)
    return torch.zeros(n, n, device=device).masked_fill(blocked, float("-inf"))[None, None]


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


def phase_kernels(dev) -> float:
    """Kernel vs plain version on the card; returns the largest bf16 error at
    the main path's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("encoder", (64, 513), bf16, None),
        ("decoder", (64, 514), bf16, None),
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
        qkv = torch.randn((b, n, 3 * 64 * HEADS), generator=gen, device=dev).to(dtype)
        got = attn.attention_qkv(qkv, HEADS, bias)
        want = attn.attention_qkv_reference(qkv, HEADS, bias)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
            raise AssertionError(f"[kernels] {name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        print(f"[kernels] {name:26s} qkv {tuple(qkv.shape)} {str(dtype)[6:]:8s} "
              f"bias={'shared' if bias is not None else 'none':6s} "
              f"max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"[kernels] {name}: max abs err {err} > {tol}")
        if dtype == bf16 and name in ("encoder", "decoder"):
            main_err = max(main_err, err)
    return main_err


def _excite_layerscale(model: torch.nn.Module, gen: torch.Generator):
    """LayerScale starts at 1e-5, which leaves every block (and its attention)
    out of the output; raise it so that the comparison sees them."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerScale):
                mod.gamma.uniform_(0.5, 1.0, generator=gen)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.detach().float().cpu() - b.detach().float().cpu()).abs().max().item()


def phase_model(dev):
    """Full-width fp32 model, card against the same weights on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_margs("float32")
    gen = torch.Generator().manual_seed(SEED)
    cpu = VQModel(cfg, generator=gen).eval()
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
    print(f"[model] fp32 B=2 card vs CPU: {shown} (tol {MODEL_TOL:g}); tokens "
          f"{tok_cpu.numel() - diff.shape[0]}/{tok_cpu.numel()} equal, "
          f"{torch.unique(tok_cpu).numel()} distinct")
    for k, v in errs.items():
        if not v <= MODEL_TOL:
            raise AssertionError(f"[model] {k}: max abs err {v} > {MODEL_TOL}")


def phase_main_path(dev) -> dict:
    cfg = bench_margs("bfloat16")
    px, nl, vocab = cfg.image_size, cfg.num_latent_tokens, cfg.codebook_size
    model = VQModel(cfg, generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    per_call = len(model.encoder.model.blocks) + len(model.decoder.model.blocks)  # 24
    calls = 0
    attn.LAUNCHES = 0
    with torch.inference_mode():
        for _ in range(2):  # warm-up
            y = model.img_to_reconstructed_img(x)
            calls += 1
            torch.cuda.synchronize()
            if attn.LAUNCHES != per_call * calls:
                raise AssertionError(f"[main] {attn.LAUNCHES} attention launches "
                                     f"after {calls} round trips, want {per_call * calls}")
        torch.cuda.reset_peak_memory_stats(dev)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(ITERS + 1)]
        events[0].record()
        for i in range(ITERS):
            y = model.img_to_reconstructed_img(x)
            events[i + 1].record()
        torch.cuda.synchronize()
        calls += ITERS
        per_iter = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        ms = statistics.median(per_iter)
        peak = torch.cuda.max_memory_allocated(dev)
        tokens = model.encode_to_tokens(x)
        rec = model.decode_tokens(tokens)
        torch.cuda.synchronize()
    launches = attn.LAUNCHES
    if launches != per_call * (calls + 1):
        raise AssertionError(f"[main] {launches} attention launches, want {per_call * (calls + 1)}")
    if tuple(y.shape) != (BATCH, px, px, 3) or y.dtype != torch.float32:
        raise AssertionError(f"[main] output {tuple(y.shape)} {y.dtype}")
    if not (bool(torch.isfinite(y).all()) and y.abs().max().item() <= 1.0):
        raise AssertionError("[main] output not finite or outside [-1, 1]")
    if tuple(tokens.shape) != (BATCH, nl) or not (
            0 <= tokens.min().item() and tokens.max().item() < vocab):
        raise AssertionError(f"[main] tokens {tuple(tokens.shape)} "
                             f"in [{tokens.min().item()}, {tokens.max().item()}]")
    if tuple(rec.shape) != (BATCH, px, px, 3) or not bool(torch.isfinite(rec).all()):
        raise AssertionError("[main] decode_tokens output malformed")
    print(f"[main] img_to_reconstructed_img B={BATCH} bf16: median {ms:.3f} ms/batch "
          f"(min {per_iter[0]:.3f}, max {per_iter[-1]:.3f}, {ITERS} iters), "
          f"{BATCH / ms * 1e3:.1f} img/s; peak "
          f"{peak / 2**30:.2f} GiB allocated; {launches} attention launches in "
          f"{calls + 1} round trips ({per_call} each); tokens {tuple(tokens.shape)} in "
          f"[{tokens.min().item()}, {tokens.max().item()}], "
          f"{torch.unique(tokens).numel()} distinct")
    return {"ms": ms, "launches": launches}


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


def phase_times(dev) -> tuple[float, float]:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    qkv = torch.randn((64, 514, 3 * 64 * HEADS), generator=gen, device=dev).bfloat16()
    kernel = lambda: attn.attention_qkv(qkv, HEADS)  # noqa: E731
    plain = lambda: attn.attention_qkv_reference(qkv, HEADS)  # noqa: E731
    with torch.inference_mode():
        p1, k1, k2, p2 = _time_ms(plain), _time_ms(kernel), _time_ms(kernel), _time_ms(plain)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    flops = 4 * 64 * HEADS * 514 * 514 * 64
    print(f"[times] attention qkv (64, 514, 2304) bf16: kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms (order plain, kernel, kernel, plain); "
          f"kernel {flops / k_ms / 1e9:.1f} TFLOP/s")
    return k_ms, p_ms


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device()
    phase_build()
    main_err = phase_kernels(dev)
    phase_model(dev)
    main = phase_main_path(dev)
    k_ms, p_ms = phase_times(dev)
    print(json.dumps({"kernels": [{
        "name": "attention_qkv_fwd", "route": "cuda",
        "source": "imagefolder_tpu_torch/csrc/attention_qkv.cu",
        "replaces": "imagefolder_tpu/ops/pallas/attention.py:93",
        "launches": main["launches"], "max_abs_err": main_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
