"""Where the device time of the port's VAR paths goes, on one NVIDIA GPU.

    python3 chip_profile.py    # from the repository root; needs one CUDA card

Builds MSVR10P2-4096 + VAR-d16 in bf16 at B=64 from seeded random weights
(the configuration ``chip_smoke.py`` times), and for each of ``var_sample``
(cfg 1.5, top-k 900, top-p 0.96), ``img_to_idxBl`` and ``VAR.forward``
runs one warm-up call, then two calls under ``torch.profiler``. Prints, per
path and per call: the host wall time (ending in a synchronize), the device
busy time (the sum of the CUDA kernels' times; one stream, so they never
overlap), the idle share, and the device time by kind of kernel, then the
ten largest kernels by name.
"""

from __future__ import annotations

import collections
import re
import sys
import time

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from chip_smoke import BATCH, SEED, VAR_DEPTH, msvr_margs
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.train import var_train

CALLS = 2
# kernel name pattern -> kind, first match wins
KINDS = [
    (r"attn_bnhd", "#3 BNHD attention kernel"),
    (r"attn_qkv", "#1 packed-qkv attention kernel"),
    (r"codebook_argmin", "#9 codebook kernel"),
    (r"nvjet|gemm|cutlass|sm90_xmma|cublas", "GEMMs (cuBLAS)"),
    (r"sort|radix|topk|Topk|scan|cumsum|searchsorted", "sort, top-k, scan (sampling filter)"),
    (r"layer_norm|LayerNorm", "LayerNorm"),
    (r"softmax|Softmax", "softmax"),
    (r"gelu|GeluCUDA", "GELU"),
    (r"copy_|direct_copy|CatArrayBatched|cat_", "copies, casts and concatenations"),
    (r"reduce_kernel|Reduce", "reductions (norms, max, argmax)"),
    (r"elementwise|vectorized|unrolled", "other elementwise (add, mul, exp, where, ...)"),
    (r"index|gather|scatter|embedding", "gathers and scatters"),
]


def kind(name: str) -> str:
    for pat, k in KINDS:
        if re.search(pat, name):
            return k
    return "other"


def profile_path(name: str, fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / CALLS * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / CALLS / 1e3
    if busy <= 0:
        raise AssertionError(f"[{name}] the profiler saw no device time")
    by_kind = collections.Counter()
    counts = collections.Counter()
    for e in kernels:
        by_kind[kind(e.key)] += e.device_time_total / CALLS / 1e3
        counts[kind(e.key)] += e.count // CALLS
    print(f"[{name}] B={BATCH} bf16, per call: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for k, ms in by_kind.most_common():
        print(f"[{name}]   {ms:9.3f} ms {ms / busy * 100:5.1f}%  x{counts[k]:<6d} {k}")
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:10]
    for e in top:
        print(f"[{name}]     {e.device_time_total / CALLS / 1e3:9.3f} ms x{e.count // CALLS:<5d} "
              f"{e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    margs = msvr_margs("bfloat16")
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    vae.eval()
    var.eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.arange(BATCH, device=dev) % 1000
    px = margs.image_size
    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    profile_path("var_sample", lambda: var_train.var_sample(
        var, vae, labels, gen, cfg_scale=1.5, top_k=900, top_p=0.96))
    with torch.inference_mode():
        profile_path("img_to_idxBl", lambda: vae.img_to_idxBl(x))
        x_in = vae.idxBl_to_var_input(vae.img_to_idxBl(x))
        profile_path("VAR.forward", lambda: var(labels, x_in))
    return 0


if __name__ == "__main__":
    sys.exit(main())
