"""Where the device time of the port's round trip, RAR and VAR paths and of
the flagship GAN training step goes, on one NVIDIA GPU.

    python3 chip_profile.py [rar] [var] [gan] [gemm]   # from the repository root; one CUDA card

Runs the sections named (all four by default). ``rar``: the VQ-4096 round
trip composed and with the fused sublayers (#7, #8), RAR sampling at B=64
(RAR-B ``rar_generate`` with CFG and the fused RobustTok decode) and the RAR
generator alone, each by kind of kernel. ``var``: builds MSVR10P2-4096 +
VAR-d16 in bf16 at B=64 from seeded random weights (the configuration
``chip_smoke.py`` times), and for each of ``var_sample`` (cfg 1.5, top-k
900, top-p 0.96; decoded by bench.py's ViT-S sample-leg tokenizer),
``img_to_idxBl``, ``VAR.forward``,
``VARTrainer.train_step`` and ``VARTrainer.eval_step`` (``VARTrainConfig()``
defaults) runs one warm-up call, then two calls under ``torch.profiler``.
Prints, per path and per call: the host wall time (ending in a
synchronize), the device busy time (the sum of the CUDA kernels' times; one
stream, so they never overlap), the idle share, and the device time by kind
of kernel, then the ten largest kernels by name. The train step is then
profiled once more cut into its phases (encode, forward and loss, backward,
optimizer), with a synchronize after each, and each kernel's time is put to
the phase whose host range holds its start: that split tells the backward's
GEMMs and elementwise passes from the forward's. The same again for
MSVR10P2-4096-512 + VAR-d16 (512 px, L = 2240; ``chip_smoke.py``'s 512 px
paths: the round trip as well, and the train step at B=16). The idle share
printed here is against the profiled wall time, which the profiler itself
stretches; ``PERF.md`` takes the busy time against ``chip_smoke.py``'s
event-timed median.

``gemm``: the VQ-4096 round trip composed and fused, each GEMM's device
time per call: the fused sublayers' ``gemm_sm90_kernel`` instantiations by
name beside cuBLAS's products (``aten::mm`` / ``aten::addmm``) by shape.

``gan``: the flagship GAN ``TokenizerTrainer.train_step`` at B=64 with a bf16
loss stack (the configuration ``chip_smoke.py`` times): the whole step by
kind of kernel, and the step once more cut into its phases (encode,
quantize, decode, teacher, LPIPS, DinoDisc in the generator pass, adaptive
weight, backward, generator optimizer and EMA, disc pass, disc optimizer,
bookkeeping). The phases are the step's own modules and calls in its order
(``gan_phases``); their total beside the whole step's busy time shows that
they cover it.

The kernels that share device code (#1, #4 and #7's attention,
``attn_fwd_*``; #2, #5 and #6, ``attn_bwd_*``; the GEMMs of #7, #8 and #10,
``gemm_*``) carry the kernel's number as their first template argument
(``attn_fwd_onepass_kernel<4, ...>``, ``gemm_sm90_kernel<8, 1, 256>``), and each
is counted under its own number: the bf16 backward of #2, #5 and #6 is three
kernels (``attn_bwd_prep_kernel``, ``attn_bwd_sm90_kernel``,
``attn_bwd_dq_kernel``), all counted under the backward's number; #4 under a
bias is the blank-tile map's pre-pass (``attn_bwd_prep_kernel<4>``) and the
forward, both counted under #4; #1, #4 and #7 are
``attn_fwd_onepass_kernel`` in bf16 and ``attn_fwd_f32_kernel`` in fp32; #3
is ``attn_fwd_sm90_kernel<3, ...>`` in bf16 and ``attn_bnhd_f32_kernel`` in
fp32.
"""

from __future__ import annotations

import collections
import re
import sys
import time

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile, record_function

from chip_smoke import (
    BATCH,
    RAR_SAMPLING,
    SEED,
    TRAIN_BATCH_512,
    VAR_DEPTH,
    _excite_adaln,
    bench_margs,
    bench_sample_margs,
    msvr512_margs,
    msvr_margs,
)
from imagefolder_tpu_torch.losses.discriminators import draw_crop
from imagefolder_tpu_torch.losses.gan import (
    LeCamState,
    adaptive_disc_weight,
    lecam_reg,
    lecam_update,
)
from imagefolder_tpu_torch.models import build_rar, build_vae_var
from imagefolder_tpu_torch.models.rar import rar_generate
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.models.vit import set_fused_sublayers
from imagefolder_tpu_torch.models.tokenizer import _orthogonal_cosine_loss
from imagefolder_tpu_torch.ops.quantize import update_usage_ema, usage_percent
from imagefolder_tpu_torch.train import var_train
from imagefolder_tpu_torch.train.optim import ema_update
from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer

CALLS = 2
# kernel name pattern -> kind, first match wins
KINDS = [
    (r"gemm_\w+<7\b|attn_fwd_\w+<7\b", "#7 fused attention sublayer (GEMMs, #1's tile)"),
    (r"gemm_\w+<8\b", "#8 fused MLP sublayer (GEMMs)"),
    (r"gemm_\w+<10\b", "#10 fused MLP probe (GEMMs)"),
    (r"attn_bwd_\w+<2\b", "#2 packed-qkv attention backward kernels (prep, main, dq)"),
    (r"attn_bwd_\w+<5\b", "#5 q-blocked attention backward kernels (prep, main, dq)"),
    (r"attn_bwd_\w+<6\b", "#6 BNHD attention backward kernels"),
    (r"attn_fwd_sm90_\w*<3\b|attn_bnhd", "#3 BNHD attention kernel"),
    (r"attn_fwd_\w+<1\b", "#1 packed-qkv attention kernel"),
    (r"attn_fwd_\w+<4\b|attn_bwd_\w+<4\b",
     "#4 q-blocked attention kernel (and its map pre-pass)"),
    (r"codebook_argmin", "#9 codebook kernel"),
    (r"conv|cudnn|fprop|dgrad|wgrad|implicit", "convolutions (cuDNN: LPIPS's VGG16, blur)"),
    (r"nvjet|gemm|cutlass|sm90_xmma|cublas", "GEMMs (cuBLAS)"),
    (r"sort|radix|topk|Topk|scan|cumsum|searchsorted", "sort, top-k, scan (sampling filter)"),
    (r"layer_norm|LayerNorm", "LayerNorm"),
    (r"softmax|Softmax", "softmax"),
    (r"gelu|GeluCUDA", "GELU"),
    (r"copy_|direct_copy|CatArrayBatched|cat_", "copies, casts and concatenations"),
    (r"reduce_kernel|Reduce", "reductions (norms, max, argmax)"),
    (r"elementwise|vectorized|unrolled", "other elementwise (add, mul, exp, where, ...)"),
    (r"multi_tensor_apply", "optimizer (multi-tensor AdamW, clip)"),
    (r"index|gather|scatter|embedding", "gathers and scatters"),
    (r"pool", "max-pool"),
]


def kind(name: str) -> str:
    for pat, k in KINDS:
        if re.search(pat, name):
            return k
    return "other"


def _is_kernel(e) -> bool:
    """A kernel's device time, not a user annotation: record_function
    ranges (ours, and torch.optim's ``Optimizer.step#...``) also appear on
    the device's timeline, spanning the kernels they hold."""
    return (e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False))


def _device_kernels(prof):
    return [e for e in prof.key_averages() if _is_kernel(e)]


def profile_path(name: str, fn, batch: int = BATCH):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / CALLS * 1e3
    kernels = _device_kernels(prof)
    busy = sum(e.device_time_total for e in kernels) / CALLS / 1e3
    if busy <= 0:
        raise AssertionError(f"[{name}] the profiler saw no device time")
    by_kind = collections.Counter()
    counts = collections.Counter()
    for e in kernels:
        by_kind[kind(e.key)] += e.device_time_total / CALLS / 1e3
        counts[kind(e.key)] += e.count // CALLS
    print(f"[{name}] B={batch} bf16, per call: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for k, ms in by_kind.most_common():
        print(f"[{name}]   {ms:9.3f} ms {ms / busy * 100:5.1f}%  x{counts[k]:<6d} {k}")
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:10]
    for e in top:
        print(f"[{name}]     {e.device_time_total / CALLS / 1e3:9.3f} ms x{e.count // CALLS:<5d} "
              f"{e.key[:110]}")


def profile_phases(name: str, phases):
    """``phases``: (label, fn) run in order per call, each in a profiler
    range ending in a synchronize; every kernel goes to the range that holds
    its start (host and device events share the profiler's clock)."""
    def run():
        for label, fn in phases:
            with record_function(f"phase:{label}"):
                fn()
                torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            run()
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[6:]) for e in events
              if e.name.startswith("phase:") and e.device_type == DeviceType.CPU]
    by_phase = {label: collections.Counter() for label, _ in phases}
    lost = 0.0
    for e in events:
        if not _is_kernel(e):
            continue
        ms = e.device_time_total / CALLS / 1e3
        owner = next((lab for a, b, lab in ranges if a <= e.time_range.start < b), None)
        if owner is None:
            lost += ms
        else:
            by_phase[owner][kind(e.name)] += ms
    total = sum(sum(c.values()) for c in by_phase.values())
    print(f"[{name}] per call, device time by phase: {total:.3f} ms put to a phase, "
          f"{lost:.3f} ms outside every phase")
    for label, c in by_phase.items():
        ms = sum(c.values())
        print(f"[{name}]   {label}: {ms:.3f} ms ({ms / max(total, 1e-9) * 100:.1f}%)")
        for k, v in c.most_common(6):
            print(f"[{name}]       {v:9.3f} ms  {k}")


def gan_phases(tr: TokenizerTrainer, x: torch.Tensor) -> list:
    """``TokenizerTrainer.train_step`` as (label, fn) phases, with the
    step's own modules and calls in its order (``VQModel.forward`` opened up
    into encode, quantize, decode and teacher)."""
    m, tcfg, cfg = tr.model, tr.tcfg, tr.model_cfg
    b, dev, s = x.shape[0], x.device, {}

    def encode():
        s["h"] = m.encode(x)

    def quantize():
        sn = len(cfg.v_patch_nums)
        dropout_n = torch.randint(cfg.start_drop, sn + 1, (b,), generator=tr.rng, device=dev)
        s["outs"] = [qz(s["h"][:, i], dropout_n=dropout_n, train=True)
                     for i, qz in enumerate(m.quantizers)]
        ql = [o.f_hat for o in s["outs"]]
        s["dep"] = cfg.dependency_loss_weight * _orthogonal_cosine_loss(
            ql[0].mean(dim=(1, 2)), ql[-1].mean(dim=(1, 2)))

    def decode():
        dec, _ = m.decode(torch.cat([o.f_hat for o in s["outs"]], dim=-1), return_prelast=True)
        s["dec"] = dec.float()
        s["rec"] = (x - s["dec"]).square().mean()

    def teacher():
        with torch.no_grad():
            tokens = m.semantic_model(m._teacher_input(x))
        z_s = m.quant_conv(tokens[:, 0] if cfg.guide_type_1 == "class"
                           else tokens[:, 1:].mean(dim=1))
        n_drop = int(b * cfg.codebook_drop)
        z_q = s["outs"][-1].f_hat.mean(dim=(1, 2))
        s["sem"] = m._guide_loss(z_s[n_drop:], z_q[n_drop:], cfg.sem_loss_scale,
                                 0) * cfg.sem_loss_weight

    def lpips():
        s["perc"] = tr.lpips(x, s["dec"]).mean()

    def disc_generator_pass():
        s["crop"] = draw_crop(x.shape[1], tr.rng, dev)
        s["g_adv"] = tr.g_loss(tr.disc(tr._aug(s["dec"], 0.0, None), s["crop"]))

    def adaptive_weight():
        s["nll"] = tcfg.rec_weight * s["rec"] + tcfg.perceptual_weight * s["perc"]
        w_last = m.last_layer
        g_nll, = torch.autograd.grad(s["nll"], w_last, retain_graph=True)
        g_g, = torch.autograd.grad(s["g_adv"], w_last, retain_graph=True)
        s["d_weight"] = adaptive_disc_weight(g_nll, g_g)

    def backward():
        outs, p = s["outs"], cfg.product_quant
        loss = (s["nll"] + s["d_weight"] * tcfg.disc_weight * s["g_adv"]
                + tcfg.codebook_weight * (sum(o.vq_loss for o in outs) / p
                                          + sum(o.commit_loss for o in outs) / p)
                + s["sem"] + s["dep"])
        tr.gen_opt.zero_grad()
        torch.autograd.backward(loss, inputs=tr.gen_opt.params)

    def generator_optimizer():
        tr.gen_opt.step()
        ema_update(tr.ema_params, list(m.parameters()), tcfg.ema_decay)

    def disc_pass():
        dec = s.pop("dec").detach()
        lf = tr.disc(tr._aug(dec, 0.0, None), s["crop"], update_stats=True)
        lr = tr.disc(tr._aug(x, 0.0, None), s["crop"], update_stats=True)
        new = LeCamState(*(t.detach() for t in lecam_update(tr.lecam, lr, lf)))
        d_loss = tcfg.disc_weight * (lecam_reg(lr, lf, new) * tcfg.lecam_loss_weight
                                     + tr.d_loss(lr, lf))
        tr.disc_opt.zero_grad()
        d_loss.backward()
        tr.lecam = new

    def bookkeeping():
        hits = torch.stack([o.hits_SV for o in s.pop("outs")])
        tr.usage_ema, tr.record_hit = update_usage_ema(tr.usage_ema, hits, tr.record_hit)
        usage_percent(tr.usage_ema, float(b * cfg.num_latent_tokens), cfg.codebook_size)

    return [("encode", encode), ("quantize", quantize), ("decode", decode),
            ("teacher", teacher), ("LPIPS", lpips),
            ("DinoDisc, generator pass", disc_generator_pass),
            ("adaptive weight", adaptive_weight), ("backward", backward),
            ("generator optimizer and EMA", generator_optimizer), ("disc pass", disc_pass),
            ("disc optimizer", tr.disc_opt.step), ("bookkeeping", bookkeeping)]


def profile_rar(dev):
    """The VQ-4096 round trip composed and with the fused sublayers (#7,
    #8), RAR sampling at B=64 (``rar_generate`` with CFG and the fused
    RobustTok decode, as ``chip_smoke.py``'s ``rar sample``), and the RAR
    generator alone."""
    margs = bench_margs("bfloat16")
    vae = VQModel(margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, margs.image_size, margs.image_size, 3), generator=gen,
                   device=dev) * 2 - 1
    with torch.inference_mode():
        profile_path("round trip", lambda: vae.img_to_reconstructed_img(x))
        set_fused_sublayers(vae, True, True)
        profile_path("round trip fused", lambda: vae.img_to_reconstructed_img(x))
        g = torch.Generator().manual_seed(SEED + 11)
        rar = build_rar(margs, dtype_str="bfloat16", generator=g, device="cpu").eval()
        _excite_adaln(rar, g)
        rar.to(dev)
        labels = torch.arange(BATCH, device=dev) % 1000

        def generate():
            return rar_generate(rar, labels, gen, cache_dtype=torch.bfloat16, **RAR_SAMPLING)

        profile_path("rar sample", lambda: vae.decode_tokens(generate()))
        profile_path("rar generate", generate)


def gemm_times(prof) -> dict:
    """Device ms per call of each GEMM in a profile: the sublayers' own
    (``gemm_sm90_kernel<kId, kEpi, BN, ...>`` by name) and PyTorch's
    (``aten::mm`` and ``aten::addmm`` by their operands' shapes, (M, K) x
    (K, N); cuBLAS's kernels run inside them), each as (ms, launches)."""
    out = {}
    for e in _device_kernels(prof):
        if re.search(r"gemm_sm90_kernel<", e.key):
            name = re.search(r"gemm_sm90_kernel<[^>]*>", e.key).group(0)
            ms, cnt = out.get(name, (0.0, 0))
            out[name] = (ms + e.device_time_total / CALLS / 1e3, cnt + e.count // CALLS)
    for e in prof.events():
        if e.name in ("aten::mm", "aten::addmm") and e.input_shapes:
            shapes = [tuple(sh) for sh in e.input_shapes if len(sh) == 2]
            key = f"{e.name} {' x '.join(map(str, shapes[-2:]))}"
            ms, cnt = out.get(key, (0.0, 0))
            out[key] = (ms + e.device_time_total / CALLS / 1e3, cnt + 1 / CALLS)
    return out


def profile_gemm(dev):
    """The VQ-4096 round trip (B=64 bf16) composed and with the fused
    sublayers: each product's device time per call, the sublayers' GEMM
    instantiations (qkv kDense and proj kDenseLsRes of #7, fc1 kDenseGelu
    and fc2 kDenseLsRes of #8; encoder M = 32832 and decoder M = 32896
    together) beside cuBLAS's for the same products in the composed path."""
    margs = bench_margs("bfloat16")
    vae = VQModel(margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, margs.image_size, margs.image_size, 3), generator=gen,
                   device=dev) * 2 - 1
    with torch.inference_mode():
        for tag in ("composed", "fused"):
            if tag == "fused":
                set_fused_sublayers(vae, True, True)
            vae.img_to_reconstructed_img(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                for _ in range(CALLS):
                    vae.img_to_reconstructed_img(x)
                torch.cuda.synchronize()
            for key, (ms, cnt) in sorted(gemm_times(prof).items(), key=lambda kv: -kv[1][0]):
                print(f"[gemm round trip {tag}] {ms:9.3f} ms x{cnt:<5g} {key}")


def profile_var(dev, margs, tag: str, train_batch: int, round_trip: bool, sample_margs=None):
    """The VAR paths of ``margs`` + VAR-d16 (B=64, the train step at
    ``train_batch``), each by kind, and the train step by phase;
    ``var_sample`` decodes through a tokenizer of ``sample_margs`` when
    given, as ``chip_smoke.py`` times it."""
    vae, var = build_vae_var(margs, VAR_DEPTH, dtype_str="bfloat16",
                             generator=torch.Generator().manual_seed(SEED), device=dev)
    vae.eval()
    var.eval()
    sample_vae = vae if sample_margs is None else VQModel(
        sample_margs, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.arange(BATCH, device=dev) % 1000
    px = margs.image_size
    x = torch.rand((BATCH, px, px, 3), generator=gen, device=dev) * 2 - 1
    if round_trip:
        with torch.inference_mode():
            profile_path(tag + "round trip", lambda: vae.img_to_reconstructed_img(x))
    profile_path(tag + "var_sample", lambda: var_train.var_sample(
        var, sample_vae, labels, gen, cfg_scale=1.5, top_k=900, top_p=0.96))
    del sample_vae
    with torch.inference_mode():
        profile_path(tag + "img_to_idxBl", lambda: vae.img_to_idxBl(x))
        x_in = vae.idxBl_to_var_input(vae.img_to_idxBl(x))
        profile_path(tag + "VAR.forward", lambda: var(labels, x_in))
        del x_in

    tr = var_train.VARTrainer(vae, var, var_train.VARTrainConfig(), generator=gen)
    xt, lt = x[:train_batch], labels[:train_batch]
    profile_path(tag + "train_step", lambda: tr.train_step(xt, lt), train_batch)
    profile_path(tag + "eval_step", lambda: tr.eval_step(x, labels))
    step = {}

    def encode():
        step["gt"], step["x_in"] = tr._codes(xt)

    def forward():
        tr.opt.zero_grad()
        var.train()
        logits = var(lt, step["x_in"], train=True, generator=gen)
        step["loss"] = tr._ce_and_acc(logits, step["gt"])[0]

    profile_phases(tag + "train_step", [("encode", encode), ("forward and loss", forward),
                                        ("backward", lambda: step.pop("loss").backward()),
                                        ("optimizer", tr.opt.step)])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py needs a CUDA card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    sections = set(sys.argv[1:]) or {"rar", "var", "gan", "gemm"}
    if not sections <= {"rar", "var", "gan", "gemm"}:
        raise SystemExit(f"sections are rar, var, gan and gemm; got {sorted(sections)}")
    if "gemm" in sections:
        profile_gemm(dev)
    if "rar" in sections:
        profile_rar(dev)
    if "var" in sections:
        profile_var(dev, msvr_margs("bfloat16"), "", BATCH, round_trip=False,
                    sample_margs=bench_sample_margs("bfloat16"))
        profile_var(dev, msvr512_margs("bfloat16"), "512 ", TRAIN_BATCH_512, round_trip=True)
    if "gan" not in sections:
        return 0
    gen = torch.Generator(device=dev).manual_seed(SEED)

    mcfg, tcfg = flagship_gan_recipe(BATCH, tcfg_overrides={"loss_dtype": "bfloat16"})
    gan = TokenizerTrainer(mcfg, tcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    x = torch.rand((BATCH, mcfg.image_size, mcfg.image_size, 3), generator=gen,
                   device=dev) * 2 - 1
    profile_path("GAN train_step", lambda: gan.train_step(x))
    profile_phases("GAN train_step", gan_phases(gan, x))
    return 0


if __name__ == "__main__":
    sys.exit(main())
