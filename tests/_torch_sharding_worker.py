"""Worker for the sharded-step tests of the port (test_torch_sharding.py):
the counterparts of tests/test_sharding.py's four tests, and the tensor
parallelism of the tokenizer's ViTs, RAR and MaskGIT, the RAR and MaskGIT
trainers under FSDP2 and TP, and gradient accumulation over FSDP2.

Run as: python tests/_torch_sharding_worker.py <host:port> <num_procs> <rank> <out_dir>

With four processes each joins a gloo group and runs every case on its
mesh (2 x 2 data x fsdp or data x model, or a data axis of 4), taking its
data shard's rows of the case's global batch (``shard_batch``); with one
process it runs the same cases unsharded on the whole batch. Every tensor
a case's steps leave (parameters, buffers, gradients, Adam's moments, the
EMA, the usage and LeCam EMAs, the metrics) is gathered whole
(``full_tensor``) and saved to ``<out_dir>/<case>_<num_procs>_<rank>.pt``,
with the placements and, for the GAN step, its layout after the step.
"""

import sys
from pathlib import Path

import numpy as np
import torch

B = 8  # the global batch of every case, as in tests/test_sharding.py
VAR_STEPS = 2  # VAR's first lr is not 0: the second step starts from moved parameters
# RAR's and MaskGIT's steps: the first lr is 0, the second moves the
# parameters. ImageBert's qkv bias has a key third whose gradient is 0 in
# exact arithmetic, and Adam's second step magnifies its fp32 reorderings
# past 1e-6 (test_torch_maskgit.py holds it to a floor): one step there
GEN_STEPS = {"rar": 2, "maskgit_bert": 1, "maskgit_uvit": 2}
ACCUM_MICRO = 4  # two updates of grad_accum_steps=2
# the tokenizer's ViTs at a tiny width with heads that split over 2 ranks
TINY_VIT = "tiny_tp_vit"
TINY_VIT_PRESET = dict(embed_dim=64, depth=2, num_heads=4)
GEN = dict(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=4, num_classes=10,
           device="cpu")


def _cnn_margs(**kw):
    from imagefolder_tpu_torch.models.tokenizer import ModelArgs

    return ModelArgs(codebook_size=32, codebook_embed_dim=8, encoder_ch_mult=(1, 2),
                     decoder_ch_mult=(1, 2), z_channels=32, enc_type="cnn", dec_type="cnn",
                     semantic_guide="none", detail_guide="none", **kw)


def _state(prefix: str, module, opt, ema=None) -> dict:
    """Every parameter (and its gradient and Adam moments) and buffer of
    ``module`` whole, by name, and the EMA tensors (a module or a list in
    parameter order)."""
    from imagefolder_tpu_torch.parallel.mesh import full_tensor

    named = list(module.named_parameters())
    out = {f"{prefix}.{n}": full_tensor(p.detach(), p) for n, p in named}
    out.update({f"{prefix}.{n}": b for n, b in module.named_buffers()})
    by_param = {p: n for n, p in named}
    for p in opt.params:
        n = by_param[p]
        if p.grad is not None:
            out[f"grad.{prefix}.{n}"] = full_tensor(p.grad, p)
        for k, v in opt.opt.state.get(p, {}).items():
            if k != "step":
                out[f"{k}.{prefix}.{n}"] = full_tensor(v, p)
    if ema is not None:
        ema = ema if isinstance(ema, list) else list(ema.parameters())
        out.update({f"ema.{prefix}.{n}": full_tensor(e, p) for (n, p), e in zip(named, ema)})
    return out


def _layout(model, placements: dict, ema: list) -> dict:
    """What the GAN step left on this rank: for each parameter FSDP2 split,
    its local share of the whole (1/2 on a 2-wide fsdp axis), whether the
    module holds the sharded parameter and the EMA the same placement; and
    whether every gathered copy has been freed."""
    from torch.distributed.tensor import DTensor

    named = list(model.named_parameters())
    shares, ema_same, sharded = {}, True, 0
    for (n, p), e in zip(named, ema):
        if placements[n].is_shard():
            sharded += 1
            shares[n] = p.to_local().numel() / p.numel() if isinstance(p, DTensor) else 1.0
            ema_same &= isinstance(e, DTensor) and e.placements == p.placements
        else:
            ema_same &= not isinstance(e, DTensor)
    gathered = []
    for m in model.modules():
        if hasattr(m, "_get_fsdp_state"):
            for group in m._get_fsdp_state()._fsdp_param_groups:
                for fp in group.fsdp_params:
                    gathered += [t.untyped_storage().size() for t in fp.all_gather_outputs]
    return {"shares": shares, "ema_same": ema_same, "sharded": sharded,
            "gathered_bytes": sum(gathered), "gathered_buffers": len(gathered)}


def case_gan(mesh, rank):
    """tests/test_sharding.py's CNN-tokenizer GAN step (PatchGAN, the
    adaptive weight) on data x fsdp, the tokenizer and its EMA split at
    min_size 2^10, one step (test_torch_sharding.py says why)."""
    from imagefolder_tpu_torch.parallel.mesh import fsdp_shard_params, shard_batch
    from imagefolder_tpu_torch.train.tokenizer_train import (TokenizerTrainConfig,
                                                             TokenizerTrainer)

    margs = _cnn_margs(num_latent_tokens=256, image_size=32, v_patch_nums=(1, 16), start_drop=1)
    tcfg = TokenizerTrainConfig(disc_type="patchgan", disc_start=0, disc_adaptive_weight=True,
                                epochs=1, steps_per_epoch=2, image_size=32)
    shard = None if mesh is None else (lambda m: fsdp_shard_params(m, mesh, min_size=2 ** 10))
    tr = TokenizerTrainer(margs, tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu", shard=shard)
    x = np.random.default_rng(1).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(x) if mesh is None else shard_batch(x, mesh)
    m = tr.train_step(x, epoch=0)
    out = {**_state("model", tr.model, tr.gen_opt, tr.ema_params),
           **_state("disc", tr.disc, tr.disc_opt), "usage_ema": tr.usage_ema,
           "lecam.real": tr.lecam.logits_real_ema, "lecam.fake": tr.lecam.logits_fake_ema,
           **{f"metric.{k}": v for k, v in m.items()}}
    extra = {}
    if mesh is not None:
        extra = {"placements": {k: str(v) for k, v in tr.placements.items()},
                 "layout": _layout(tr.model, tr.placements, tr.ema_params)}
    return out, extra


def _var_trainer(shard):
    from imagefolder_tpu_torch.models.tokenizer import VQModel
    from imagefolder_tpu_torch.models.var import VAR, VARConfig
    from imagefolder_tpu_torch.train.var_train import VARTrainConfig, VARTrainer

    gen = torch.Generator().manual_seed(0)
    vae = VQModel(_cnn_margs(num_latent_tokens=9, image_size=6, v_patch_nums=(1, 2, 3)),
                  generator=gen, device="cpu")
    var = VAR(VARConfig(vocab_size=32, Cvae=8, num_classes=10, depth=2, embed_dim=64,
                        num_heads=2, patch_nums=(1, 2, 3), drop_path_rate=0.0,
                        cond_drop_rate=0.0, p_drop=0.0), generator=gen, device="cpu")
    return VARTrainer(vae, var, VARTrainConfig(total_steps=10, warmup_steps=2, ema=True),
                      generator=torch.Generator().manual_seed(3), shard=shard)


def _var_case(mesh, shard):
    from imagefolder_tpu_torch.parallel.mesh import shard_batch

    tr = _var_trainer(shard)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (B, 6, 6, 3)).astype(np.float32)
    y = np.arange(B) % 10
    batch = ({"x": torch.from_numpy(x), "y": torch.from_numpy(y)} if mesh is None
             else shard_batch({"x": x, "y": y}, mesh))
    for _ in range(VAR_STEPS):
        m = tr.train_step(batch["x"], batch["y"])
    out = {**_state("var", tr.var, tr.opt, tr.ema_var),
           **{f"metric.{k}": v for k, v in m.items()}}
    extra = {} if tr.placements is None else {
        "placements": {k: str(v) for k, v in tr.placements.items()}}
    return out, extra


def case_var_data(mesh, rank):
    """tests/test_sharding.py's VAR-d2 step on a data-only mesh of 4."""
    return _var_case(mesh, None)


def case_var_tp(mesh, rank):
    """tests/test_sharding.py's VAR-d2 step on data x model under
    ``tp_shard_params``, its EMA copy split the same way."""
    from imagefolder_tpu_torch.parallel.mesh import tp_shard_params

    return _var_case(mesh, None if mesh is None else (lambda m: tp_shard_params(m, mesh)))


def _vit_margs():
    from imagefolder_tpu_torch.models import vit

    vit.VIT_PRESETS[TINY_VIT] = TINY_VIT_PRESET
    return dict(enc_type="dinov2", dec_type="dinov2", encoder_model=TINY_VIT,
                decoder_model=TINY_VIT, codebook_size=16,
                codebook_embed_dim=8, v_patch_nums=(1, 1, 2), num_latent_tokens=4,
                image_size=32, dtype_str="float32")


def case_gan_tp(mesh, rank):
    """The flagship GAN recipe at a tiny ViT width (4 heads of 16; remat, the
    frozen DINOv2 teacher, the EMA) with PatchGAN and the adaptive weight,
    the tokenizer and its EMA on data x model under ``tp_shard_params``: each
    ViT block's qkv and proj and ToPixel's linear proj split, the teacher's
    blocks too. One step, as ``case_gan``."""
    from imagefolder_tpu_torch.parallel.mesh import shard_batch, tp_shard_params
    from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
    from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer

    margs, tcfg = flagship_gan_recipe(B, margs_overrides=_vit_margs(), tcfg_overrides=dict(
        image_size=32, disc_type="patchgan", steps_per_epoch=2))
    shard = None if mesh is None else (lambda m: tp_shard_params(m, mesh))
    tr = TokenizerTrainer(margs, tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu", shard=shard)
    x = np.random.default_rng(4).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(x) if mesh is None else shard_batch(x, mesh)
    m = tr.train_step(x, epoch=0)
    out = {**_state("model", tr.model, tr.gen_opt, tr.ema_params),
           **_state("disc", tr.disc, tr.disc_opt), "usage_ema": tr.usage_ema,
           **{f"metric.{k}": v for k, v in m.items()}}
    extra = {} if mesh is None else {"placements": {k: str(v) for k, v in tr.placements.items()}}
    return out, extra


def case_vit_fused_tp(mesh, rank):
    """The tiny ViT tokenizer's encoder and decoder with the fused sublayers
    on (#7 and #8; here their plain versions), on data x model under
    ``tp_shard_params``: dec(enc(x)) and every parameter's gradient of a
    weighted sum of it."""
    from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
    from imagefolder_tpu_torch.models.vit import set_fused_sublayers
    from imagefolder_tpu_torch.parallel.dist import all_gather_batch, all_reduce_mean_
    from imagefolder_tpu_torch.parallel.mesh import full_tensor, shard_batch, tp_shard_params

    model = VQModel(ModelArgs(**_vit_margs(), semantic_guide="none", detail_guide="none"),
                    generator=torch.Generator().manual_seed(5), device="cpu")
    assert set_fused_sublayers(model, True, True) == 4
    placements = None if mesh is None else tp_shard_params(model, mesh)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    if mesh is None:
        x, w = torch.from_numpy(x), torch.from_numpy(w)
    else:
        x, w = shard_batch(x, mesh), shard_batch(w, mesh)
    y = model.decoder(model.encoder(x))
    (y * w).sum().backward()
    out = {f"model.{n}": full_tensor(p.detach(), p) for n, p in model.named_parameters()}
    out.update({f"grad.model.{n}": full_tensor(p.grad, p) for n, p in model.named_parameters()
                if p.grad is not None})
    if mesh is not None:  # the whole batch's: the data shards' sums summed
        grads = [v for k, v in out.items() if k.startswith("grad.")]
        all_reduce_mean_(grads)
        torch._foreach_mul_(grads, float(mesh.shape[0]))
        y = all_gather_batch(y)
    out["output"] = y.detach()
    extra = {} if mesh is None else {"placements": {k: str(v) for k, v in placements.items()}}
    return out, extra


def _gen_case(mesh, kind: str, rule):
    """RAR's or MaskGIT's trainer (``kind``: rar, maskgit_bert or
    maskgit_uvit) at a tiny width, ``GEN_STEPS[kind]`` steps on B=8, the
    model (and RAR's EMA) split by ``rule`` on ``mesh``."""
    from imagefolder_tpu_torch.models import build_maskgit, build_rar
    from imagefolder_tpu_torch.parallel.mesh import shard_batch
    from imagefolder_tpu_torch.train.rar_train import MaskGITTrainer, RARTrainConfig, RARTrainer

    shard = None if mesh is None else rule(mesh)
    gen = torch.Generator().manual_seed(7)
    if kind == "rar":
        tr = RARTrainer(build_rar(**GEN, generator=gen),
                        RARTrainConfig(warmup_steps=2, total_steps=10), shard=shard)
        model, ema = tr.rar, tr.ema
    else:
        tr = MaskGITTrainer(build_maskgit(**GEN, arch=kind.split("_")[1], generator=gen), 20,
                            shard=shard)
        model, ema = tr.model, None
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, GEN["codebook_size"], (B, GEN["seq_len"]))
    labels = rng.integers(0, GEN["num_classes"], (B,))
    batch = ({"t": torch.from_numpy(tokens), "y": torch.from_numpy(labels)} if mesh is None
             else shard_batch({"t": tokens, "y": labels}, mesh))
    draws = torch.Generator().manual_seed(9)
    for _ in range(GEN_STEPS[kind]):
        m = (tr.train_step(batch["t"], batch["y"], 0.5, draws) if kind == "rar"
             else tr.train_step(batch["t"], batch["y"], draws))
    out = {**_state("model", model, tr.opt, ema), **{f"metric.{k}": v for k, v in m.items()}}
    extra = {} if tr.placements is None else {
        "placements": {k: str(v) for k, v in tr.placements.items()}}
    return out, extra


def _fsdp(mesh):
    from imagefolder_tpu_torch.parallel.mesh import fsdp_shard_params

    return lambda m: fsdp_shard_params(m, mesh, min_size=2 ** 10)


def _tp(mesh):
    from imagefolder_tpu_torch.parallel.mesh import tp_shard_params

    return lambda m: tp_shard_params(m, mesh)


def case_rar_fsdp(mesh, rank):
    return _gen_case(mesh, "rar", _fsdp)


def case_rar_tp(mesh, rank):
    return _gen_case(mesh, "rar", _tp)


def case_maskgit_fsdp(mesh, rank):
    return _gen_case(mesh, "maskgit_bert", _fsdp)


def case_maskgit_tp(mesh, rank):
    return _gen_case(mesh, "maskgit_uvit", _tp)


def _accum_trainer(mesh):
    from imagefolder_tpu_torch.models.tokenizer import ModelArgs
    from imagefolder_tpu_torch.train.tokenizer_train import (TokenizerTrainConfig,
                                                             TokenizerTrainer)

    margs = ModelArgs(**_vit_margs(), semantic_guide="none", detail_guide="none")
    # the disc's weight is 0 until step 100 (its gradients 0) and the
    # generator's second lr is lr / 10^4: the second update's Adam step would
    # otherwise carry the fp32 reorderings of near-zero gradient entries past
    # 1e-6 (test_torch_sharding.py's docstring); no LPIPS, for time
    tcfg = TokenizerTrainConfig(disc_type="patchgan", disc_start=100, disc_adaptive_weight=True,
                                perceptual_weight=0.0, epochs=1, steps_per_epoch=10 ** 4,
                                image_size=32, grad_accum_steps=2)
    return TokenizerTrainer(margs, tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", shard=None if mesh is None else _fsdp(mesh))


def case_gan_accum(mesh, rank):
    """The tiny ViT tokenizer's GAN step (PatchGAN, the adaptive weight, the
    EMA) with ``grad_accum_steps=2``, the tokenizer split on data x fsdp by
    FSDP2, over two updates (ACCUM_MICRO micro-steps, each on its own batch).
    The run's state after its first micro-step, mid-accumulation, is written
    to bytes (``state_dict``) and loaded into a fresh trainer, which runs the
    other micro-steps: every tensor it leaves must equal the straight run's
    bit for bit (``resume``)."""
    import io

    from imagefolder_tpu_torch.parallel.mesh import shard_batch

    rng = np.random.default_rng(10)
    xs = [rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32) for _ in range(ACCUM_MICRO)]
    xs = [torch.from_numpy(x) if mesh is None else shard_batch(x, mesh) for x in xs]

    def state(tr, m):
        # under accumulation a micro-step's grad norms are this process's own
        # (ScheduledAdamW): left out of the comparison
        return {**_state("model", tr.model, tr.gen_opt, tr.ema_params),
                **_state("disc", tr.disc, tr.disc_opt), "usage_ema": tr.usage_ema,
                **{f"metric.{k}": v for k, v in m.items() if not k.endswith("grad_norm")}}

    tr = _accum_trainer(mesh)
    buf = io.BytesIO()
    for i, x in enumerate(xs):
        m = tr.train_step(x, epoch=0)
        if i == 0:
            assert tr.gen_opt.mini_step == 1 and tr.gen_opt.acc is not None
            torch.save(tr.state_dict(), buf)
    straight = state(tr, m)
    resumed = _accum_trainer(mesh)
    buf.seek(0)
    resumed.load_state_dict(torch.load(buf, weights_only=False))
    for x in xs[1:]:
        m = resumed.train_step(x, epoch=0)
    again = state(resumed, m)
    unequal = sorted(k for k in straight if not torch.equal(straight[k], again[k]))
    return straight, {"resume": {"tensors": len(straight), "unequal": unequal}}


def case_rar_generate_tp(mesh, rank):
    """``rar_generate`` with CFG on a RAR split over the model axis, its
    Gumbel draws given (``noise=``): the tokens of the whole batch, on every
    rank."""
    from imagefolder_tpu_torch.models import build_rar
    from imagefolder_tpu_torch.models.rar import rar_generate

    rar = build_rar(**GEN, generator=torch.Generator().manual_seed(11))
    if mesh is not None:
        _tp(mesh)(rar)
    rng = np.random.default_rng(12)
    labels = torch.from_numpy(rng.integers(0, GEN["num_classes"], (B,)))
    noise = torch.from_numpy(rng.gumbel(size=(GEN["seq_len"], B, GEN["codebook_size"]))
                             .astype(np.float32))
    ids = rar_generate(rar, labels, guidance_scale=3.0, randomize_temperature=1.0,
                       guidance_scale_pow=1.0, noise=noise, decode_chunk=5)
    return {"tokens": ids}, {}


CASES = {"gan_fsdp": (case_gan, ("data", "fsdp"), (2, 2)),
         "var_data": (case_var_data, ("data",), (4,)),
         "var_tp": (case_var_tp, ("data", "model"), (2, 2)),
         "gan_tp": (case_gan_tp, ("data", "model"), (2, 2)),
         "vit_fused_tp": (case_vit_fused_tp, ("data", "model"), (2, 2)),
         "rar_fsdp": (case_rar_fsdp, ("data", "fsdp"), (2, 2)),
         "rar_tp": (case_rar_tp, ("data", "model"), (2, 2)),
         "maskgit_fsdp": (case_maskgit_fsdp, ("data", "fsdp"), (2, 2)),
         "maskgit_tp": (case_maskgit_tp, ("data", "model"), (2, 2)),
         "gan_accum": (case_gan_accum, ("data", "fsdp"), (2, 2)),
         "rar_generate_tp": (case_rar_generate_tp, ("data", "model"), (2, 2))}


def main():
    coordinator, nproc, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from imagefolder_tpu_torch.parallel import dist
    from imagefolder_tpu_torch.parallel.mesh import make_mesh

    if nproc > 1:
        assert dist.init_distributed(coordinator, nproc, rank, device="cpu")
    names = sys.argv[5:] or list(CASES)
    for name in names:
        case, axes, shape = CASES[name]
        mesh = make_mesh(axes, shape, device="cpu") if nproc > 1 else None
        state, extra = case(mesh, rank)
        torch.save({"state": {k: v.detach().clone() for k, v in state.items()}, **extra},
                   Path(out) / f"{name}_{nproc}_{rank}.pt")
    dist.sync_global_devices("done")
    print("sharding ok")


if __name__ == "__main__":
    main()
