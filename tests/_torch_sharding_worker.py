"""Worker for the sharded-step tests of the port (test_torch_sharding.py),
the counterparts of tests/test_sharding.py's four tests.

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


CASES = {"gan_fsdp": (case_gan, ("data", "fsdp"), (2, 2)),
         "var_data": (case_var_data, ("data",), (4,)),
         "var_tp": (case_var_tp, ("data", "model"), (2, 2))}


def main():
    coordinator, nproc, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from imagefolder_tpu_torch.parallel import dist
    from imagefolder_tpu_torch.parallel.mesh import make_mesh

    if nproc > 1:
        assert dist.init_distributed(coordinator, nproc, rank, device="cpu")
    for name, (case, axes, shape) in CASES.items():
        mesh = make_mesh(axes, shape, device="cpu") if nproc > 1 else None
        state, extra = case(mesh, rank)
        torch.save({"state": {k: v.detach().clone() for k, v in state.items()}, **extra},
                   Path(out) / f"{name}_{nproc}_{rank}.pt")
    dist.sync_global_devices("done")
    print("sharding ok")


if __name__ == "__main__":
    main()
