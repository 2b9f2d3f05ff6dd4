"""The port's VAR CLIs on the CPU at a tiny size, against the JAX package:
a multi-scale tokenizer (``tests/_torch_cli.py``'s tiny ViT, PQ2 over
scales (1, 2, 4) of a 16 x 8 codebook, 64 px, fp32 by ``mixed_precision:
none``) and VAR-d2 over 10 classes, their JAX parameters numpy-drawn and
exported with ``export_vqmodel`` and ``export_var`` to ``.pt`` files:

- ``var_eval_ep`` with ``VARTrainer.eval_step`` (what ``train_var``'s eval
  runs) on the val PNGs: every metric within 1e-5 of the JAX package's
  ``var_eval_ep`` with its trainer's ``eval_step`` on the same batches;
- ``sample_var --top_k 1`` (greedy: both RNGs drop out; VAR built in fp32
  here, which the CLI builds in bf16): the codes each stage picks equal
  the JAX ``var_sample``'s, its images within 1e-4, and the npz their
  ``clip(255 x + 0.5)``;
- the schedule and the progressive controller that ``train_var`` builds:
  the JAX script's ``VARTrainConfig`` fields (``scripts/train_var.py:
  97-105``), the lr of every step against the JAX ``lr_wd_annealing``, and
  every step's (stage, warm-up) against the JAX ``ProgressiveController``;
- ``train_var`` for 4 steps (2 epochs of 2) with a checkpoint, an eval, a
  preview and ``best.pt`` at step 2: a run stopped after step 2 and rerun
  (it resumes) leaves every tensor of the trainer and the controller's
  state bit-equal to the straight run's.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

import imagefolder_tpu_torch.models as pt_models
from imagefolder_tpu.eval.validation import var_eval_ep as jax_var_eval_ep
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu.train import var_train as jax_vt
from imagefolder_tpu.utils.convert_torch import export_var
import imagefolder_tpu_torch.data.imagenet as pt_data
from imagefolder_tpu_torch.data.imagenet import make_dataloader
from imagefolder_tpu_torch.eval.validation import var_eval_ep
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.scripts import sample_var, train_var
from imagefolder_tpu_torch.train import optim as pt_optim
from imagefolder_tpu_torch.train.var_train import VARTrainer
from imagefolder_tpu_torch.utils import logging as pt_logging
from imagefolder_tpu_torch.utils.config import load_tokenizer_config
from imagefolder_tpu_torch.utils.convert import vqmodel_state_dict_from_flax
from tests._torch_cli import CFG as TOK_CFG
from tests._torch_cli import tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread, random_params  # noqa: F401

PX = 64
MS = {**TOK_CFG, "v_patch_nums": [1, 2, 4], "product_quant": 2, "codebook_size": 16,
      "mixed_precision": "none"}


class _Stop(Exception):
    pass


def _pngs(d, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        sub = d / f"c{i % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8)).save(sub / f"{i}.png")


@pytest.fixture(scope="module")
def var_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("var_cli")
    _pngs(root / "train", 8, 0)
    _pngs(root / "val", 6, 1)
    (root / "cfg.yaml").write_text(yaml.safe_dump(
        {**MS, "data_path": str(root / "train"), "val_data_path": str(root / "val")}))
    jargs = JaxArgs(**{k: tuple(v) if isinstance(v, list) else v for k, v in MS.items()
                       if k != "mixed_precision"})
    jvae, jvar = jax_vt.build_vae_var(jargs, depth=2, num_classes=10)
    img = jnp.zeros((2, PX, PX, 3))
    vparams = random_params(jvae, img, train=False, seed=3)
    cfg = jvar.config
    x_in = jnp.zeros((2, cfg.L - cfg.first_l, cfg.Cvae))
    params = random_params(jvar, jnp.asarray([0, 1]), x_in, seed=4)
    # the tokenizer through the port's converter, which zero-fills the Phi
    # that no scale applies (the JAX exporter leaves it out); VAR as the JAX
    # exporter writes it
    pargs, _, _ = load_tokenizer_config(str(root / "cfg.yaml"))
    torch.save(vqmodel_state_dict_from_flax(vparams, pargs), root / "tok.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in export_var(params).items()},
               root / "var.pt")
    return root, (jvae, vparams, jvar, params)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trackers without tensorboard (its writer imports TensorFlow
    here), and the loaders without worker processes (no fork of a process
    that holds JAX's threads)."""
    tracker = pt_logging.Tracker
    monkeypatch.setattr(pt_logging, "Tracker",
                        lambda **k: tracker(**{**k, "use_tb": False}))
    make = pt_data.make_dataloader
    monkeypatch.setattr(pt_data, "make_dataloader",
                        lambda *a, **k: make(*a, **{**k, "num_workers": 0}))


def _port_models(root):
    from imagefolder_tpu_torch.scripts._cli import checkpoint_weights

    margs, _, _ = load_tokenizer_config(str(root / "cfg.yaml"))
    vae, var = pt_models.build_vae_var(margs, depth=2, num_classes=10, device="cpu")
    vae.load_state_dict(checkpoint_weights(root / "tok.pt"), strict=True)
    var.load_state_dict(checkpoint_weights(root / "var.pt"), strict=True)
    return vae, var


def test_var_eval_ep_matches_jax(var_files):
    root, (jvae, vparams, jvar, params) = var_files
    vae, var = _port_models(root)
    tr = VARTrainer(vae, var, train_var.build_schedule(
        types.SimpleNamespace(batch_size=4, epochs=1, tblr=1e-4, pg=0.0, pg0=4, pgwp=0.0),
        3, 8)[0])
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in
               make_dataloader(str(root / "val"), 4, PX, train=False, num_epochs=1,
                               drop_remainder=False, num_workers=0)]
    assert [len(b["label"]) for b in batches] == [4, 2]
    got = var_eval_ep(lambda x, y: tr.eval_step(torch.from_numpy(x),
                                                torch.from_numpy(y).long()), batches, 4)
    jtr = jax_vt.VARTrainer(jvae, jvar, jax_vt.VARTrainConfig())
    step = jax.jit(jtr.eval_step)
    want = jax_var_eval_ep(lambda x, y: step(params, vparams, jnp.asarray(x), jnp.asarray(y)),
                           batches, 4)
    assert got["val_tot"] == want["val_tot"] == 6
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, got[k], v)


def test_sample_var_greedy_matches_jax(var_files, monkeypatch, tmp_path):
    root, (jvae, vparams, jvar, params) = var_files
    build = pt_models.build_vae_var
    monkeypatch.setattr(pt_models, "build_vae_var",
                        lambda *a, **k: build(*a, **{**k, "dtype_str": "float32"}))
    seen = {"jax": [], "port": []}
    orig_j, orig_p = JaxVQModel.embed_branch, VQModel.embed_branch

    def jax_wrap(self, i, idx, si=None):  # the jitted sampler's codes, as they are made
        jax.debug.callback(lambda x: seen["jax"].append(np.asarray(x)), idx, ordered=True)
        return orig_j(self, i, idx, si)

    def port_wrap(self, i, idx, si=None):
        seen["port"].append(idx.numpy())
        return orig_p(self, i, idx, si)

    monkeypatch.setattr(JaxVQModel, "embed_branch", jax_wrap)
    monkeypatch.setattr(VQModel, "embed_branch", port_wrap)
    images = []
    from imagefolder_tpu_torch.train import var_train as pt_vt
    orig_sample = pt_vt.var_sample
    monkeypatch.setattr(pt_vt, "var_sample",
                        lambda *a, **k: images.append(orig_sample(*a, **k)) or images[-1])
    out = tmp_path / "s.npz"
    got = sample_var.main(["--config", str(root / "cfg.yaml"), "--vq_ckpt", str(root / "tok.pt"),
                           "--var_ckpt", str(root / "var.pt"), "--depth", "2", "--num_classes",
                           "10", "--num_samples", "4", "--batch_size", "4", "--cfg", "1.5",
                           "--top_k", "1", "--top_p", "0.0", "--output", str(out)],
                          device="cpu")
    # jvar is fp32 (build_vae_var's default)
    want = jax.jit(lambda p, vp, lb, k: jax_vt.var_sample(
        jvar, p, jvae, vp, lb, k, cfg_scale=1.5, top_k=1, top_p=0.0))(
        params, vparams, jnp.arange(4), jax.random.PRNGKey(0))
    jax.effects_barrier()
    assert len(seen["port"]) == len(seen["jax"]) == 3 * 2
    for g, w in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(g, w)
    img = images[0].numpy()
    np.testing.assert_allclose(img, np.asarray(want), rtol=0, atol=1e-4)
    arr = np.load(out)["arr_0"]
    np.testing.assert_array_equal(arr, got["samples"])
    np.testing.assert_array_equal(arr, np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("pg", [0.0, 0.5])
def test_schedule_and_progress_match_the_jax_script(pg):
    n_train, num_scales = 1000, 10
    args = types.SimpleNamespace(batch_size=64, epochs=6, tblr=2e-4, pg=pg, pg0=4, pgwp=0.0)
    tcfg, prog, spe = train_var.build_schedule(args, num_scales, n_train)
    # scripts/train_var.py:97-105 and 108-111, as written there
    j_spe = max(n_train // args.batch_size, 1)
    j_total = args.epochs * j_spe
    j_sched = f"lin{args.pg:g}" if args.pg > 0 else jax_vt.VARTrainConfig.sched
    jcfg = jax_vt.VARTrainConfig(lr=args.tblr * args.batch_size / 256.0, sched=j_sched,
                                 warmup_steps=j_spe, total_steps=j_total)
    jprog = jax_vt.ProgressiveController(num_scales, pg=args.pg, pg0=args.pg0,
                                         prog_wp_it=(args.pgwp or args.epochs / 300.0) * j_spe)
    assert spe == j_spe and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    pt_lr = pt_optim.lr_wd_annealing(tcfg.sched, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps,
                                     tcfg.final_lr_ratio)
    j_lr = jax_optim.lr_wd_annealing(jcfg.sched, jcfg.lr, jcfg.warmup_steps, jcfg.total_steps,
                                     jcfg.final_lr_ratio)
    for step in range(tcfg.total_steps):
        np.testing.assert_allclose(pt_lr(step), float(j_lr(step)), rtol=1e-6)
        got = prog.step(prog.stage(step, tcfg.warmup_steps, tcfg.total_steps))
        want = jprog.step(jprog.stage(step, jcfg.warmup_steps, jcfg.total_steps))
        assert got == want, step
        assert prog.state_dict() == jprog.state_dict()


def _var_argv(root, out):
    return ["--config", str(root / "cfg.yaml"), "--vq_ckpt", str(root / "tok.pt"),
            "--depth", "2", "--num_classes", "10", "--batch_size", "4", "--epochs", "2",
            "--ckpt_every", "2", "--eval_every", "2", "--log_every", "2", "--val_batches", "1",
            "--output", str(out)]


def test_train_var_resumes_exactly(var_files, monkeypatch, tmp_path):
    root, _ = var_files
    straight = train_var.main(_var_argv(root, tmp_path / "a"), device="cpu")
    assert straight["step"] == 4 and straight["ckpt"].steps() == [2, 4]
    assert [s for s, _ in straight["evals"]] == [2, 4]
    assert [p.name for p in straight["previews"]] == ["gen_0000002.png", "gen_0000004.png"]
    assert (tmp_path / "a" / "best.pt").exists()
    orig = VARTrainer.train_step

    def stop_at_2(tr, *a, **k):
        if tr.opt.count == 2:
            raise _Stop
        return orig(tr, *a, **k)

    monkeypatch.setattr(VARTrainer, "train_step", stop_at_2)
    with pytest.raises(_Stop):
        train_var.main(_var_argv(root, tmp_path / "b"), device="cpu")
    monkeypatch.setattr(VARTrainer, "train_step", orig)
    resumed = train_var.main(_var_argv(root, tmp_path / "b"), device="cpu")
    a, b = straight["trainer"], resumed["trainer"]
    assert a.opt.count == b.opt.count == 4
    ta = {**{f"model.{k}": v for k, v in a.var.state_dict().items()},
          **{f"opt.{i}.{n}": v for i, st in a.opt.opt.state_dict()["state"].items()
             for n, v in st.items() if torch.is_tensor(v)}}
    tb = {**{f"model.{k}": v for k, v in b.var.state_dict().items()},
          **{f"opt.{i}.{n}": v for i, st in b.opt.opt.state_dict()["state"].items()
             for n, v in st.items() if torch.is_tensor(v)}}
    assert set(ta) == set(tb)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]
    assert straight["prog"].state_dict() == resumed["prog"].state_dict()
    for k, v in straight["metrics"].items():
        assert torch.equal(v, resumed["metrics"][k]), k
    assert resumed["evals"][-1][1] == straight["evals"][-1][1]
