"""Port parity, ``scripts/linear_probe.py``: ``VQModel.img_to_sem_feat``
(the semantic, last, branch's final-scale f_hat) and its spatial mean, the
probe's input, against the JAX package on a tiny single-branch tokenizer
(``tests/_torch_cli.py``: width 64, 64 px, 16 latents) and a tiny
two-branch multi-scale one; the head's Adam steps (``train_step``) against
the JAX script's ``optax.adam`` step, transcribed (it is nested in its
``main``); and both CLIs' ``main`` on the CPU over the same 8 PNGs: with no
step both heads are zero and their ACC lines must be the same, and a few
steps of the port's run print its loss-free ACC line over all 8.

Tolerance: features within 1e-4 of the largest; the head within 1e-5 of
its largest entry after 5 steps (fp32).
"""

import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import imagefolder_tpu.data.imagenet as jax_data
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.scripts import linear_probe as pt_probe
from imagefolder_tpu_torch.utils.convert import vqmodel_state_dict_from_flax
from scripts import linear_probe as jax_probe
from tests._torch_cli import CFG, PX, TINY, files, tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread, random_params  # noqa: F401

TOL = 1e-4
MULTI = dict(CFG, v_patch_nums=(1, 2, 4), product_quant=2)


@pytest.mark.parametrize("cfg", [CFG, MULTI], ids=["one-branch", "two-branch-multiscale"])
def test_img_to_sem_feat_matches_jax(cfg):
    jargs = JaxArgs(**{**cfg, "v_patch_nums": tuple(cfg["v_patch_nums"])})
    img = np.random.default_rng(1).uniform(-1, 1, (3, PX, PX, 3)).astype(np.float32)
    params = random_params(JaxVQModel(jargs), jnp.asarray(img), train=False, seed=6)
    want = jax.jit(lambda p, x: JaxVQModel(jargs).apply(
        {"params": p}, x, method=JaxVQModel.img_to_sem_feat))(params, jnp.asarray(img))
    pargs = PtArgs(**{**cfg, "v_patch_nums": tuple(cfg["v_patch_nums"])})
    pm = PtVQModel(pargs, device="cpu")
    pm.load_state_dict(vqmodel_state_dict_from_flax(params, pargs), strict=True)
    with torch.no_grad():
        got = pm.img_to_sem_feat(torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (3, 4, 4, cfg["codebook_embed_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(np.asarray(want)).max())
    feats = pt_probe.features(pm, torch.from_numpy(img))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want).mean(axis=(1, 2)), rtol=0,
                               atol=TOL * np.abs(np.asarray(want)).max())


def test_adam_steps_match_optax():
    rng = np.random.default_rng(2)
    dim, classes, lr = 8, 5, 1e-2
    tx = optax.adam(lr)

    @jax.jit
    def jax_step(wb, opt, feats, labels):  # scripts/linear_probe.py's step
        def loss_fn(wb):
            logp = jax.nn.log_softmax(feats @ wb[0] + wb[1])
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

        loss, g = jax.value_and_grad(loss_fn)(wb)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(wb, upd), opt, loss

    wb = (jnp.zeros((dim, classes)), jnp.zeros((classes,)))
    opt = tx.init(wb)
    w = torch.zeros((dim, classes), requires_grad=True)
    b = torch.zeros((classes,), requires_grad=True)
    popt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(5):
        feats = rng.normal(size=(16, dim)).astype(np.float32)
        labels = rng.integers(0, classes, 16).astype(np.int32)
        wb, opt, want_loss = jax_step(wb, opt, jnp.asarray(feats), jnp.asarray(labels))
        loss = pt_probe.train_step(w, b, popt, torch.from_numpy(feats), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for got, want in ((w, wb[0]), (b, wb[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _acc_line(text: str) -> str:
    return re.search(r"^linear-probe ACC: .*$", text, re.M).group(0)


def test_main_matches_jax_on_the_cpu(files, monkeypatch, capsys):
    root, _, _ = files
    # no worker processes: a forked worker of a process holding JAX's
    # threads may deadlock
    for mod in (pt_probe, jax_data):
        monkeypatch.setattr(mod, "make_dataloader", lambda *a, _f=mod.make_dataloader, **k:
                            _f(*a, **{**k, "num_workers": 0}))
    common = ["--config", str(root / "cfg.yaml"), "--vq_ckpt", str(root / "tok.pt"),
              "--data_path", str(root / "val"), "--val_data", str(root / "val"),
              "--batch_size", "4", "--num_classes", "3", "--lr", "0.1"]
    monkeypatch.setattr(sys, "argv", ["linear_probe.py", *common, "--steps", "0"])
    jax_probe.main()
    want = _acc_line(capsys.readouterr().out)
    got = pt_probe.main([*common, "--steps", "0"], device="cpu")
    assert _acc_line(capsys.readouterr().out) == want == "linear-probe ACC: 100.00% (8 images)"
    assert got == {"acc": 100.0, "total": 8, "loss": 0.0, "steps": 0}
    got = pt_probe.main([*common, "--steps", "3"], device="cpu")
    line = _acc_line(capsys.readouterr().out)
    assert got["total"] == 8 and got["steps"] == 3 and np.isfinite(got["loss"])
    assert line == f"linear-probe ACC: {got['acc']:.2f}% (8 images)"
