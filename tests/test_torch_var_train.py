"""Port parity, VAR training: ``imagefolder_tpu_torch/models/var.py``'s
training forward, ``train/var_train.py`` (``VARTrainer``,
``ProgressiveController``) and ``eval/validation.py`` against the JAX
package on the CPU, on the same numpy-seeded inputs.

The tiny DINOv2 tokenizer of ``test_torch_var.py`` (width 64, depth 2; 64
px, a 3x3 latent grid; two PQ branches of 16 codes) with VAR at depth 2
(width 128, 2 heads of 64) over ``patch_nums`` (1, 2, 3), params carried by
the numpy converters. The two packages' generators differ, so the training
forward takes its masks from the test (the JAX side through patched
``jax.random.uniform``/``bernoulli``), and the train steps run with class
dropout and drop path at 0. Tolerances: fp32 logits and losses within 1e-4
(two blocks, summation order only; JAX's attention gradient is XLA's VJP,
the port's the plain backward); gradients within 1e-4 of each tensor's max
abs; parameters after AdamW steps within 1% of the step's lr wherever the
gradient is above 1e-3 of its tensor's max (AdamW's first steps are about
lr * sign(g), which a gradient near 0 may flip).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.eval.validation import var_eval_ep as jax_var_eval_ep
from imagefolder_tpu.models import build_vae_var as jax_build_vae_var
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.models.var import VAR as JaxVAR
from imagefolder_tpu.train import var_train as jax_var_train
from imagefolder_tpu_torch.eval.validation import pad_to_batch, var_eval_ep
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.var import VAR as PtVAR
from imagefolder_tpu_torch.models.var import VARConfig as PtVARConfig
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.ops.cuda import codebook as pt_codebook
from imagefolder_tpu_torch.train.var_train import (
    ProgressiveController,
    VARTrainConfig,
    VARTrainer,
)
from imagefolder_tpu_torch.utils.convert import (
    var_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)

TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
PNS = (1, 2, 3)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _margs(cls):
    return cls(codebook_size=16, codebook_embed_dim=8, v_patch_nums=PNS, product_quant=2,
               enc_type="dinov2", dec_type="dinov2", encoder_model=TINY,
               decoder_model=TINY, semantic_guide="none", detail_guide="none",
               num_latent_tokens=9, abs_pos_embed=True, image_size=64)


def _excite_layerscale(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(np.float32)
                    if k in ("ls1", "ls2") else _excite_layerscale(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


def _var_pair(jvar_cfg, **kw):
    """A JAX VAR and the port's with the same config (``kw`` overriding)
    and the same params."""
    jcfg = dataclasses.replace(jvar_cfg, **kw)
    jvar = JaxVAR(jcfg)
    x_in = np.zeros((2, jcfg.L - jcfg.first_l, jcfg.Cvae), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jvar.init)(
        jax.random.PRNGKey(1), jnp.asarray([0, 1]), jnp.asarray(x_in))["params"])
    pcfg = PtVARConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    pvar = PtVAR(pcfg, device="cpu")
    pvar.load_state_dict(var_state_dict_from_flax(params, pcfg), strict=True)
    return jvar, params, pvar


@pytest.fixture(scope="module")
def tokenizer():
    """(JAX vae, its params), port vae, the JAX build's VAR config, and a
    batch of 3 images with labels."""
    rng = np.random.default_rng(11)
    jvae, jvar = jax_build_vae_var(_margs(JaxArgs), depth=2, num_classes=10)
    imgs = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    vae_params = jax.jit(lambda k, x: jvae.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(imgs[:2]))["params"]
    vae_params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, vae_params), rng)
    margs = _margs(PtArgs)
    pvae, _ = build_vae_var(margs, depth=2, num_classes=10, device="cpu")
    pvae.load_state_dict(vqmodel_state_dict_from_flax(vae_params, margs), strict=True)
    labels = np.array([3, 7, 1])
    return (jvae, vae_params), pvae.eval(), jvar.config, imgs, labels


# --------------------------- training forward --------------------------- #

def _patched_jax_random(monkeypatch, class_drop, token_keep, drop_path):
    """jax.random.uniform/bernoulli returning the draws that give these
    masks inside the JAX VAR's training forward."""
    keeps = [m for pair in drop_path if pair is not None for m in pair]
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *a, **k):
        if shape == class_drop.shape:  # u < cond_drop_rate drops the label
            return jnp.where(jnp.asarray(class_drop), 0.0, 1.0)
        if shape == ():  # the token-drop threshold p = u * p_drop * factor
            return jnp.float32(0.5)
        if shape == token_keep.shape:  # kept where u >= p
            return jnp.where(jnp.asarray(token_keep), 1.0, 0.0)
        return real_uniform(key, shape, *a, **k)

    def bernoulli(key, p, shape):
        return jnp.asarray(keeps.pop(0)).reshape(shape) > 0.5

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return keeps


@pytest.mark.parametrize("prog_si", [-1, 1])
def test_training_forward_with_injected_masks(monkeypatch, tokenizer, prog_si):
    """Class dropout, token dropout (into empty_emb) and drop path at rate
    linspace(0, 0.2, 2) = (0, 0.2): the same masks give the same logits."""
    _, _, jcfg, _, _ = tokenizer
    jvar, params, pvar = _var_pair(jcfg, drop_path_rate=0.2, cond_drop_rate=0.5)
    assert [blk.drop_path for blk in pvar.blocks] == [0.0, 0.2]
    rng = np.random.default_rng(5)
    ed = pvar.config.begin_ends[prog_si][1] if prog_si >= 0 else pvar.config.L
    label = np.array([3, 7, 1])
    x_in = rng.normal(size=(3, ed - 1, jcfg.Cvae)).astype(np.float32)
    class_drop = np.array([True, False, False])
    token_keep = rng.uniform(size=(3, ed - 1)) > 0.3
    drop_path = [None, (np.array([1.0, 0.0, 1.0], np.float32),
                        np.array([0.0, 1.0, 1.0], np.float32))]
    left = _patched_jax_random(monkeypatch, class_drop, token_keep, drop_path)
    want = jvar.apply({"params": params}, jnp.asarray(label), jnp.asarray(x_in),
                      p_drop_factor=1.0, train=True, prog_si=prog_si,
                      rngs={"sample": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)})
    assert not left  # JAX drew exactly the two drop-path masks
    masks = {"class_drop": torch.from_numpy(class_drop),
             "token_keep": torch.from_numpy(token_keep),
             "drop_path": [None if p is None else tuple(map(torch.from_numpy, p))
                           for p in drop_path]}
    with torch.no_grad():
        got = pvar(torch.from_numpy(label), torch.from_numpy(x_in), prog_si, train=True,
                   masks=masks)
        plain = pvar(torch.from_numpy(label), torch.from_numpy(x_in), prog_si)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the masks did act


def test_draw_masks_and_remat(tokenizer):
    """draw_masks takes every draw from the generator (same seed, same
    masks, keep rates as configured), and remat recomputes each block with
    the masks drawn before it: logits and gradients equal without remat."""
    _, _, jcfg, _, _ = tokenizer
    _, _, pvar = _var_pair(jcfg, drop_path_rate=0.5, cond_drop_rate=0.5)
    a, b = (pvar.draw_masks(400, p_drop_factor=1.0,
                            generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a["class_drop"], b["class_drop"])
    assert torch.equal(a["token_keep"], b["token_keep"])
    assert a["drop_path"][0] is None and a["token_keep"].shape == (400, 13)
    assert abs(a["class_drop"].float().mean().item() - 0.5) < 0.1
    assert abs(a["drop_path"][1][0].mean().item() - 0.5) < 0.1
    label = torch.tensor([3, 7])
    x_in = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 13, 16)).astype(np.float32))
    results = []
    for remat in (False, True):
        pvar.config.remat = remat
        pvar.zero_grad()
        out = pvar(label, x_in, train=True, p_drop_factor=1.0,
                   generator=torch.Generator().manual_seed(9))
        out.square().mean().backward()
        results.append((out.detach(), [p.grad.clone() for p in pvar.parameters()]))
    pvar.config.remat = False
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for g0, g1 in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)


# ------------------------------ the trainer ------------------------------ #

def _jax_trainer(jvar, tcfg):
    jtcfg = jax_var_train.VARTrainConfig(**dataclasses.asdict(tcfg))
    return jax_var_train.VARTrainer(None, jvar, jtcfg)


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
@pytest.mark.parametrize("prog_si,prog_wp", [(-1, 1.0), (1, 0.35), (0, 1.0)])
def test_ce_and_acc_matches_jax(tokenizer, label_smooth, prog_si, prog_wp):
    _, _, jcfg, _, _ = tokenizer
    jvar, _, pvar = _var_pair(jcfg)
    tcfg = VARTrainConfig(label_smooth=label_smooth)
    jtr = _jax_trainer(jvar, tcfg)
    ptr = VARTrainer.__new__(VARTrainer)
    ptr.var, ptr.L, ptr.last_l = pvar, pvar.config.L, PNS[-1] ** 2
    rng = np.random.default_rng(6)
    ed = pvar.config.begin_ends[prog_si][1] if prog_si >= 0 else pvar.config.L
    logits = rng.normal(size=(3, ed, 32)).astype(np.float32) * 2
    gts = [rng.integers(0, 16, (3, ed)) for _ in range(2)]
    gts[0][:, :3] = logits[:, :3, :16].argmax(-1)  # some right answers
    want = jtr._ce_and_acc(jnp.asarray(logits), [jnp.asarray(g) for g in gts], label_smooth,
                           prog_si, prog_wp)
    got = ptr._ce_and_acc(torch.from_numpy(logits), [torch.from_numpy(g) for g in gts],
                          label_smooth, prog_si, prog_wp)
    for g, w, name in zip(got, want, ("loss", "acc_mean", "acc_tail")):
        assert g.shape == ()
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=1e-6, err_msg=name)
    if prog_si >= 0:
        assert got[2].item() == -1.0


def test_progressive_controller_matches_jax():
    """The same (stage, prog_si, prog_wp) trajectory as the JAX class over a
    pg=0.8 schedule, and the same after a state_dict round trip."""
    mk = dict(num_stages=len(PNS) + 7, pg=0.8, pg0=1, prog_wp_it=4.0)
    mine, ref = ProgressiveController(**mk), jax_var_train.ProgressiveController(**mk)
    for g_it in range(60):
        si = mine.stage(g_it, 10, 100)
        assert si == ref.stage(g_it, 10, 100)
        assert mine.step(si) == ref.step(si)
        if g_it == 30:
            resumed = ProgressiveController(**mk)
            resumed.load_state_dict(mine.state_dict())
            mine = resumed
    assert ProgressiveController(5, pg=0.0).stage(3, 1, 10) == -1
    assert ProgressiveController(3, pg0=4).pg0 == jax_var_train.ProgressiveController(3,
                                                                                      pg0=4).pg0


@pytest.fixture(scope="module")
def train_pair(tokenizer):
    """JAX and port trainers over the same tokenizer and VAR params, class
    dropout and drop path off, lr 1e-3 with a 2-step warmup."""
    (jvae, vae_params), pvae, jcfg, imgs, labels = tokenizer
    jvar, params, pvar = _var_pair(jcfg, drop_path_rate=0.0, cond_drop_rate=0.0)
    tcfg = VARTrainConfig(lr=1e-3, warmup_steps=2, total_steps=10, label_smooth=0.1)
    jtr = jax_var_train.VARTrainer(jvae, jvar, jax_var_train.VARTrainConfig(
        **dataclasses.asdict(tcfg)))
    return jtr, params, vae_params, VARTrainer(pvae, pvar, tcfg), imgs, labels


def test_gradients_match_jax(train_pair):
    """The port's loss and every gradient of one batch against jax.grad of
    the JAX trainer's loss."""
    jtr, params, vae_params, ptr, imgs, labels = train_pair
    idx = jtr.vae.apply({"params": vae_params}, jnp.asarray(imgs), method=JaxVQModel.img_to_idxBl)
    gt = [jnp.concatenate(b, axis=1) for b in idx]
    x_in = jtr.vae.apply({"params": vae_params}, idx, method=JaxVQModel.idxBl_to_var_input)

    def loss_fn(p):
        logits = jtr.var.apply({"params": p}, jnp.asarray(labels), x_in, train=True,
                               rngs={"sample": jax.random.PRNGKey(0),
                                     "droppath": jax.random.PRNGKey(0)})
        return jtr._ce_and_acc(logits, gt, jtr.tcfg.label_smooth)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = var_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want), ptr.var.config)
    ptr.opt.zero_grad()
    loss, _, _ = ptr.loss_and_backward(torch.from_numpy(imgs), torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in ptr.var.named_parameters():
        w = want[name].numpy()
        if p.grad is None:  # no path to the loss: empty_emb with token dropout off
            assert name == "empty_emb.weight" and not w.any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-12), err_msg=name)
    ptr.opt.zero_grad()


def test_train_steps_match_jax(train_pair):
    """One and two optimizer steps from the same params: loss, accuracies,
    gradient norm and the parameters."""
    jtr, params, vae_params, ptr, imgs, labels = train_pair
    p0 = {k: v.detach().clone() for k, v in ptr.var.named_parameters()}
    state = jax_var_train.VARTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jtr.tx.init(params), vae_params=vae_params, ema_params=None,
        step=jnp.zeros((), jnp.int32))
    lrs = [1e-3 * 0.005, 1e-3 * (0.005 + 0.995 / 2)]
    tol = 0.0
    firm = {k: True for k in p0}  # firm at every step so far
    for step in range(2):
        state, want = jtr.train_step(state, jnp.asarray(imgs), jnp.asarray(labels),
                                     jax.random.PRNGKey(step))
        got = ptr.train_step(torch.from_numpy(imgs), torch.from_numpy(labels))
        assert ptr.opt.count == step + 1
        for k in ("loss", "acc_mean", "acc_tail", "grad_norm"):
            assert got[k].shape == ()
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step + 1} {k}")
        tol += 0.01 * lrs[step]
        want_p = var_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                          ptr.var.config)
        for name, p in ptr.var.named_parameters():
            w = want_p[name].numpy()
            if p.grad is None:
                np.testing.assert_array_equal(p.detach().numpy(), w, err_msg=name)
                continue
            g = p.grad.abs()
            firm[name] = firm[name] & (g > 1e-3 * g.max()).numpy()
            assert firm[name].any() and not torch.equal(p.detach(), p0[name]), name
            np.testing.assert_allclose(p.detach().numpy()[firm[name]], w[firm[name]], rtol=0,
                                       atol=tol, err_msg=f"step {step + 1} {name}")


def test_ema_copy_follows_the_trained_model(tokenizer):
    (jvae, vae_params), pvae, jcfg, imgs, labels = tokenizer
    _, _, pvar = _var_pair(jcfg, drop_path_rate=0.0, cond_drop_rate=0.0)
    tr = VARTrainer(pvae, pvar, VARTrainConfig(lr=1e-2, warmup_steps=1, ema=True))
    before = [p.detach().clone() for p in tr.ema_var.parameters()]
    tr.train_step(torch.from_numpy(imgs), torch.from_numpy(labels))
    for e, e0, p in zip(tr.ema_var.parameters(), before, pvar.parameters()):
        assert not e.requires_grad
        torch.testing.assert_close(e, e0 * 0.9999 + p.detach() * (1 - 0.9999), rtol=0, atol=1e-7)


def test_eval_step_and_ragged_var_eval_ep_match_jax(tokenizer):
    """eval_step's (B,) vectors, and var_eval_ep over batches of 2, 2 and a
    ragged 1 padded to 2, against the JAX package's."""
    (jvae, vae_params), pvae, jcfg, imgs, labels = tokenizer
    jvar, params, pvar = _var_pair(jcfg)
    tcfg = VARTrainConfig()
    jtr = jax_var_train.VARTrainer(jvae, jvar, jax_var_train.VARTrainConfig())
    ptr = VARTrainer(pvae, pvar, tcfg)
    want = jtr.eval_step(params, vae_params, jnp.asarray(imgs), jnp.asarray(labels))
    got = ptr.eval_step(torch.from_numpy(imgs), torch.from_numpy(labels))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    rng = np.random.default_rng(8)
    more = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    all_imgs = np.concatenate([imgs, more])
    all_labels = np.array([3, 7, 1, 0, 9])
    batches = [{"image": all_imgs[i:i + 2], "label": all_labels[i:i + 2]} for i in (0, 2, 4)]
    assert pad_to_batch(batches[-1]["image"], 2)[1] == 1
    want = jax_var_eval_ep(lambda x, y: jtr.eval_step(params, vae_params, x, y), batches, 2)
    got = var_eval_ep(lambda x, y: ptr.eval_step(torch.from_numpy(x), torch.from_numpy(y)),
                      batches, 2)
    assert got["val_tot"] == want["val_tot"] == 5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_cpu_train_step_launches_no_kernel(tokenizer):
    """On CPU tensors every kernel wrapper takes its plain version: a train
    and an eval step leave every launch counter as it was, and the frozen
    tokenizer gets no gradient."""
    (jvae, vae_params), pvae, jcfg, imgs, labels = tokenizer
    _, _, pvar = _var_pair(jcfg)
    tr = VARTrainer(pvae, pvar, VARTrainConfig(), generator=torch.Generator().manual_seed(0))
    counts = lambda: (pt_attn.LAUNCHES, pt_attn.FUSED_LAUNCHES,  # noqa: E731
                      pt_attn.FUSED_BWD_LAUNCHES, pt_codebook.LAUNCHES)
    before = counts()
    m = tr.train_step(torch.from_numpy(imgs), torch.from_numpy(labels))
    tr.eval_step(torch.from_numpy(imgs), torch.from_numpy(labels))
    assert counts() == before
    assert all(np.isfinite(v.item()) for v in m.values())
    assert not any(p.requires_grad or p.grad is not None for p in pvae.parameters())
