"""Port parity, tokenizer GAN training: ``imagefolder_tpu_torch/train/
tokenizer_train.py`` (with ``train/recipes.py``, the tokenizer's training
forward and the optimizer labels) against the JAX package on the CPU, on
the same numpy-seeded inputs and params.

The flagship recipe cut to a tiny preset: ViT width 256, depth 2, 4 heads of
64 for the encoder, the decoder and the DINOv2 semantic teacher; PQ2 over
scales (1, 1, 2) of a 16 x 8 codebook, 4 latents per branch; 32 px images,
so that DinoDisc (ViT-S/16 trunk at depth 3, one readout after block 2)
takes the bicubic resize and no crop draw. Every step runs in fp32.

- ``cosine_with_warmup``, and the frozen / decay / no-decay label of every
  tokenizer and DinoDisc parameter against the JAX labels of its flax path;
- ``VQModel``'s training forward with an injected dropout draw: the
  reconstruction, ``pre_last``, every loss and the hits, and the gradients
  of a scalar of them;
- one and two ``TokenizerTrainer.train_step``s against the JAX trainer from
  the same state, with ``aug_prob`` and ``codebook_drop`` 0 (the JAX step
  then draws nothing that matters): every metric, every clipped gradient of
  the generator and the disc heads (the JAX one read off Adam's first
  moment), the parameters and the spectral state after each step;
- one step with the draws injected into both sides (quantizer dropout and
  the three DiffAug calls; ``jax.random`` patched inside the test), the clip
  off, so that the raw gradients and both gradient norms compare;
- the CPU step launches no kernel.

Tolerances: metrics 1e-5 relative (1e-6 absolute; 1e-4 for the adaptive
weight, a ratio of gradient norms, and ``gen_loss``); gradients 1e-4 of each
tensor's max abs (two frameworks' fp32 summation orders through LPIPS, the
disc and two ViTs); parameters after AdamW steps within 1% of the step's lr
wherever the gradient is above 1e-3 of its tensor's max (AdamW's first
steps are about lr * sign(g), which a gradient near 0 may flip), and within
2.2 lr everywhere. The heads' conv biases feed a BatchNormLocal, which
removes them: their gradients are zero in exact arithmetic, held as such,
and AdamW's steps on that rounding noise only to the 2.2 lr bound.

The seeds keep every input of LPIPS's ReLUs and max-pools and of the disc
heads' LeakyReLUs off its kink by more than the two frameworks' fp32
rounding: an element within it may take the other branch on one side and
send its gradient down the other way (seeds 1 to 4 of the draws test have
one each, and a decoder or disc-head gradient then misses its bound).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu.train import tokenizer_train as jax_tt
from imagefolder_tpu.train.recipes import flagship_gan_recipe as jax_recipe
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.ops.cuda import codebook as pt_codebook
from imagefolder_tpu_torch.train import optim
from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainConfig, TokenizerTrainer
from imagefolder_tpu_torch.utils.convert import (
    dinodisc_state_dict_from_flax,
    lpips_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_gan_vit"
TINY_PRESET = dict(embed_dim=256, depth=2, num_heads=4)
B, PX = 4, 32
MARGS = dict(encoder_model=TINY, decoder_model=TINY, codebook_size=16, codebook_embed_dim=8,
             v_patch_nums=(1, 1, 2), num_latent_tokens=4, image_size=PX, dtype_str="float32")
TCFG = dict(image_size=PX, dino_depth=3, steps_per_epoch=2)
ZERO_GRAD = r"heads\.\d+\.b\d\.conv\.bias"  # zero in exact arithmetic
G_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _np(t):
    return t.detach().float().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _recipes(margs=None, tcfg=None):
    margs, tcfg = {**MARGS, **(margs or {})}, {**TCFG, **(tcfg or {})}
    return (jax_recipe(B, margs_overrides=margs, tcfg_overrides=tcfg),
            flagship_gan_recipe(B, margs_overrides=margs, tcfg_overrides=tcfg))


def _pair(margs=None, tcfg=None, seed=0):
    """A JAX trainer with its initial state and a port trainer loaded from
    it, plus a batch of images."""
    (jm, jt), (pm, pt) = _recipes(margs, tcfg)
    x = np.random.default_rng(seed).uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    jtr = jax_tt.TokenizerTrainer(jm, jt)
    state = jtr.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ptr = TokenizerTrainer(pm, pt, generator=torch.Generator().manual_seed(seed), device="cpu")
    ptr.model.load_state_dict(vqmodel_state_dict_from_flax(_tree_np(state.params), pm),
                              strict=True)
    ptr.lpips.load_state_dict(lpips_state_dict_from_flax(_tree_np(state.lpips_params)),
                              strict=True)
    ptr.disc.load_state_dict(dinodisc_state_dict_from_flax(_tree_np(state.disc_params),
                                                           _tree_np(state.disc_vars)),
                             strict=True)
    ptr.sync_ema()
    return jtr, state, ptr, x


def _check_metrics(got, want, step):
    assert set(want) <= set(got) and set(got) - set(want) == {"grad_norm", "disc_grad_norm"}
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        # the adaptive weight is a ratio of two gradient norms, and gen_loss
        # carries it: they compare as gradients do
        rtol = G_TOL if k in ("disc_adaptive_weight", "gen_loss") else 1e-5
        np.testing.assert_allclose(_np(got[k]), w, rtol=rtol, atol=1e-6,
                                   err_msg=f"step {step} {k}")


def _jax_first_grads(opt_state, b1):
    """flax path -> the gradient that Adam saw at its first step (mu / (1 - b1))."""
    out = {}
    states = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    for s in states:
        if isinstance(s, optax.ScaleByAdamState):
            for path, v in jax.tree_util.tree_flatten_with_path(s.mu)[0]:
                out[_path(path)] = np.asarray(v) / (1 - b1)
    return out


def _grad_tree(params, grads):
    """The params tree with each leaf replaced by its gradient (0 where the
    optimizer has none: frozen)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: grads.get(_path(p), np.zeros_like(np.asarray(v))), _tree_np(params))


def _check_grads(module, want_sd, what):
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    assert names
    for name, p in module.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        w = want_sd[name].numpy()
        g = _np(p.grad)
        if re.fullmatch(ZERO_GRAD, name):
            scale = np.abs(_np(dict(module.named_parameters())[name[:-4] + "weight"].grad)).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= G_TOL * scale, name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=G_TOL * max(np.abs(w).max(), 1e-12),
                                   err_msg=f"{what} {name}")


def _check_grads_against_jax(ptr, state, pm):
    b1 = ptr.tcfg.beta1
    g = _jax_first_grads(state.opt_state, b1)
    _check_grads(ptr.model, vqmodel_state_dict_from_flax(_grad_tree(state.params, g), pm),
                 "generator")
    dg = _jax_first_grads(state.disc_opt_state, b1)
    _check_grads(ptr.disc, dinodisc_state_dict_from_flax(
        _grad_tree(state.disc_params, dg), _tree_np(state.disc_vars)), "disc")


# ------------------------- schedule and labels ------------------------- #

@pytest.mark.parametrize("warmup,total", [(0, 20), (1, 20), (5, 20), (5, 5)])
def test_cosine_with_warmup_matches_jax(warmup, total):
    want_fn = jax_optim.cosine_with_warmup(1e-4, warmup, total, 5e-5)
    got_fn = optim.cosine_with_warmup(1e-4, warmup, total, 5e-5)
    got = [got_fn(s) for s in range(total + 3)]
    np.testing.assert_allclose(got, [float(want_fn(s)) for s in range(total + 3)], rtol=1e-6,
                               atol=1e-12)
    assert got[0] == 0.0  # counts from 0: the first lr is 0


def test_optimizer_labels_match_jax():
    """Every trainable port parameter is a flax leaf of the JAX trainer's
    tree; frozen (requires_grad False, out of the optimizer) exactly where
    JAX labels it frozen, decayed exactly where it labels it 'default'. The
    Phi that no scale applies has no flax leaf and stays out."""
    jtr, state, ptr, _ = _pair()
    for what, tree, module, opt, frozen_fn, paths in (
            ("tokenizer", state.params, ptr.model, ptr.gen_opt,
             jax_optim.tokenizer_frozen_predicate(jtr.model_cfg),
             optim.module_flax_paths(ptr.model)),
            ("disc", state.disc_params, ptr.disc, ptr.disc_opt, jax_optim.disc_frozen_predicate,
             optim.module_flax_paths(ptr.disc))):
        leaves = {_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
        decay = {id(p) for p in opt.opt.param_groups[0]["params"]}
        plain = {id(p) for p in opt.opt.param_groups[1]["params"]}
        n_frozen = 0
        for name, p in module.named_parameters():
            path = paths[name]
            if path not in leaves:  # a never-applied Phi
                assert re.search(r"quant_resi", name) and not p.requires_grad, name
                continue
            frozen = frozen_fn(path)
            n_frozen += frozen
            assert p.requires_grad == (not frozen), (what, name, path)
            if not frozen:
                want_decay = not jax_optim.no_decay_predicate(path)
                assert (id(p) in decay, id(p) in plain) == (want_decay, not want_decay), \
                    (what, name, path)
        assert n_frozen > 0
        assert len(decay) + len(plain) == sum(p.requires_grad for p in module.parameters())


# -------------------------- training forward -------------------------- #

def test_vqmodel_training_forward_matches_jax(monkeypatch):
    """codebook_drop 0.5 (the first 2 of 4 samples adopt the draw, and
    leave the semantic loss), dropout draw injected into both sides."""
    (jm, _), (pm, _) = _recipes(dict(codebook_drop=0.5, start_drop=1))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    dropout_n = np.array([1, 2, 3, 2], np.int32)
    jmod = JaxVQModel(jm)
    params = _tree_np(jax.jit(lambda k, xx: jmod.init(k, xx, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    w = rng.normal(size=(B, PX, PX, 3)).astype(np.float32)
    real_randint = jax.random.randint

    def randint(key, shape, *a, **k):  # the per-sample dropout draw
        return jnp.asarray(dropout_n) if tuple(shape) == (B,) else real_randint(key, shape,
                                                                                *a, **k)

    monkeypatch.setattr(jax.random, "randint", randint)

    def scalar(out, w):
        return ((out.dec * w).sum() + out.vq_loss + out.commit_loss + out.sem_loss
                + out.dependency_loss + (out.pre_last ** 2).mean())

    def jax_loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), train=True, rng=jax.random.PRNGKey(1))
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.value_and_grad(jax_loss, has_aux=True)(params)
    monkeypatch.undo()
    model = VQModel(pm, device="cpu")
    model.load_state_dict(vqmodel_state_dict_from_flax(params, pm), strict=True)
    got = model(torch.from_numpy(x), train=True, dropout_n=torch.from_numpy(dropout_n))
    scalar(got, torch.from_numpy(w)).backward()
    assert got.pre_last.shape == (B, (PX // 16) ** 2, 256)
    for k in ("dec", "pre_last", "vq_loss", "commit_loss", "entropy_loss", "sem_loss",
              "detail_loss", "dependency_loss"):
        wv = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(got, k)), wv, rtol=0,
                                   atol=1e-5 * max(np.abs(wv).max(), 1.0), err_msg=k)
    np.testing.assert_array_equal(_np(got.hits_PSV), np.asarray(want.hits_PSV))
    assert got.sem_loss.item() > 0
    want_g = vqmodel_state_dict_from_flax(_tree_np(gp), pm)
    for name, p in model.named_parameters():
        if name.startswith("semantic_model."):
            assert p.grad is None, name
            continue
        if p.grad is None:  # a never-applied Phi: no flax leaf, zero-filled
            assert not want_g[name].numpy().any(), name
            continue
        wg = want_g[name].numpy()
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=G_TOL * max(np.abs(wg).max(), 1e-12), err_msg=name)


# ------------------------------ train steps ------------------------------ #

@pytest.fixture(scope="module")
def steps_pair():
    return _pair(tcfg=dict(aug_prob=0.0), margs=dict(codebook_drop=0.0))


def test_train_steps_match_jax(steps_pair):
    """Two steps: the metrics, the clipped gradients of the first (lr 0)
    step, the parameters (generator, disc heads, spectral state, EMA) after
    each, and the LeCam and usage state."""
    jtr, state, ptr, x = steps_pair
    pm = ptr.model_cfg
    lr_g = optim.cosine_with_warmup(ptr.tcfg.lr, 2, 2, ptr.tcfg.min_lr)
    lr_d = optim.cosine_with_warmup(ptr.tcfg.disc_lr, 1, 2, ptr.tcfg.min_lr)
    firm = {}
    tol = {"model": 0.0, "disc": 0.0}
    for step in range(2):
        state, want = jtr.train_step(state, jnp.asarray(x), jax.random.PRNGKey(step))
        got = ptr.train_step(torch.from_numpy(x))
        _check_metrics(got, want, step)
        assert ptr.step == step + 1 and ptr.gen_opt.count == step + 1
        if step == 0:
            _check_grads_against_jax(ptr, state, pm)
        tol["model"] += lr_g(step)
        tol["disc"] += lr_d(step)
        for what, module, sd in (
                ("model", ptr.model, vqmodel_state_dict_from_flax(_tree_np(state.params), pm)),
                ("disc", ptr.disc, dinodisc_state_dict_from_flax(
                    _tree_np(state.disc_params), _tree_np(state.disc_vars)))):
            for name, v in module.state_dict().items():
                w = sd[name].numpy()
                p = dict(module.named_parameters()).get(name)
                if p is None or not p.requires_grad:  # frozen, buffers, spectral state
                    np.testing.assert_allclose(_np(v), w, rtol=0, atol=1e-6,
                                               err_msg=f"step {step + 1} {name}")
                    continue
                g = p.grad.abs()
                key = (what, name)
                firm[key] = firm.get(key, True) & (g > 1e-3 * g.max()).numpy()
                np.testing.assert_allclose(_np(v), w, rtol=0, atol=2.2 * tol[what] + 1e-7,
                                           err_msg=f"step {step + 1} {name}")
                if re.fullmatch(ZERO_GRAD, name):  # AdamW steps on rounding noise
                    continue
                np.testing.assert_allclose(_np(v)[firm[key]], w[firm[key]], rtol=0,
                                           atol=0.01 * tol[what] + 1e-7,
                                           err_msg=f"step {step + 1} {name} (firm)")
    ema = vqmodel_state_dict_from_flax(_tree_np(state.ema_params), pm)
    for (name, _), e in zip(ptr.model.named_parameters(), ptr.ema_params):
        np.testing.assert_allclose(_np(e), ema[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(_np(ptr.usage_ema), np.asarray(state.usage_ema), atol=1e-6)
    assert ptr.record_hit == int(state.record_hit) == 2
    for a, b in zip(ptr.lecam, (state.lecam.logits_real_ema, state.lecam.logits_fake_ema)):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, atol=1e-8)


def _patched_draws(monkeypatch, dropout_n, augs):
    """jax.random.randint/uniform returning the step's draws in the JAX
    step's trace order: the dropout draw; then the uniforms of the three
    DiffAug calls, the generator pass's twice (its adaptive-weight head
    replays it with the same key), then the fake and the real images'."""
    queue = []
    for d in augs:
        queue += [d["gates"], *d["translate"], *d["color"], *d["cutout"]]
    queue = [np.asarray(v) for v in queue]
    real_randint, real_uniform = jax.random.randint, jax.random.uniform

    def randint(key, shape, *a, **k):
        return jnp.asarray(dropout_n) if tuple(shape) == (B,) else real_randint(key, shape,
                                                                                *a, **k)

    def uniform(key, shape=(), *a, **k):
        if queue and tuple(shape) == queue[0].shape:
            return jnp.asarray(queue.pop(0))
        return real_uniform(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    return queue


def test_train_step_with_injected_draws_matches_jax(monkeypatch):
    """aug_prob 0.5 (two of the generator pass's three gates open), the
    quantizer dropout on the first 2 samples, the clip off: metrics, both
    gradient norms and every raw gradient."""
    jtr, state, ptr, x = _pair(margs=dict(codebook_drop=0.5, start_drop=1),
                               tcfg=dict(aug_prob=0.5, max_grad_norm=1e9), seed=5)
    gen = np.random.default_rng(5)
    u = lambda *s: gen.uniform(size=s).astype(np.float32)  # noqa: E731
    augs = {k: {"gates": np.asarray(g, np.float32), "translate": (u(B, 1, 1), u(B, 1, 1)),
                "color": (u(B, 1, 1, 1), u(B, 1, 1, 1), u(B, 1, 1, 1)),
                "cutout": (u(B, 1, 1), u(B, 1, 1))}
            for k, g in (("aug_g", (0.1, 0.7, 0.3)), ("aug_f", (0.4, 0.2, 0.9)),
                         ("aug_r", (0.6, 0.1, 0.2)))}
    dropout_n = np.array([1, 2, 3, 3], np.int32)
    left = _patched_draws(monkeypatch, dropout_n,
                          [augs["aug_g"], augs["aug_g"], augs["aug_f"], augs["aug_r"]])
    state, want = jtr.train_step(state, jnp.asarray(x), jax.random.PRNGKey(0))
    assert not left  # JAX drew exactly these
    monkeypatch.undo()
    draws = {"dropout_n": torch.from_numpy(dropout_n).long(),
             **{k: {n: torch.from_numpy(v) if n == "gates" else tuple(map(torch.from_numpy, v))
                    for n, v in d.items()} for k, d in augs.items()}}
    got = ptr.train_step(torch.from_numpy(x), draws=draws)
    _check_metrics(got, want, 0)
    _check_grads_against_jax(ptr, state, ptr.model_cfg)
    for what, module, opt_state in (("model", ptr.model, state.opt_state),
                                    ("disc", ptr.disc, state.disc_opt_state)):
        g = _jax_first_grads(opt_state, ptr.tcfg.beta1)
        want_norm = np.sqrt(sum(np.square(v.astype(np.float64)).sum() for v in g.values()))
        key = "grad_norm" if what == "model" else "disc_grad_norm"
        np.testing.assert_allclose(got[key].item(), want_norm, rtol=1e-5, err_msg=key)
    assert got["grad_norm"].item() > 1.0  # the default clip would have acted


def test_cpu_train_step_launches_no_kernel():
    """On CPU tensors every kernel wrapper takes its plain version."""
    (_, _), (pm, pt) = _recipes()
    tr = TokenizerTrainer(pm, pt, generator=torch.Generator().manual_seed(0), device="cpu")
    counts = lambda: (pt_attn.LAUNCHES, pt_attn.BWD_LAUNCHES,  # noqa: E731
                      pt_attn.FUSED_LAUNCHES, pt_attn.FUSED_BWD_LAUNCHES, pt_codebook.LAUNCHES)
    before = counts()
    x = torch.rand((B, PX, PX, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    m = tr.train_step(x, fade_blur=0.5)
    assert counts() == before
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert tr.model.semantic_model.blocks[0].attn.qkv.weight.grad is None


def test_config_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(TokenizerTrainConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_tt.TokenizerTrainConfig)]
