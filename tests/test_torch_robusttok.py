"""Port parity, single-scale tokenizer training and RobustTok: the port
against the JAX package on the CPU, on the same numpy-seeded inputs and
params.

- ``add_perturbation`` with JAX's own uniforms (drawn from the key it is
  given) for alpha in {0, 0.5, 1}, the codebook norm on and off and an
  annealed top-k budget (``delta_eff`` < ``delta``): the output, the chosen
  codes (equal but where two candidates' distances tie within 1e-5: such
  near ties are counted and must be rare) and the gradient;
- ``SingleVQ``'s training call: its losses, ``f_hat``, hits and the
  gradients in the latents and the codebook;
- a ``pre_norm`` ViT backbone (CLIP's ``norm_pre``), forward and gradient;
- ``siglip_loss``;
- the tiny single-scale ``VQModel`` training forward: RobustTok's (one
  branch, the CLIP detail teacher, the perturbation of the first two of
  four samples with JAX's draws) and VP2's (P = 2), every output and every
  gradient;
- two ``TokenizerTrainer`` steps of ``configs/RobustTok.yaml`` through
  both packages' loaders, beta 0.5: the first at the trainers' defaults
  (delta_ratio 1) with alpha 0.5, the second inside the anneal window
  (alpha = delta_ratio = 0.75); two micro-steps of ``VQ-4096.yaml`` with
  ``grad_accum_steps=2``; one step of ``VP2-4096.yaml`` with the loss
  stack cut to the tokenizer's own losses;
- ``ScheduledAdamW`` with ``grad_accum_steps=2`` over four micro-steps
  against ``optax.MultiSteps`` (the JAX package's ``adamw_with_freezing``),
  with the clip acting and not;
- ``get_random_ratio`` against the training CLI's.

The tiny preset: width 768 (the detail teacher's feature goes through the
encoder's ``quant_conv``, so the encoder must be 768 wide), depth 1, 12
heads of 64, for the encoder, the decoder, the DINOv2 teacher and the CLIP
teacher (``pre_norm``, no LayerScale); 32 px images, 4 latents, a 32 x 8
codebook, top-k budget 8; DinoDisc at depth 1 (its pre-trunk head),
``aug_prob`` 0 (so that the two packages' DiffAug draws do not matter).
Every step runs in fp32.

Tolerances: the perturbation's and the quantizer's values 1e-6 of their
max abs and their gradients 1e-5; the forward's outputs and losses 1e-5 of
max(|value|, 1) and its gradients 1e-4 of each tensor's max abs; trainer
metrics and gradients as ``test_torch_tokenizer_train.py`` holds them;
parameters after two steps within 2.2 lr everywhere and 1% of lr where
every step's gradient is above 1e-2 of its tensor's max.
"""

import dataclasses
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from imagefolder_tpu.losses.clip_loss import siglip_loss as jax_siglip
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.ops.perturb import add_perturbation as jax_perturb
from imagefolder_tpu.ops.quantize import SingleVQ as JaxSingleVQ
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu.train import tokenizer_train as jax_tt
from imagefolder_tpu.utils import config as jax_config
from imagefolder_tpu_torch.losses.clip_loss import siglip_loss
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.ops.perturb import add_perturbation
from imagefolder_tpu_torch.ops.quantize import SingleVQ
from imagefolder_tpu_torch.train import optim
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer, get_random_ratio
from imagefolder_tpu_torch.utils import config as pt_config
from imagefolder_tpu_torch.utils.convert import (
    _put_vit_backbone,
    dinodisc_state_dict_from_flax,
    lpips_state_dict_from_flax,
    to_torch,
    vqmodel_state_dict_from_flax,
)
from test_torch_tokenizer_train import (
    _check_grads,
    _check_grads_against_jax,
    _check_metrics,
    _grad_tree,
    _jax_first_grads,
    _np,
    _tree_np,
)
from tests._torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = "tiny_robusttok_vit"
CLIP = "vit_base_patch16_clip_224.openai"
TINY_PRESET = dict(embed_dim=768, depth=1, num_heads=12)
CLIP_PRESET = dict(embed_dim=768, depth=1, num_heads=12, init_values=None, pre_norm=True)
B, PX = 4, 32
NEAR_TIE = 1e-5
# the loaders' overrides that cut a shipped YAML to the tiny preset
TINY_YAML = dict(encoder_model=TINY, decoder_model=TINY, image_size=PX, num_latent_tokens=4,
                 codebook_size=32, codebook_embed_dim=8, mixed_precision="none", aug_prob=0.0)
ROBUSTTOK = dict(delta=8)  # RobustTok's top-k budget of 100 cut to the 32-code codebook
TINY_TCFG = dict(dino_depth=1, steps_per_epoch=2)
# the trainer tests' seed: it keeps every input of a ReLU, LeakyReLU or
# max-pool off its kink by more than the two packages' rounding (seeds 3, 4,
# 5 and 7 have such an element in one of the steps, whose branch then
# differs and sends a disc head's or the decoder's gradient past its bound)
SEED = 6


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        for presets in (jax_vit.VIT_PRESETS, pt_vit.VIT_PRESETS):
            mp.setitem(presets, TINY, TINY_PRESET)
            mp.setitem(presets, CLIP, CLIP_PRESET)
        yield


def _close(got, want, rel, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=msg)


def _l2n(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _near_ties(got, want, z, codebook, norm):
    """Positions where the chosen codes differ; each must be a near tie of
    the two codes' fp64 distances. Returns their count."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return 0
    z = np.asarray(z, np.float64).reshape(-1, codebook.shape[-1])
    e = np.asarray(codebook, np.float64)
    if norm:
        z, e = _l2n(z), _l2n(e)
    d = ((z[:, None] - e[None]) ** 2).sum(-1)
    gap = np.abs(d[diff, got[diff]] - d[diff, want[diff]])
    assert (gap <= NEAR_TIE).all(), (diff, gap)
    return diff.size


def _perturb_uniforms(key, n):
    """The two uniforms ``add_perturbation`` draws from ``key``."""
    k_prob, k_idx = jax.random.split(key)
    return (np.array(jax.random.uniform(k_prob, (n,))),
            np.array(jax.random.uniform(k_idx, (n,))))


# ------------------------------ perturbation ------------------------------ #

@pytest.fixture(scope="module")
def jax_perturb_fns():
    """``add_perturbation`` and its gradient in z, jitted once per norm."""
    def make(norm):
        def f(z, zq, cb, w, alpha, beta, delta_eff, key):
            out = jax_perturb(z, zq, cb, alpha=alpha, beta=beta, delta=8, key=key,
                              codebook_norm=norm, delta_eff=delta_eff)
            return jnp.sum(out * w), out
        return jax.jit(jax.value_and_grad(f, has_aux=True))
    return {norm: make(norm) for norm in (False, True)}


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_add_perturbation_matches_jax(jax_perturb_fns, alpha, norm):
    """B = 4, beta 0.5 (the first two samples), the budget 8 annealed to
    delta_eff = 0.6 * 8 = 4.8: with alpha 0 every code stays the nearest,
    with 1 every one of the first two samples' codes is re-drawn."""
    rng = np.random.default_rng(int(alpha * 10) + norm)
    z = rng.normal(size=(B, 4, 4, 8)).astype(np.float32)
    cb = rng.normal(size=(32, 8)).astype(np.float32)
    zq = rng.normal(size=z.shape).astype(np.float32)  # stands for the quantizer's output
    w = rng.normal(size=z.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    (_, want), want_gz = jax_perturb_fns[norm](jnp.asarray(z), jnp.asarray(zq), jnp.asarray(cb),
                                               jnp.asarray(w), alpha, 0.5, 0.6 * 8, key)
    u = _perturb_uniforms(key, B * 16)
    zt = torch.from_numpy(z).requires_grad_(True)
    got = add_perturbation(zt, torch.from_numpy(zq), torch.from_numpy(cb), alpha=alpha,
                           beta=0.5, delta=8, delta_eff=0.6 * 8, codebook_norm=norm,
                           draws=tuple(map(torch.from_numpy, u)))
    (got * torch.from_numpy(w)).sum().backward()
    _close(_np(got), want, 1e-6, "perturbed latents")
    _close(_np(zt.grad), want_gz, 1e-5, "gradient in z")
    np.testing.assert_array_equal(_np(got)[2:], zq[2:])  # beyond floor(B * beta): untouched
    # the chosen code of each perturbed token: the nearest row of the output
    e = _l2n(cb) if norm else cb
    pick = lambda o: np.abs(o[:2].reshape(-1, 1, 8) - e[None]).sum(-1).argmin(-1)  # noqa: E731
    flips = _near_ties(pick(_np(got)), pick(np.asarray(want)), z[:2], cb, norm)
    assert flips <= 1
    nearest = (((_l2n(z[:2]) if norm else z[:2]).reshape(-1, 1, 8) - e[None]) ** 2).sum(-1)
    moved = (pick(np.asarray(want)) != nearest.argmin(-1)).mean()
    if alpha == 0.0:
        assert moved == 0
    else:
        assert moved > 0.2  # the perturbation is exercised


def test_add_perturbation_draws_from_its_generator():
    """Without ``draws`` the two uniforms come from ``generator``, in
    ``draw_perturbation``'s order; beta small enough perturbs nothing."""
    from imagefolder_tpu_torch.ops.perturb import draw_perturbation
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(2, 2, 2, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    kw = dict(alpha=1.0, beta=0.5, delta=8)
    got = add_perturbation(z, z, cb, generator=torch.Generator().manual_seed(5), **kw)
    want = add_perturbation(z, z, cb, **kw, draws=draw_perturbation(
        8, torch.Generator().manual_seed(5), torch.device("cpu")))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(add_perturbation(z, z, cb, **{**kw, "beta": 0.1}), z)


# ------------------------------- SingleVQ ------------------------------- #

@pytest.mark.parametrize("norm", [True, False])
def test_single_vq_training_call_matches_jax(norm):
    rng = np.random.default_rng(11 + norm)
    z = rng.normal(size=(B, 4, 4, 8)).astype(np.float32)
    w = rng.normal(size=z.shape).astype(np.float32)
    jq = JaxSingleVQ(32, 8, 0.3, norm)
    params = _tree_np(jax.jit(lambda k, x: jq.init(k, x))(jax.random.PRNGKey(0),
                                                          jnp.asarray(z))["params"])

    def loss(p, x):
        out = jq.apply({"params": p}, x, train=True)
        return jnp.sum(out.f_hat * w) + out.vq_loss + 3.0 * out.commit_loss, out

    (_, want), (gp, gz) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(z))
    q = SingleVQ(32, 8, norm, beta=0.3)
    q.embedding.weight.data.copy_(torch.from_numpy(params["codebook"]))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = q(zt, train=True)
    ((got.f_hat * torch.from_numpy(w)).sum() + got.vq_loss + 3.0 * got.commit_loss).backward()
    for k in ("f_hat", "vq_loss", "commit_loss", "entropy_loss"):
        _close(_np(getattr(got, k)), getattr(want, k), 1e-6, k)
    np.testing.assert_array_equal(_np(got.hits_SV), np.asarray(want.hits_SV))
    assert got.hits_SV.shape == (1, 32) and got.hits_SV.sum() == B * 16
    _close(_np(zt.grad), gz, 1e-5, "gradient in z")
    _close(_np(q.embedding.weight.grad), gp["codebook"], 1e-5, "gradient in the codebook")


# --------------------------- ViT, losses --------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pre_norm_backbone_matches_jax(dtype):
    """A backbone as the CLIP teacher builds it (no LayerScale,
    ``norm_pre``), at width 64 and 32 px: forward and image gradient; bf16
    within 2e-2 of the max abs."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)
    kw = dict(img_size=PX, patch_size=16, embed_dim=64, depth=1, num_heads=1,
              init_values=None, pre_norm=True)
    jm = jax_vit.ViTBackbone(**kw, dtype=jnp.dtype(dtype))
    params = _tree_np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(img))["params"])
    params["norm_pre"] = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
                          "bias": rng.normal(size=64).astype(np.float32) * 0.1}
    w = rng.normal(size=(2, 5, 64)).astype(np.float32)
    def fwd_and_grad(x, w):
        out, vjp = jax.vjp(lambda xx: jm.apply({"params": params}, xx).astype(jnp.float32), x)
        return out, vjp(w)[0]

    want, want_g = jax.jit(fwd_and_grad)(jnp.asarray(img), jnp.asarray(w))
    pm = pt_vit.ViTBackbone(**kw, dtype=getattr(torch, dtype))
    sd = {}
    _put_vit_backbone(sd, params, "")
    pm.load_state_dict(to_torch(sd), strict=True)
    assert pm.norm_pre is not None and pm.blocks[0].ls1 is None
    x = torch.from_numpy(img).requires_grad_(True)
    got = pm(x).float()
    (got * torch.from_numpy(w)).sum().backward()
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close(_np(got), want, rel, "tokens")
    _close(_np(x.grad), want_g, rel * 5, "image gradient")


def test_siglip_loss_matches_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    for scale, bias in ((1.0, 0.0), (10.0, -10.0)):
        want = jax_siglip(jnp.asarray(a), jnp.asarray(b), scale, bias)
        got = siglip_loss(torch.from_numpy(a), torch.from_numpy(b), scale, bias)
        _close(got.item(), want, 1e-6)


# ------------------------- the training forward ------------------------- #

def _yaml_pair(name, **extra):
    """A shipped YAML through both packages' loaders with the tiny
    overrides: their (ModelArgs, trainer config) pairs, the trainer
    configs cut to ``TINY_TCFG``, and the run config."""
    overrides = {**TINY_YAML, **extra}
    jm, jt, run = jax_config.load_tokenizer_config(str(ROOT / "configs" / name), overrides)
    pm, pt, prun = pt_config.load_tokenizer_config(str(ROOT / "configs" / name), overrides)
    assert dataclasses.asdict(run) == dataclasses.asdict(prun)
    cut = lambda cfg: dataclasses.replace(cfg, **TINY_TCFG)  # noqa: E731
    return (jm, cut(jt)), (pm, cut(pt)), run


@pytest.mark.parametrize("config", ["robusttok", "vp2"])
def test_single_scale_training_forward_matches_jax(request, config):
    """RobustTok: one branch, the CLIP detail teacher, the perturbation of
    the first two of four samples (alpha 1, beta 0.5, delta_ratio 0.75) with
    JAX's uniforms; VP2: two branches (no perturbation), both teachers. The
    params come from the config's JAX trainer's (compiled) ``init``."""
    pair = request.getfixturevalue(config)
    jm, pm = pair.jtr.model_cfg, pair.pm
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jmod = JaxVQModel(jm)
    params = _tree_np(pair.init_jtr.init(jax.random.PRNGKey(0), jnp.asarray(x)).params)
    assert "detail_model" in params and "norm_pre" in params["detail_model"]
    kw = dict(alpha=1.0, beta=0.5, delta_ratio=0.75, epoch=3)
    key = jax.random.PRNGKey(4)

    def scalar(out, w):
        return ((out.dec * w).sum() + out.vq_loss + out.commit_loss + out.sem_loss
                + out.detail_loss + out.dependency_loss + (out.pre_last ** 2).mean())

    def jax_loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), train=True, rng=key, **kw)
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    model = VQModel(pm, device="cpu")
    model.load_state_dict(vqmodel_state_dict_from_flax(params, pm), strict=True)
    perturb = None
    if pm.product_quant == 1:
        _, k = jax.random.split(key)  # the model's split before add_perturbation
        perturb = tuple(map(torch.from_numpy, _perturb_uniforms(k, B * 4)))
    got = model(torch.from_numpy(x), train=True, perturb=perturb, **kw)
    scalar(got, torch.from_numpy(w)).backward()
    for k in ("dec", "pre_last", "vq_loss", "commit_loss", "entropy_loss", "sem_loss",
              "detail_loss", "dependency_loss"):
        wv = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(got, k)), wv, rtol=0,
                                   atol=1e-5 * max(np.abs(wv).max(), 1.0), err_msg=k)
    np.testing.assert_array_equal(_np(got.hits_PSV), np.asarray(want.hits_PSV))
    assert got.hits_PSV.shape == (pm.product_quant, 1, 32)
    assert got.detail_loss.item() > 0 and got.sem_loss.item() > 0
    want_g = vqmodel_state_dict_from_flax(_tree_np(gp), pm)
    n = 0
    for name_, p in model.named_parameters():
        if name_.startswith(("semantic_model.", "detail_model.")):
            assert p.grad is None, name_
            continue
        wg = want_g[name_].numpy()
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=1e-4 * max(np.abs(wg).max(), 1e-12), err_msg=name_)
        n += 1
    assert n > 20


# ------------------------------ trainer steps ------------------------------ #

class _Pair:
    """A JAX trainer and, from each ``fresh`` call, its initial state at a
    seed and a port trainer loaded from it, both built from the same YAML
    through each package's loader. ``init_from`` (a pair whose model has
    the same parameters) lends its compiled ``init``: the state's optimizer
    states are then this trainer's own."""

    def __init__(self, name, tcfg=None, init_from=None, **extra):
        (jm, jt), (self.pm, pt), self.run = _yaml_pair(name, **extra)
        self.jtr = jax_tt.TokenizerTrainer(jm, dataclasses.replace(jt, **(tcfg or {})))
        self.pt = dataclasses.replace(pt, **(tcfg or {}))
        self.init_jtr = init_from.jtr if init_from else self.jtr

    def fresh(self, seed):
        x = np.random.default_rng(seed).uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
        state = self.init_jtr.init(jax.random.PRNGKey(seed), jnp.asarray(x))
        if self.init_jtr is not self.jtr:
            state = dataclasses.replace(
                state, opt_state=self.jtr.gen_tx.init(state.params),
                disc_opt_state=self.jtr.disc_tx.init(state.disc_params))
        ptr = TokenizerTrainer(self.pm, self.pt, generator=torch.Generator().manual_seed(seed),
                               device="cpu")
        ptr.model.load_state_dict(vqmodel_state_dict_from_flax(_tree_np(state.params), self.pm),
                                  strict=True)
        ptr.lpips.load_state_dict(lpips_state_dict_from_flax(_tree_np(state.lpips_params)),
                                  strict=True)
        ptr.disc.load_state_dict(dinodisc_state_dict_from_flax(_tree_np(state.disc_params),
                                                               _tree_np(state.disc_vars)),
                                 strict=True)
        ptr.sync_ema()
        return state, ptr, x


def _step(jtr, state, ptr, x, step, jax_kw=None, **kw):
    """One step of each (the JAX one with ``jax_kw`` when given, else
    ``kw``) from the JAX key PRNGKey(step), the perturbation's uniforms
    taken from that key as the JAX step draws them."""
    key = jax.random.PRNGKey(step)
    state, want = jtr.train_step(state, jnp.asarray(x), key, **(kw if jax_kw is None else jax_kw))
    draws = {}
    if ptr.model_cfg.perturb_delta_max and ptr.model_cfg.product_quant == 1:
        k_model = jax.random.split(key, 5)[0]
        _, k = jax.random.split(k_model)  # the model's split before add_perturbation
        draws["perturb"] = tuple(map(torch.from_numpy, _perturb_uniforms(k, B * 4)))
    got = ptr.train_step(torch.from_numpy(x), draws=draws, **kw)
    return state, want, got


def _firm(ptr, firm=None):
    """Where each gradient is above 1e-2 of its tensor's max, and-ed over
    the steps so far: there the gradient's rounding is under 1% of it, and
    so AdamW's step within 1% of the lr."""
    out = {}
    for n, p in ptr.model.named_parameters():
        if p.grad is not None:
            g = p.grad.abs()
            out[n] = (g > 1e-2 * g.max()).numpy() & (firm or {}).get(n, True)
    return out


def _check_params(ptr, state, tol_lr, firm):
    """Parameters within 2.2 x the lrs so far everywhere, and within 1% of
    them where ``firm``; frozen ones within 1e-6."""
    sd = vqmodel_state_dict_from_flax(_tree_np(state.params), ptr.model_cfg)
    for name, p in ptr.model.named_parameters():
        w = sd[name].numpy()
        atol = 2.2 * tol_lr + 1e-7 if p.requires_grad else 1e-6
        np.testing.assert_allclose(_np(p), w, rtol=0, atol=atol, err_msg=name)
        if p.requires_grad and name in firm:
            np.testing.assert_allclose(_np(p)[firm[name]], w[firm[name]], rtol=0,
                                       atol=0.01 * tol_lr + 1e-7, err_msg=f"{name} (firm)")


@pytest.fixture(scope="module")
def robusttok():
    return _Pair("RobustTok.yaml", **ROBUSTTOK)


@pytest.fixture(scope="module")
def vp2():
    """VP2-4096 with the loss stack cut to the tokenizer's own losses
    (``perceptual_weight`` and ``disc_weight`` 0: the RobustTok steps cover
    LPIPS and DinoDisc)."""
    return _Pair("VP2-4096.yaml", perceptual_weight=0.0, disc_weight=0.0)


def test_robusttok_train_steps_match_jax(robusttok):
    """Two steps of ``RobustTok.yaml``, beta 0.5 so that two of the four
    samples are perturbed: the first at the port's defaults (epoch 0,
    delta_ratio) with alpha 0.5, against the JAX step at its own defaults'
    values (passed, so that both steps run one compiled JAX step), the
    second at epoch 80 inside the anneal window (ratio 0.75: alpha 0.75,
    delta_ratio 0.75). Every metric, the first step's gradients, the
    parameters and the usage EMA after both."""
    pair = robusttok
    state, ptr, x = pair.fresh(SEED)
    run = pair.run
    assert ptr.model_cfg.perturb_delta_max == 8 and (run.anneal_start, run.anneal_end) == (40, 120)
    ratio = get_random_ratio(run.anneal_start, run.anneal_end, run.end_ratio, 80)
    assert ratio == 0.75
    jax_defaults = {k: p.default for k, p in inspect.signature(
        jax_tt.TokenizerTrainer.train_step).parameters.items() if k in ("epoch", "delta_ratio")}
    lr_g = optim.cosine_with_warmup(ptr.tcfg.lr, 2, 2 * ptr.tcfg.epochs, ptr.tcfg.min_lr)
    firm = None
    for step, (kw, jax_kw) in enumerate((
            (dict(alpha=0.5, beta=0.5), dict(alpha=0.5, beta=0.5, **jax_defaults)),
            (dict(epoch=80, alpha=run.alpha * ratio, beta=0.5, delta_ratio=ratio),) * 2)):
        state, want, got = _step(pair.jtr, state, ptr, x, step, jax_kw=jax_kw, **kw)
        _check_metrics(got, want, step)
        assert got["detail_loss"].item() > 0
        if step == 0:
            _check_grads_against_jax(ptr, state, ptr.model_cfg)
        firm = _firm(ptr, firm)
    _check_params(ptr, state, lr_g(0) + lr_g(1), firm)
    np.testing.assert_allclose(_np(ptr.usage_ema), np.asarray(state.usage_ema), atol=1e-6)


def test_vp2_train_step_matches_jax(vp2):
    """One step of ``VP2-4096.yaml`` (two single-scale branches, the
    codebook drop, both teachers; no LPIPS or disc): every metric and every
    gradient."""
    pair = vp2
    state, ptr, x = pair.fresh(SEED)
    state, want, got = _step(pair.jtr, state, ptr, x, 0)
    assert set(got) - set(want) == {"grad_norm"}  # no disc step, so no disc_grad_norm
    _check_metrics({**got, "disc_grad_norm": got["grad_norm"]}, want, 0)
    assert got["perceptual_loss"].item() == 0 and got["disc_loss"].item() == 0
    g = _jax_first_grads(state.opt_state, ptr.tcfg.beta1)
    _check_grads(ptr.model, vqmodel_state_dict_from_flax(_grad_tree(state.params, g),
                                                         ptr.model_cfg), "generator")


def test_vq4096_grad_accum_train_steps_match_jax(robusttok):
    """``VQ-4096.yaml`` with ``grad_accum_steps=2`` and lr_scheduler none
    (LPIPS off: the RobustTok steps cover it): after the first micro-step
    the parameters are bit-unchanged and only the step counts moved; after
    the second both optimizers updated once, on the clipped mean gradient
    (held against the JAX one), and the parameters and the EMA follow the
    JAX trainer's."""
    # VQ-4096's model is RobustTok's without the perturbation: the same params
    pair = _Pair("VQ-4096.yaml", tcfg=dict(grad_accum_steps=2), init_from=robusttok,
                 lr_scheduler="none", perceptual_weight=0.0)
    assert pair.pm == dataclasses.replace(robusttok.pm, perturb_delta_max=0)
    state, ptr, x = pair.fresh(SEED)
    params = ptr.gen_opt.params + ptr.disc_opt.params
    before = [p.detach().clone() for p in params]
    state, want, got = _step(pair.jtr, state, ptr, x, 0)
    _check_metrics(got, want, 0)
    assert all(torch.equal(a, p) for a, p in zip(before, params))
    assert ptr.step == 1 and ptr.gen_opt.count == 0 and ptr.gen_opt.mini_step == 1
    state, want, got = _step(pair.jtr, state, ptr, np.flip(x, axis=1).copy(), 1)
    _check_metrics(got, want, 1)
    assert ptr.gen_opt.count == ptr.disc_opt.count == 1 and ptr.gen_opt.mini_step == 0
    assert int(state.opt_state.gradient_step) == 1
    _check_grads_against_jax(ptr, state, ptr.model_cfg)  # the clipped means
    lr = ptr.tcfg.lr
    _check_params(ptr, state, lr, _firm(ptr))
    ema = vqmodel_state_dict_from_flax(_tree_np(state.ema_params), ptr.model_cfg)
    for (name, _), e in zip(ptr.model.named_parameters(), ptr.ema_params):
        np.testing.assert_allclose(_np(e), ema[name].numpy(), rtol=0,
                                   atol=2.2 * lr * 1e-4 + 1e-7, err_msg=name)


# ------------------------- optimizer accumulation ------------------------- #

@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_grad_accumulation_matches_optax_multisteps(clip):
    """k = 2 over four micro-steps: the same gradients into the port's
    ``adamw_with_freezing(grad_accum_steps=2)`` and the JAX package's (an
    ``optax.MultiSteps``), a decayed and a no-decay parameter, the lr
    scheduled: the parameters after every micro-step (bit-unchanged after
    the first and third), the update count, and the norm of each
    micro-step's gradients."""
    rng = np.random.default_rng(int(clip * 100))
    init = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(4)]
    sched = lambda s: 1e-2 * (s + 1)  # noqa: E731
    tx = jax_optim.adamw_with_freezing(sched, weight_decay=0.1, b1=0.9, b2=0.95,
                                       grad_clip=clip, grad_accum_steps=2)
    params = jax.tree_util.tree_map(jnp.asarray, {"dense": {"kernel": init["w"],
                                                            "bias": init["b"]}})
    opt_state = tx.init(params)
    module = torch.nn.Linear(3, 4)
    module.weight.data.copy_(torch.from_numpy(init["w"].T.copy()))
    module.bias.data.copy_(torch.from_numpy(init["b"]))
    paths = {"weight": "dense/kernel", "bias": "dense/bias"}
    opt = optim.adamw_with_freezing(module, sched, weight_decay=0.1, b1=0.9, b2=0.95,
                                    grad_clip=clip, paths=paths, grad_accum_steps=2)
    for i, g in enumerate(grads):
        jg = {"dense": {"kernel": jnp.asarray(g["w"]), "bias": jnp.asarray(g["b"])}}
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        before = [p.detach().clone() for p in module.parameters()]
        opt.zero_grad()
        module.weight.grad = torch.from_numpy(g["w"].T.copy())
        module.bias.grad = torch.from_numpy(g["b"])
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), optax.global_norm(jg), rtol=1e-6)
        if i % 2 == 0:
            assert all(torch.equal(a, p) for a, p in zip(before, module.parameters()))
        assert opt.count == (i + 1) // 2
        np.testing.assert_allclose(_np(module.weight).T, params["dense"]["kernel"], rtol=0,
                                   atol=1e-6, err_msg=f"micro-step {i}")
        np.testing.assert_allclose(_np(module.bias), params["dense"]["bias"], rtol=0,
                                   atol=1e-6, err_msg=f"micro-step {i}")
    assert int(opt_state.gradient_step) == opt.count == 2


def test_get_random_ratio_matches_the_cli():
    spec = importlib.util.spec_from_file_location("train_tokenizer_cli",
                                                  ROOT / "scripts" / "train_tokenizer.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    for args in ((40, 120, 0.5), (0, 0, 0.5), (10, 20, 0.3), (5, 5, 0.5)):
        for epoch in range(0, 140, 7):
            assert get_random_ratio(*args, epoch) == cli.get_random_ratio(*args, epoch)
