"""Port parity, the PatchGAN and StyleGAN discriminators and
``reinit_disc_heads``: ``imagefolder_tpu_torch/losses/discriminators.py``
and ``train/tokenizer_train.py`` against the JAX package on the CPU, on the
same numpy-seeded inputs, with params carried by the bridges below (the
JAX package exports neither discriminator: the port keeps the flax names,
each kernel in the torch layout).

- ``PatchGANDiscriminator`` (ndf 16) at 32 px: the logits and the
  gradients in the image and every parameter, in training mode (batch
  statistics; the running statistics kept only with ``update_stats``) and
  in eval mode (running statistics);
- ``StyleGANDiscriminator`` at 16 px: the logits and the gradients;
- the optimizer labels of both (decay, no decay) against the JAX ones of
  each parameter's flax path;
- one ``TokenizerTrainer`` step with ``disc_type`` ``patchgan`` and
  ``stylegan`` against the JAX trainer: every metric, every gradient of the
  generator and the discriminator, and PatchGAN's running statistics (the
  generator pass leaves them, the disc pass moves them on the fake and then
  the real images). The tokenizer is cut to a width-64 ViT of depth 1 with
  a single-scale VQ, no teacher and no LPIPS (``perceptual_weight`` 0): the
  discriminator is what is checked;
- ``reinit_disc_heads``: DinoDisc's trunk bit-unchanged and its heads drawn
  afresh, PatchGAN's parameters all drawn afresh, the discriminator's state
  kept and the disc optimizer empty, as the JAX trainer does it.

Tolerances: logits 1e-5 of their max abs, gradients 1e-4 of each tensor's
max abs (fp32 summation orders through the convs; a cancelled sum against
the discriminator's largest gradient, ``_check_disc_grads``); metrics as
``test_torch_tokenizer_train.py`` holds them. The convs take PyTorch's
native CPU path (``exact_cpu_convs``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.losses.discriminators import PatchGANDiscriminator as JaxPatchGAN
from imagefolder_tpu.losses.discriminators import StyleGANDiscriminator as JaxStyleGAN
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu.train import tokenizer_train as jax_tt
from imagefolder_tpu.train.recipes import flagship_gan_recipe as jax_recipe
from imagefolder_tpu_torch.losses.discriminators import (
    DinoDisc,
    PatchGANDiscriminator,
    StyleGANDiscriminator,
)
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.train import optim
from imagefolder_tpu_torch.train.recipes import flagship_gan_recipe
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer
from imagefolder_tpu_torch.utils.convert import to_torch, vqmodel_state_dict_from_flax
from test_torch_tokenizer_train import (
    _check_grads,
    _check_metrics,
    _grad_tree,
    _jax_first_grads,
    _np,
    _path,
    _tree_np,
)

TINY = "tiny_disc_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=1, num_heads=1)
B, PX = 4, 32
# StyleGAN runs 512 channels at any size up to 32 px: at 16 px it has two
# blocks, not three, and a quarter of the work; PatchGAN needs 32 px for its
# five 4 x 4 convs
PXS = {"patchgan": 32, "stylegan": 16, "dinodisc": 32}
MARGS = dict(encoder_model=TINY, decoder_model=TINY, codebook_size=16, codebook_embed_dim=8,
             v_patch_nums=(2,), product_quant=1, num_latent_tokens=4, image_size=PX,
             dtype_str="float32", semantic_guide="none", codebook_drop=0.0)
TCFG = dict(image_size=PX, steps_per_epoch=2, perceptual_weight=0.0)


def _recipe_kw(kind: str, **tcfg) -> dict:
    """The tiny recipe's overrides for ``disc_type`` ``kind`` at its size."""
    px = PXS[kind]
    return dict(margs_overrides=dict(MARGS, image_size=px),
                tcfg_overrides=dict(TCFG, image_size=px, disc_type=kind, **tcfg))


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    """PyTorch's oneDNN convs on this CPU compute fp32 weight gradients to
    about 5e-4 of their max (TF32-like; StyleGAN's 512-channel convs against
    an fp64 run), where its native convs and XLA's stay within 1e-6: the
    convs here take the native path, so that the comparison sees the port's
    fp32 math and not the backend's choice. One thread: the native convs'
    thread pool spins against the other test workers when the cores are
    shared (3x slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want, rel, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=msg)


# ------------------------------- bridges ------------------------------- #

def disc_state_dict_from_flax(params, disc_vars) -> dict:
    """flax PatchGAN or StyleGAN params (and PatchGAN's ``batch_stats``)
    -> {name: fp32 CPU tensor} for the port's module: conv kernels (kh, kw,
    in, out) -> (out, in, kh, kw), Dense kernels transposed, BatchNorm's
    scale, bias, mean and var."""
    sd = {}
    for name, p in params.items():
        if name.startswith("bn"):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]
            continue
        k = np.asarray(p["kernel"])
        sd[f"{name}.weight"] = k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"]
    for name, s in disc_vars.get("batch_stats", {}).items():
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = s["mean"], s["var"]
    return to_torch(sd)


SEEDS = {"patchgan": 1, "stylegan": 3}


@functools.lru_cache(maxsize=None)
def _flax(kind):
    """A flax discriminator of ``kind`` with its params and other variables
    (numpy, read-only), initialised once per module, and a batch of images."""
    seed, px = SEEDS[kind], PXS[kind]
    x = np.random.default_rng(seed).uniform(-1, 1, (B, px, px, 3)).astype(np.float32)
    jd = JaxPatchGAN(ndf=16) if kind == "patchgan" else JaxStyleGAN(image_size=px)
    variables = _tree_np(jax.jit(lambda k, xx: jd.init(k, xx, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    if kind == "patchgan":  # running statistics away from their init
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
            variables["batch_stats"])
    params = variables.pop("params")
    return jd, params, variables, x


def _pair(kind):
    """``_flax(kind)`` and a fresh port discriminator loaded from it."""
    jd, params, variables, x = _flax(kind)
    pd = PatchGANDiscriminator(ndf=16) if kind == "patchgan" else StyleGANDiscriminator(PXS[kind])
    pd.load_state_dict(disc_state_dict_from_flax(params, variables), strict=True)
    return jd, params, variables, pd, x


# ------------------------------- forwards ------------------------------- #

@pytest.mark.parametrize("train,update_stats", [(True, True), (True, False), (False, False)])
def test_patchgan_matches_jax(train, update_stats):
    jd, params, dvars, pd, x = _pair("patchgan")
    w = np.random.default_rng(2).normal(size=(B, 2, 2, 1)).astype(np.float32)

    def loss(p, xx):
        out, new = jd.apply({"params": p, **dvars}, xx, train=train, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new)

    (_, (want, new_vars)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pd(xt, train=train, update_stats=update_stats)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (B, 2, 2, 1)
    _close(_np(got), want, 1e-5, "logits")
    _close(_np(xt.grad), gx, 1e-4, "image gradient")
    want_g = disc_state_dict_from_flax(_tree_np(gp), {})
    for name, p in pd.named_parameters():
        _close(_np(p.grad), want_g[name].numpy(), 1e-4, name)
    kept = _tree_np(new_vars) if update_stats else dvars
    for name, s in kept["batch_stats"].items():
        bn = getattr(pd, name)
        _close(_np(bn.running_mean), s["mean"], 1e-5, f"{name} mean")
        _close(_np(bn.running_var), s["var"], 1e-5, f"{name} var")


def test_stylegan_matches_jax():
    jd, params, _, pd, x = _pair("stylegan")
    w = np.random.default_rng(4).normal(size=(B, 1)).astype(np.float32)

    def loss(p, xx):
        out = jd.apply({"params": p}, xx)
        return jnp.sum(out * w), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pd(xt)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (B, 1)
    _close(_np(got), want, 1e-5, "logits")
    _close(_np(xt.grad), gx, 1e-4, "image gradient")
    want_g = disc_state_dict_from_flax(_tree_np(gp), {})
    for name, p in pd.named_parameters():
        _close(_np(p.grad), want_g[name].numpy(), 1e-4, name)


@pytest.mark.parametrize("kind", ["patchgan", "stylegan"])
def test_disc_optimizer_labels_match_jax(kind):
    """Every port parameter's flax path is a leaf of the flax module's
    params, decayed exactly where the JAX labels say so, and none frozen."""
    _, params, _, pd, _ = _pair(kind)
    leaves = {_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    paths = optim.module_flax_paths(pd)
    assert set(paths.values()) == leaves
    opt = optim.adamw_with_freezing(pd, lambda s: 1e-4, weight_decay=0.1, paths=paths)
    decay = {id(p) for p in opt.opt.param_groups[0]["params"]}
    for name, p in pd.named_parameters():
        assert not jax_optim.disc_frozen_predicate(paths[name])
        assert (id(p) in decay) == (not jax_optim.no_decay_predicate(paths[name])), name
    assert len(opt.params) == len(list(pd.parameters()))


# ------------------------------ trainer step ------------------------------ #

@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer of each ``disc_type`` at the tiny recipe, built (and
    so compiled) once per module."""
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = jax_tt.TokenizerTrainer(*jax_recipe(B, **_recipe_kw(kind)))
        return made[kind]

    return get


def _check_disc_grads(module, want_sd):
    """Each gradient within 1e-4 of its max abs, or, where the hinge
    terms cancel (conv_out's bias: each real and fake logit inside the
    margin adds +-1 / N, leaving LeCam's small share), within 1e-6 of the
    discriminator's largest gradient (an fp32 ulp of the cancelled terms)."""
    top = max(np.abs(want_sd[n].numpy()).max() for n, _ in module.named_parameters())
    for name, p in module.named_parameters():
        w = want_sd[name].numpy()
        np.testing.assert_allclose(_np(p.grad), w, rtol=0,
                                   atol=max(1e-4 * np.abs(w).max(), 1e-6 * top),
                                   err_msg=f"disc {name}")


# the seeds keep every LeakyReLU input off its kink by more than the two
# packages' rounding: at 32 px StyleGAN's 2M inputs a layer put one within
# it at every seed tried, whose other slope moved a conv's weight gradient
# by up to 7e-4 of its max
@pytest.mark.parametrize("kind,seed", [("patchgan", 5), ("stylegan", 6)])
def test_trainer_step_with_disc_type_matches_jax(jax_trainer, kind, seed):
    """One generator and one disc step: the non-Dino discriminators see no
    DiffAug and no crop, PatchGAN normalises by batch statistics in both
    passes and keeps the disc pass's running statistics."""
    pm, pt = flagship_gan_recipe(B, **_recipe_kw(kind))
    px = PXS[kind]
    x = np.random.default_rng(seed).uniform(-1, 1, (B, px, px, 3)).astype(np.float32)
    jtr = jax_trainer(kind)
    state = jtr.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ptr = TokenizerTrainer(pm, pt, generator=torch.Generator().manual_seed(seed), device="cpu")
    assert type(ptr.disc).__name__ == type(jtr.disc).__name__
    ptr.model.load_state_dict(vqmodel_state_dict_from_flax(_tree_np(state.params), pm),
                              strict=True)
    ptr.disc.load_state_dict(disc_state_dict_from_flax(_tree_np(state.disc_params),
                                                       _tree_np(state.disc_vars)), strict=True)
    ptr.sync_ema()
    state, want = jtr.train_step(state, jnp.asarray(x), jax.random.PRNGKey(0))
    got = ptr.train_step(torch.from_numpy(x))  # a single-scale VQ: no draw matters
    _check_metrics(got, want, 0)
    b1 = pt.beta1
    _check_grads(ptr.model, vqmodel_state_dict_from_flax(
        _grad_tree(state.params, _jax_first_grads(state.opt_state, b1)), pm), "generator")
    _check_disc_grads(ptr.disc, disc_state_dict_from_flax(
        _grad_tree(state.disc_params, _jax_first_grads(state.disc_opt_state, b1)), {}))
    want_state = disc_state_dict_from_flax(_tree_np(state.disc_params),
                                           _tree_np(state.disc_vars))
    for name, buf in ptr.disc.named_buffers():
        _close(_np(buf), want_state[name].numpy(), 1e-5, name)


# ---------------------------- reinit_disc_heads ---------------------------- #

def _tiny_trainer(disc_type):
    pm, pt = flagship_gan_recipe(B, **_recipe_kw(disc_type, dino_depth=3))
    tr = TokenizerTrainer(pm, pt, generator=torch.Generator().manual_seed(0), device="cpu")
    tr.train_step(torch.rand((B, PX, PX, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1)
    return tr


@pytest.mark.parametrize("disc_type", ["dinodisc", "patchgan"])
def test_reinit_disc_heads(disc_type):
    """DinoDisc keeps its trunk bit-unchanged and gets the heads of a fresh
    DinoDisc drawn from the generator; PatchGAN is re-drawn whole; the
    state (spectral u and sigma, running statistics) is kept, and the disc
    optimizer starts empty at step 0, while the generator's is untouched."""
    tr = _tiny_trainer(disc_type)
    assert tr.disc_opt.count == 1 and tr.disc_opt.opt.state
    params = {n: p.detach().clone() for n, p in tr.disc.named_parameters()}
    buffers = {n: b.clone() for n, b in tr.disc.named_buffers()}
    gen_count = tr.gen_opt.count
    tr.reinit_disc_heads(torch.Generator().manual_seed(7))
    fresh = (DinoDisc(3, generator=torch.Generator().manual_seed(7))
             if disc_type == "dinodisc" else
             PatchGANDiscriminator(generator=torch.Generator().manual_seed(7)))
    fresh = dict(fresh.named_parameters())
    for n, p in tr.disc.named_parameters():
        trunk = disc_type == "dinodisc" and n.startswith("dino.")
        torch.testing.assert_close(p, params[n] if trunk else fresh[n], rtol=0, atol=0)
        if not trunk and p.ndim > 1:  # a kernel (a bias may be back at its init of 0)
            assert not torch.equal(p, params[n]), n
    for n, b in tr.disc.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert tr.disc_opt.count == 0 and not tr.disc_opt.opt.state
    assert {id(p) for p in tr.disc_opt.params} == {
        id(p) for p in tr.disc.parameters() if p.requires_grad}
    assert tr.gen_opt.count == gen_count
    m = tr.train_step(torch.zeros((B, PX, PX, 3)))
    assert bool(torch.isfinite(m["disc_loss"])) and tr.disc_opt.count == 1


def test_jax_reinit_keeps_what_the_port_keeps(jax_trainer):
    """The JAX trainer's ``reinit_disc_heads`` on PatchGAN: every parameter
    re-drawn, ``disc_vars`` (the running statistics) kept, the disc
    optimizer state fresh: the semantics the port follows."""
    jtr = jax_trainer("patchgan")
    x = jnp.zeros((B, PX, PX, 3))
    state = jtr.init(jax.random.PRNGKey(0), x)
    state = dataclasses.replace(state, disc_vars=jax.tree_util.tree_map(
        lambda v: v + 1.0, state.disc_vars))
    new = jtr.reinit_disc_heads(state, jax.random.PRNGKey(9), x)
    for a, b in zip(jax.tree_util.tree_leaves(state.disc_params),
                    jax.tree_util.tree_leaves(new.disc_params)):
        if a.ndim > 1:  # the kernels: BatchNorm's bias and the conv biases start at 0
            assert not np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(state.disc_vars),
                    jax.tree_util.tree_leaves(new.disc_vars)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(jax.tree_util.tree_leaves(new.disc_opt_state)[0]) == 0
