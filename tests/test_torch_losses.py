"""Port parity, the GAN loss stack: ``imagefolder_tpu_torch/losses/`` against
the JAX package's ``losses/`` on the CPU, on the same numpy-seeded inputs.

- ``clip_loss``, every ``D_LOSSES``/``G_LOSSES`` entry (the swapped BCE
  arguments included), ``adopt_weight``, LeCam and ``adaptive_disc_weight``;
- LPIPS (VGG16 at 32 px) forward and input gradient, in fp32 and with bf16
  convs, and ``lpips_state_dict_from_flax`` as the inverse of
  ``convert_lpips_checkpoint``;
- DiffAug's ``*_with_u`` functions, ``warmup_blur`` and ``diff_aug`` with
  the same uniforms (patched into ``jax.random.uniform`` on the JAX side);
- ``BatchNormLocal``, and DinoDisc (ViT-S/16 trunk at depth 2, readouts at
  depths {pre, 0, 1}) with and without the spectral-norm update, its saved
  ``u``/``sigma``, the gradients in the image and the heads, and the
  crop-or-resize of an input above 224 px.

Tolerances: fp32 within 1e-6 relative to the largest value compared (1e-4
where a 224 px trunk or the VGG stack sums over many terms); bf16 convs
within 2e-2 relative, 5e-2 for LPIPS's input gradient.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.losses import diffaug as jax_aug
from imagefolder_tpu.losses import gan as jax_gan
from imagefolder_tpu.losses.clip_loss import clip_loss as jax_clip_loss
from imagefolder_tpu.losses.discriminators import BatchNormLocal as JaxBNL
from imagefolder_tpu.losses.discriminators import DinoDisc as JaxDinoDisc
from imagefolder_tpu.losses.lpips import LPIPS as JaxLPIPS
from imagefolder_tpu.losses.lpips import convert_lpips_checkpoint
from imagefolder_tpu_torch.losses import clip_loss as pt_clip
from imagefolder_tpu_torch.losses import diffaug as pt_aug
from imagefolder_tpu_torch.losses import gan as pt_gan
from imagefolder_tpu_torch.losses.discriminators import BatchNormLocal, DinoDisc
from imagefolder_tpu_torch.losses.lpips import LPIPS
from imagefolder_tpu_torch.utils.convert import (
    dinodisc_state_dict_from_flax,
    lpips_state_dict_from_flax,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=msg)


# --------------------------- objectives --------------------------- #

def test_clip_loss_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 16)).astype(np.float32)
    b = rng.normal(size=(6, 16)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    want = jax_clip_loss(jnp.asarray(a), jnp.asarray(b), 31.7)
    got = pt_clip.clip_loss(torch.from_numpy(a), torch.from_numpy(b), 31.7)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind,name", [("d", "hinge"), ("d", "vanilla"),
                                       ("d", "non-saturating"), ("g", "hinge"),
                                       ("g", "non-saturating")])
def test_gan_objectives_match_jax(kind, name):
    """Value and gradient in the logits of every D_LOSSES / G_LOSSES entry."""
    rng = np.random.default_rng(1)
    real = (rng.normal(size=(3, 40)) * 2).astype(np.float32)
    fake = (rng.normal(size=(3, 40)) * 2).astype(np.float32)
    if kind == "d":
        want, want_g = jax.value_and_grad(jax_gan.D_LOSSES[name], argnums=(0, 1))(
            jnp.asarray(real), jnp.asarray(fake))
        r, f = (torch.from_numpy(x).requires_grad_() for x in (real, fake))
        got = pt_gan.D_LOSSES[name](r, f)
        got_g = torch.autograd.grad(got, (r, f))
    else:
        want, g = jax.value_and_grad(jax_gan.G_LOSSES[name])(jnp.asarray(fake))
        want_g = (g,)
        f = torch.from_numpy(fake).requires_grad_()
        got = pt_gan.G_LOSSES[name](f)
        got_g = torch.autograd.grad(got, (f,))
    assert sorted(pt_gan.D_LOSSES) == sorted(jax_gan.D_LOSSES)
    assert sorted(pt_gan.G_LOSSES) == sorted(jax_gan.G_LOSSES)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    for a, b in zip(got_g, want_g):
        _close(_np(a), b, 1e-6)


def test_adopt_weight_and_lecam_match_jax():
    for step, thr in ((10, 20), (20, 20), (30, 0)):
        assert pt_gan.adopt_weight(0.5, step, thr) == float(jax_gan.adopt_weight(0.5, step, thr))
    rng = np.random.default_rng(2)
    real = rng.normal(size=(2, 30)).astype(np.float32)
    fake = rng.normal(size=(2, 30)).astype(np.float32)
    jst = jax_gan.LeCamState(jnp.float32(0.3), jnp.float32(-0.2))
    pst = pt_gan.LeCamState(torch.tensor(0.3), torch.tensor(-0.2))
    for _ in range(2):
        jst = jax_gan.lecam_update(jst, jnp.asarray(real), jnp.asarray(fake))
        pst = pt_gan.lecam_update(pst, torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(pst.logits_real_ema.item(), float(jst.logits_real_ema), rtol=1e-6)
    np.testing.assert_allclose(pst.logits_fake_ema.item(), float(jst.logits_fake_ema), rtol=1e-6)
    want, want_g = jax.value_and_grad(jax_gan.lecam_reg, argnums=(0, 1))(
        jnp.asarray(real), jnp.asarray(fake), jst)
    r, f = (torch.from_numpy(x).requires_grad_() for x in (real, fake))
    got = pt_gan.lecam_reg(r, f, pst)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for a, b in zip(torch.autograd.grad(got, (r, f)), want_g):
        _close(_np(a), b, 1e-6)
    init = pt_gan.LeCamState.init()
    assert init.logits_real_ema.shape == () and init.logits_fake_ema.item() == 0.0


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e6])
def test_adaptive_disc_weight_matches_jax(scale):
    """The norm ratio with its eps, clamped to [0, 1e4], with no gradient."""
    rng = np.random.default_rng(3)
    g_nll = rng.normal(size=(64, 48)).astype(np.float32)
    g_adv = (rng.normal(size=(64, 48)) * scale).astype(np.float32)
    want = jax_gan.adaptive_disc_weight(jnp.asarray(g_nll), jnp.asarray(g_adv))
    a = torch.from_numpy(g_nll).requires_grad_()
    got = pt_gan.adaptive_disc_weight(a, torch.from_numpy(g_adv))
    assert not got.requires_grad and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert 0.0 <= got.item() <= 1e4


# ------------------------------ LPIPS ------------------------------ #

@pytest.fixture(scope="module")
def lpips_pair():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.normal(size=x.shape), -1, 1).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxLPIPS().init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))["params"])
    return params, x, y


def test_lpips_state_dict_round_trip(lpips_pair):
    """``convert_lpips_checkpoint(port.state_dict())`` gives back the flax
    params, and the port's names are the taming layout."""
    params, _, _ = lpips_pair
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_flax(params), strict=True)
    sd = port.state_dict()
    assert "net.slice1.0.weight" in sd and "net.slice5.28.bias" in sd
    assert "lin4.model.1.weight" in sd and len(sd) == 13 * 2 + 5
    back = convert_lpips_checkpoint(sd)
    assert sorted(back) == sorted(params)
    for k, leaf in params.items():
        for name, v in leaf.items():
            np.testing.assert_array_equal(back[k][name], v, err_msg=f"{k}/{name}")
    assert not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lpips_forward_and_input_gradient_match_jax(lpips_pair, dtype):
    params, x, y = lpips_pair
    jm = JaxLPIPS(dtype=jnp.dtype(dtype))
    want, want_g = jax.value_and_grad(
        lambda yy: jnp.sum(jm.apply({"params": params}, jnp.asarray(x), yy)))(jnp.asarray(y))
    want_d = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    port = LPIPS(getattr(torch, dtype))
    port.load_state_dict(lpips_state_dict_from_flax(params), strict=True)
    ty = torch.from_numpy(y).requires_grad_()
    got = port(torch.from_numpy(x), ty)
    got.sum().backward()
    assert got.shape == (2, 1, 1, 1) and got.dtype == torch.float32
    _close(_np(got), want_d, 1e-4 if dtype == "float32" else 2e-2)
    # bf16: the two frameworks round the 13 convs' backward differently
    _close(_np(ty.grad), want_g, 1e-4 if dtype == "float32" else 5e-2)
    same = port(torch.from_numpy(x), torch.from_numpy(x))
    assert same.abs().max().item() < 1e-6


# ----------------------------- DiffAug ----------------------------- #

def _aug_uniforms(rng, b):
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {"translate": (u(b, 1, 1), u(b, 1, 1)),
            "color": (u(b, 1, 1, 1), u(b, 1, 1, 1), u(b, 1, 1, 1)),
            "cutout": (u(b, 1, 1), u(b, 1, 1))}


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)])
def test_with_u_transforms_match_jax(hw):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, *hw, 3)).astype(np.float32)
    d = _aug_uniforms(rng, 4)
    t = torch.from_numpy
    for name, jf, pf, args in (
            ("translate", jax_aug.translate_with_u, pt_aug.translate_with_u, d["translate"]),
            ("color", jax_aug.color_with_u, pt_aug.color_with_u, d["color"]),
            ("cutout", jax_aug.cutout_with_u, pt_aug.cutout_with_u, d["cutout"])):
        want = jf(jnp.asarray(x), *map(jnp.asarray, args))
        got = pf(t(x), *map(t, args))
        _close(_np(got), want, 1e-6, name)


@pytest.mark.parametrize("schedule", [0.0, 0.1, 0.5])
def test_warmup_blur_matches_jax(schedule):
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax_aug.warmup_blur(jnp.asarray(x), schedule)
    got = pt_aug.warmup_blur(torch.from_numpy(x), schedule)
    _close(_np(got), want, 1e-6)


def _patched_uniform(monkeypatch, draws):
    """jax.random.uniform returning ``diff_aug``'s draws in its call order:
    the gates, translation, colour, then cutout."""
    queue = [draws["gates"], *draws["translate"], *draws["color"], *draws["cutout"]]

    def uniform(key, shape=(), *a, **k):
        v = np.asarray(queue.pop(0))
        assert v.shape == tuple(shape)
        return jnp.asarray(v)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    return queue


@pytest.mark.parametrize("gates,prob,cutout,blur", [
    ((0.1, 0.2, 0.3), 1.0, 0.2, 0.0),
    ((0.7, 0.2, 0.4), 0.5, 0.2, 0.3),
    ((0.2, 0.9, 0.9), 0.5, 0.0, 0.0),
])
def test_diff_aug_with_draws_matches_jax(monkeypatch, gates, prob, cutout, blur):
    """Each gate (u <= prob) picks its transform, with the same uniforms."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    draws = {"gates": np.asarray(gates, np.float32), **_aug_uniforms(rng, 3)}
    left = _patched_uniform(monkeypatch, draws)
    want = jax_aug.diff_aug(jnp.asarray(x), jax.random.PRNGKey(0), prob, cutout, blur)
    assert len(left) == (2 if cutout <= 0 else 0)  # no cutout, no cutout draws
    monkeypatch.undo()
    pd = {k: torch.from_numpy(v) if k == "gates" else tuple(map(torch.from_numpy, v))
          for k, v in draws.items()}
    got = pt_aug.diff_aug(torch.from_numpy(x), None, prob, cutout, blur, draws=pd)
    _close(_np(got), want, 1e-6)
    assert not np.allclose(_np(got), x)


def test_diff_aug_draws_from_the_generator():
    """Without ``draws`` the uniforms come from the generator: the same seed
    gives the same images; prob 0 leaves them (after the blur) as they are."""
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    a, b = (pt_aug.diff_aug(x, torch.Generator().manual_seed(3)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    d = pt_aug.draw_aug(2, torch.Generator().manual_seed(3), torch.device("cpu"))
    torch.testing.assert_close(pt_aug.diff_aug(x, None, draws=d), a, rtol=0, atol=0)
    torch.testing.assert_close(pt_aug.diff_aug(x, None, prob=0.0), x, rtol=0, atol=0)


# ----------------------------- DinoDisc ----------------------------- #

@pytest.mark.parametrize("batch", [3, 16])
def test_batchnorm_local_matches_jax(batch):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(batch, 10, 6)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=6).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = JaxBNL().apply({"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
                          jnp.asarray(x))
    bn = BatchNormLocal(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    _close(_np(bn(torch.from_numpy(x))), want, 1e-5)


KD = (0, 1)  # readouts after blocks 0 and 1 of the depth-2 trunk
# The heads' LeakyReLU has a kink at 0: an input within fp32 rounding of it
# (about 1e-7 of the tensor's max between the two frameworks) may take the
# other branch on one side and send a different gradient back to its token.
# The fixture's seed keeps every LeakyReLU input at least this far from 0,
# relative to its tensor's max, so that the gradients compare as rounding.
KINK_MARGIN = 3e-7


@pytest.fixture(scope="module")
def disc_pair():
    rng = np.random.default_rng(22)  # see KINK_MARGIN
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jd = JaxDinoDisc(depth=2, key_depths=KD)
    variables = jax.jit(lambda k, xx: jd.init(k, xx, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params, spectral = variables["params"], {"spectral": variables["spectral"]}
    # the BatchNormLocal affine params start at (1, 0): move them
    for i in range(len(KD) + 1):
        for blk in ("b0", "b1"):
            bn = params[f"head_{i}"][blk][f"{blk}_bn"]
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    return jd, params, spectral, x


def _port_disc(params, spectral):
    pd = DinoDisc(2, key_depths=KD)
    pd.load_state_dict(dinodisc_state_dict_from_flax(params, spectral), strict=True)
    return pd


@pytest.mark.parametrize("update_stats", [False, True])
def test_dinodisc_matches_jax(disc_pair, update_stats):
    """Logits, the spectral state kept (only with ``update_stats``), and the
    gradients of a weighted sum of the logits in the image and in every
    head parameter (the trunk is frozen: no gradient there)."""
    jd, params, spectral, x = disc_pair
    w = np.random.default_rng(10).normal(size=(2, (len(KD) + 1) * 196)).astype(np.float32)

    def jax_loss(p, xx):
        logits, new = jd.apply({"params": p, **spectral}, xx, train=True,
                               rng=jax.random.PRNGKey(0), mutable=["spectral"])
        return jnp.sum(logits * w), (logits, new)

    (_, (want, new_vars)), (gp, gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    pd = _port_disc(params, spectral)
    sd0 = {k: v.clone() for k, v in pd.state_dict().items()}
    kinks = []  # every LeakyReLU input: the BatchNormLocal outputs
    for m in pd.modules():
        if isinstance(m, BatchNormLocal):
            m.register_forward_hook(lambda m, i, o: kinks.append(o.detach()))
    tx = torch.from_numpy(x).requires_grad_()
    got = pd(tx, update_stats=update_stats)
    (got * torch.from_numpy(w)).sum().backward()
    assert len(kinks) == 2 * (len(KD) + 1)
    assert min((k.abs().min() / k.abs().max()).item() for k in kinks) >= KINK_MARGIN
    assert got.shape == (2, (len(KD) + 1) * 196) and got.dtype == torch.float32
    _close(_np(got), want, 1e-4)
    _close(_np(tx.grad), gx, 1e-4)
    want_sd = dinodisc_state_dict_from_flax(
        params, jax.tree_util.tree_map(np.asarray, dict(new_vars)))
    grads = dinodisc_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, gp), spectral)
    for name, p in pd.named_parameters():
        if name.startswith("dino."):
            assert not p.requires_grad and p.grad is None, name
            continue
        if re.fullmatch(r"heads\.\d\.b\d\.conv\.bias", name):
            # zero in exact arithmetic: BatchNormLocal removes the mean
            scale = np.abs(grads[name[:-4] + "weight"].numpy()).max()
            assert max(np.abs(_np(p.grad)).max(), np.abs(grads[name].numpy()).max()) < 1e-4 * scale
            continue
        _close(_np(p.grad), grads[name].numpy(), 1e-4, name)
    for name, v in pd.state_dict().items():
        if name.endswith((".u", ".sigma")):
            ref = want_sd[name] if update_stats else sd0[name]
            _close(_np(v), ref.numpy(), 1e-5, name)
            if update_stats and name.endswith(".u"):
                assert not torch.equal(v, sd0[name]), name


@pytest.mark.parametrize("take_crop", [False, True])
def test_dinodisc_crop_or_resize_matches_jax(monkeypatch, disc_pair, take_crop):
    """Above 224 px: the area resize, or the crop at (oh, ow) when the draw
    says so, from the same draws."""
    jd, params, spectral, _ = disc_pair
    x = np.random.default_rng(11).uniform(-1, 1, (2, 240, 240, 3)).astype(np.float32)
    oh, ow, u = 3, 11, (0.2 if take_crop else 0.8)
    offsets = [oh, ow]
    real_randint, real_uniform = jax.random.randint, jax.random.uniform

    def randint(key, shape, *a, **k):  # the crop offsets are the 0-d draws
        return jnp.int32(offsets.pop(0)) if tuple(shape) == () else real_randint(
            key, shape, *a, **k)

    def uniform(key, shape=(), *a, **k):
        return jnp.float32(u) if tuple(shape) == () else real_uniform(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    want, _ = jd.apply({"params": params, **spectral}, jnp.asarray(x), train=True,
                       rng=jax.random.PRNGKey(0), mutable=["spectral"])
    assert not offsets
    monkeypatch.undo()
    pd = _port_disc(params, spectral)
    crop = (torch.tensor(u <= 0.5), torch.tensor(oh), torch.tensor(ow))
    with torch.no_grad():
        other = pd(torch.from_numpy(x), (~crop[0], *crop[1:]))
        got = pd(torch.from_numpy(x), crop, update_stats=True)
    _close(_np(got), want, 1e-4)
    assert np.abs(_np(other) - np.asarray(want)).max() > 1e-3  # the draw did act
