"""Port parity, learned latent pos embeds and the conv, siren and identity
ToPixel heads: ``imagefolder_tpu_torch`` against the JAX package on the CPU,
on the same numpy-seeded inputs and parameters.

- a tiny tokenizer (width 64, depth 2, 2 heads; 64 px, 16 latents, one
  single-scale VQ) with ``abs_pos_embed=False`` (the encoder's and the
  decoder's ``latent_pos_embed``, no level embeddings) and the ``conv``
  head: ``latent_pos_embed`` against ``export_vqmodel``'s keys, shapes and
  values, the round trip, and the training forward's values and every
  gradient; the adaptive GAN weight's anchor (``VQModel.last_layer``) is
  the JAX trainer's ``_last_layer_kernel``, and the decoder re-applied from
  its pre-last activation with the anchor's value is ``_last_layer_apply``;
- the ``siren`` head at the only size its raw channel-major view takes
  (256 px, patch 16: image tokens = image side) and width 64: output and
  gradients, and its anchor;
- the ``identity`` head: the tokens, and an anchor that neither package
  has (both raise).

The parameters are drawn from a numpy seed (``_torch_parity``); the
heads' flax parameters are carried by the bridge below (the JAX package
exports none). Tolerances: values and gradients within 1e-4 of the largest
(fp32; siren's sine of 30x amplifies rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.train.tokenizer_train import _last_layer_apply, _last_layer_kernel
from imagefolder_tpu.utils.convert_torch import export_vqmodel
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.utils.convert import to_torch, vqmodel_state_dict_from_flax

from tests._torch_parity import one_torch_thread, random_params  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG, B = 64, 2
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _margs(cls, **kw):
    base = dict(codebook_size=64, codebook_embed_dim=8, v_patch_nums=(4,), enc_type="dinov2",
                dec_type="dinov2", encoder_model=TINY, decoder_model=TINY,
                semantic_guide="none", detail_guide="none", num_latent_tokens=16,
                abs_pos_embed=False, image_size=IMG, to_pixel="conv")
    return cls(**{**base, **kw})


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def head_state_dict_from_flax(tp, mode: str, prefix: str = "decoder.to_pixel.") -> dict:
    """The bridge for the conv and siren heads: the deconv kernel is already
    in the torch (D, C, p, p) layout; the sine layers' Dense kernels are
    transposed to (out, in)."""
    if mode == "conv":
        return to_torch({f"{prefix}deconv.weight": np.asarray(tp["deconv"]["kernel"]),
                         f"{prefix}deconv.bias": np.asarray(tp["deconv"]["bias"])})
    return to_torch({f"{prefix}{n}.{w}": (np.asarray(tp[n]["kernel"]).T if w == "weight"
                                          else np.asarray(tp[n]["bias"]))
                     for n in ("sine1", "sine2") for w in ("weight", "bias")})


@pytest.fixture(scope="module")
def conv_models():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs))
    params = random_params(jm, jnp.asarray(img), train=False)
    cfg = _margs(PtArgs)
    pm = PtVQModel(cfg, device="cpu")
    sd = vqmodel_state_dict_from_flax(params, cfg)
    sd.update(head_state_dict_from_flax(params["decoder"]["to_pixel"], "conv"))
    pm.load_state_dict(sd, strict=True)
    return jm, params, pm, cfg, img


def test_latent_pos_embed_matches_export_vqmodel(conv_models):
    """The learned latent pos embeds (and no level embeddings) under the
    exporter's keys, shapes and values. The exporter takes the linear head
    only, so the params are exported with a linear head in its place."""
    _, params, pm, _, _ = conv_models
    d = TINY_PRESET["embed_dim"]
    linear = dict(params, decoder=dict(params["decoder"], to_pixel={"proj": {
        "kernel": np.zeros((d, 3 * 16 * 16), np.float32), "bias": np.zeros(768, np.float32)}}))
    want = export_vqmodel(linear, _margs(JaxArgs, to_pixel="linear"))
    got = pm.state_dict()
    keys = sorted(k for k in want if "latent_pos_embed" in k)
    assert keys == ["decoder.latent_pos_embed", "encoder.latent_pos_embed"]
    assert not any("lvl_embed" in k for k in (*want, *got))
    for k in keys:
        assert tuple(got[k].shape) == np.shape(want[k]) == (1, 16, d)
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert set(want) - {"decoder.to_pixel.model.weight", "decoder.to_pixel.model.bias"} \
        == set(got) - {"decoder.to_pixel.deconv.weight", "decoder.to_pixel.deconv.bias"}


def _apply(jm, params, method, *args):
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))(params, *args)


def test_conv_round_trip_and_gradients_match_jax(conv_models):
    jm, params, pm, cfg, img = conv_models
    want = _apply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    with torch.no_grad():
        got = pm.img_to_reconstructed_img(torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    w = np.random.default_rng(3).normal(size=img.shape).astype(np.float32)

    def scalar(out, w):
        return (out.dec * w).sum() + out.vq_loss + out.commit_loss + (out.pre_last ** 2).mean()

    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(img), train=True)
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    out = pm(torch.from_numpy(img), train=True)
    scalar(out, torch.from_numpy(w)).backward()
    for k in ("dec", "pre_last", "vq_loss", "commit_loss"):
        wv = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(out, k)), wv, rtol=0,
                                   atol=TOL * max(np.abs(wv).max(), 1.0), err_msg=k)
    gp = jax.tree_util.tree_map(np.asarray, gp)
    want_g = vqmodel_state_dict_from_flax(gp, cfg)
    want_g.update(head_state_dict_from_flax(gp["decoder"]["to_pixel"], "conv"))
    for name, p in pm.named_parameters():
        wg = want_g[name].numpy()
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=TOL * max(np.abs(wg).max(), 1e-12), err_msg=name)
    # the anchor, and the head re-applied from the pre-last activation
    jcfg = _margs(JaxArgs)
    w_last = _last_layer_kernel(jcfg, params["decoder"])
    assert pm.last_layer is pm.decoder.to_pixel.deconv.weight
    np.testing.assert_array_equal(_np(pm.last_layer), np.asarray(w_last))
    again = _last_layer_apply(jcfg, params["decoder"], jnp.asarray(_np(out.pre_last)), w_last)
    np.testing.assert_allclose(_np(out.dec), np.asarray(again), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def siren():
    """The siren head alone at 256 px, width 64, from its flax init."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 256, 64)).astype(np.float32)
    head = jax_vit.ToPixel(img_size=256, patch_size=16, channels=3, mode="siren")
    params = random_params(head, jnp.asarray(x), seed=2)
    port = pt_vit.ToPixel(64, 256, 16, 3, "siren")
    port.load_state_dict(head_state_dict_from_flax(params, "siren", ""), strict=True)
    return head, params, port, x


def test_siren_head_matches_jax(siren):
    head, params, port, x = siren
    w = np.random.default_rng(4).normal(size=(B, 256, 256, 3)).astype(np.float32)

    def jax_loss(p, xx):
        y = head.apply({"params": p}, xx)
        return (y * jnp.asarray(w)).sum(), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = port(tx)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (B, 256, 256, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx), rtol=0,
                               atol=TOL * np.abs(np.asarray(gx)).max())
    want_g = head_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, gp), "siren", "")
    for name, p in port.named_parameters():
        wg = want_g[name].numpy()
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0, atol=TOL * np.abs(wg).max(),
                                   err_msg=name)
    cfg = _margs(JaxArgs, to_pixel="siren", image_size=256)
    w_last = _last_layer_kernel(cfg, {"to_pixel": params})
    assert port.last_layer is port.sine2.weight
    np.testing.assert_array_equal(_np(port.last_layer), np.asarray(w_last).T)
    again = _last_layer_apply(cfg, {"to_pixel": params}, jnp.asarray(x), w_last)
    np.testing.assert_allclose(_np(got), np.asarray(again), rtol=0, atol=TOL)


def test_identity_head_has_no_anchor():
    """The tokens come back unchanged, and the adaptive weight's anchor
    raises on both sides."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(B, 16, 64)).astype(np.float32))
    head = pt_vit.ToPixel(64, IMG, 16, 3, "identity")
    assert head(x) is x and head.last_layer is None and not list(head.parameters())
    model = PtVQModel(_margs(PtArgs, to_pixel="identity"), device="cpu")
    with pytest.raises(NotImplementedError, match="has none"):
        model.last_layer
    with pytest.raises(NotImplementedError, match="has none"):
        _last_layer_kernel(_margs(JaxArgs, to_pixel="identity"), {"to_pixel": {}})
    with torch.no_grad():
        out = model.img_to_reconstructed_img(torch.zeros(B, IMG, IMG, 3))
    assert out.shape == (B, (IMG // 16) ** 2, 64)
