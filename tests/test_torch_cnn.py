"""Port parity, the CNN tokenizer: ``imagefolder_tpu_torch/models/cnn.py``
against ``imagefolder_tpu/models/cnn.py`` on the CPU, on the same
numpy-seeded inputs and parameters.

- ``Encoder`` and ``Decoder`` alone (ch 32, ch_mult (1, 2), so one
  downsample and one upsample and attention at the lowest level; 16 px):
  the output and the decoder's pre-last activation, their params carried by ``cnn_encoder_state_dict_from_flax`` /
  ``cnn_decoder_state_dict_from_flax`` and held to the exporter's keys,
  shapes and values;
- the CNN tokenizer as the e2e pipeline builds it (``enc_type=cnn
  dec_type=cnn``, ``vq_model`` VQ-16's pyramid cut to (1, 2), the default
  ch 128 and z 256; 16 px, an 8 x 8 latent grid, a single-scale VQ):
  ``export_vqmodel``'s state dict, codes, the round trip, the training
  forward's values and every gradient (the encoder's and the decoder's),
  and the adaptive GAN weight's anchor
  (the decoder's ``conv_out``);
- a mixed pair (a CNN encoder with a tiny DINOv2 decoder: width 64, depth
  2, 2 heads): codes and the round trip.

The parameters are drawn from a numpy seed (``_torch_parity``). PyTorch's
oneDNN convs are turned off: on this CPU their fp32 weight
gradients are TF32-like (``test_torch_discriminators.py``). Tolerances:
codes exact; values and gradients within 1e-4 of the largest (fp32); the
attention's k biases, whose gradient is 0 in exact arithmetic, within 1e-6
of the model's largest gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import cnn as jax_cnn
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.train.tokenizer_train import _last_layer_kernel
from imagefolder_tpu.utils.convert_torch import (
    export_cnn_decoder,
    export_cnn_encoder,
    export_vqmodel,
)
from imagefolder_tpu_torch.models import cnn as pt_cnn
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.utils.convert import (
    cnn_decoder_state_dict_from_flax,
    cnn_encoder_state_dict_from_flax,
    to_torch,
    vqmodel_state_dict_from_flax,
)

from tests._torch_parity import one_torch_thread, random_params  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
PX, B, MULT = 16, 2, (1, 2)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def cpu_setup():
    """The tiny ViT preset, and oneDNN's convs off."""
    with pytest.MonkeyPatch.context() as mp, torch.backends.mkldnn.flags(enabled=False):
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, scale=None):
    want = np.asarray(want)
    scale = scale if scale is not None else max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_and_decoder_match_jax(part):
    rng = np.random.default_rng(0 if part == "encoder" else 1)
    if part == "encoder":
        jmod = jax_cnn.Encoder(ch=32, ch_mult=MULT, z_channels=16)
        pmod = pt_cnn.Encoder(ch=32, ch_mult=MULT, z_channels=16)
        x = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
        to_sd, export = cnn_encoder_state_dict_from_flax, export_cnn_encoder
    else:
        jmod = jax_cnn.Decoder(ch=32, ch_mult=MULT)
        pmod = pt_cnn.Decoder(ch=32, ch_mult=MULT, z_channels=16)
        x = rng.normal(size=(B, PX // 2, PX // 2, 16)).astype(np.float32)
        to_sd, export = cnn_decoder_state_dict_from_flax, export_cnn_decoder
    params = random_params(jmod, jnp.asarray(x), seed=3)
    sd = to_sd(params, "", MULT)
    want_sd = export(params, "", MULT)
    assert sorted(sd) == sorted(want_sd) == sorted(pmod.state_dict())
    for k, v in want_sd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    pmod.load_state_dict(to_torch(sd), strict=True)
    kw = {"return_prelast": True} if part == "decoder" else {}
    want = jax.jit(lambda xx: jmod.apply({"params": params}, xx, **kw))(jnp.asarray(x))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), **kw)
    pairs = [(got, want, "out")] if part == "encoder" else [
        (got[0], want[0], "out"), (got[1], want[1], "pre_last")]
    for g, w, what in pairs:
        _close(g, w, what)


def _margs(cls, **kw):
    base = dict(enc_type="cnn", dec_type="cnn", encoder_ch_mult=MULT, decoder_ch_mult=MULT,
                codebook_size=64, codebook_embed_dim=8, v_patch_nums=(PX // 2,),
                num_latent_tokens=(PX // 2) ** 2, semantic_guide="none", detail_guide="none",
                image_size=PX)
    return cls(**{**base, **kw})


def _models(**kw):
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs, **kw))
    params = random_params(jm, jnp.asarray(img), train=False)
    cfg = _margs(PtArgs, **kw)
    pm = PtVQModel(cfg, device="cpu")
    pm.load_state_dict(vqmodel_state_dict_from_flax(params, cfg), strict=True)
    return jm, params, pm, cfg, img


@pytest.fixture(scope="module")
def cnn_models():
    return _models()


def _apply(jm, params, method, *args):
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))(params, *args)


def test_cnn_tokenizer_state_dict_codes_and_round_trip(cnn_models):
    jm, params, pm, cfg, img = cnn_models
    want = export_vqmodel(params, _margs(JaxArgs))
    got = pm.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    assert pm.encoder.conv_blocks[0].res[0].conv1.weight.shape == (128, 128, 3, 3)
    want_idx = _apply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    want_rec = _apply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    with torch.no_grad():
        got_idx = pm.img_to_idxBl(torch.from_numpy(img))
        got_rec = pm.img_to_reconstructed_img(torch.from_numpy(img))
    np.testing.assert_array_equal(_np(got_idx[0][0]), np.asarray(want_idx[0][0]))
    assert np.unique(np.asarray(want_idx[0][0])).size > 4
    _close(got_rec, want_rec, "round trip")


def test_cnn_tokenizer_training_forward_and_anchor_match_jax(cnn_models):
    jm, params, pm, cfg, img = cnn_models
    w = np.random.default_rng(3).normal(size=img.shape).astype(np.float32)

    def scalar(out, w):
        return (out.dec * w).sum() + out.vq_loss + out.commit_loss + (out.pre_last ** 2).mean()

    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(img), train=True)
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    got = pm(torch.from_numpy(img), train=True)
    scalar(got, torch.from_numpy(w)).backward()
    for k in ("dec", "pre_last", "vq_loss", "commit_loss"):
        _close(getattr(got, k), getattr(want, k), k)
    want_g = vqmodel_state_dict_from_flax(_tree_np(gp), cfg)
    # an AttnBlock's k bias adds one constant to each row of scores, which
    # the softmax takes away: its gradient is 0 in exact arithmetic, so it
    # is held to 1e-6 of the model's largest gradient, as RAR's k_norm bias
    floor = 1e-6 * max(np.abs(v.numpy()).max() for v in want_g.values())
    for name, p in pm.named_parameters():
        wg = want_g[name].numpy()
        if name.endswith(".k.bias"):
            np.testing.assert_allclose(_np(p.grad), wg, rtol=0, atol=floor, err_msg=name)
            continue
        _close(p.grad, wg, name, max(np.abs(wg).max(), 1e-12))
    w_last = np.asarray(_last_layer_kernel(_margs(JaxArgs), params["decoder"]))
    assert pm.last_layer is pm.decoder.conv_out.weight
    np.testing.assert_array_equal(_np(pm.last_layer), w_last.transpose(3, 2, 0, 1))


def test_mixed_pair_matches_jax():
    """A CNN encoder with a DINOv2 decoder: the 8 x 8 latents run through
    the ViT's latent stream (64 px images would make 4 x 4 patch tokens;
    the decoder's grid is the latents')."""
    jm, params, pm, _, img = _models(dec_type="dinov2", decoder_model=TINY,
                                     abs_pos_embed=True)
    want_idx = _apply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    want_rec = _apply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    with torch.no_grad():
        got_idx = pm.img_to_idxBl(torch.from_numpy(img))
        got_rec = pm.img_to_reconstructed_img(torch.from_numpy(img))
    np.testing.assert_array_equal(_np(got_idx[0][0]), np.asarray(want_idx[0][0]))
    _close(got_rec, want_rec, "round trip")


def test_product_quant_branches_match_jax():
    """The e2e pipeline's multi-scale CNN tokenizer (``product_quant=2``):
    the CNN encode has one branch, which the JAX package's quantizers index
    past its end (clamped to branch 0), so both branches quantize the same
    latent with their own codebooks; codes per branch and scale, the round
    trip, and the training forward's values."""
    jm, params, pm, _, img = _models(product_quant=2, v_patch_nums=(1, 2, PX // 2))
    want_idx = _apply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    want_rec = _apply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    with torch.no_grad():
        got_idx = pm.img_to_idxBl(torch.from_numpy(img))
        got_rec = pm.img_to_reconstructed_img(torch.from_numpy(img))
        got = pm(torch.from_numpy(img), train=True)
    assert len(got_idx) == len(want_idx) == 2
    for g_branch, w_branch in zip(got_idx, want_idx):
        for g, w in zip(g_branch, w_branch):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    _close(got_rec, want_rec, "round trip")
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=True))(params, jnp.asarray(img))
    for k in ("dec", "vq_loss", "commit_loss"):
        _close(getattr(got, k), getattr(want, k), k)
