"""Port parity, LoRA finetuning: ``imagefolder_tpu_torch`` against the JAX
package on the CPU, on the same numpy-seeded inputs and parameters.

A tiny tokenizer (width 64, depth 2, 2 heads; 64 px, 16 latents, one
single-scale VQ) with ``enc_tuning_method='lat_lora'`` (adapters on qkv,
proj, fc1 and fc2, deltas on the latent tokens only, and the encoder's
attention mask it forces) and ``dec_tuning_method='lora'`` (adapters on fc1
and fc2, every token), rank 4:

- the adapters' flax parameters carried by the bridge below (the JAX
  package exports none), every other one by ``vqmodel_state_dict_from_flax``
  (the base Dense of a LoRADense included), loading with ``strict=True``;
  the parameters are drawn from a numpy seed (``_torch_parity``), the
  adapters' B matrices non-zero (flax inits them to 0) so that both factors
  carry gradient;
- the encoder's latents, the decoder's image, the round trip and the
  training forward's values and every parameter's gradient (adapters
  included);
- the frozen predicate per parameter (``train/optim.py``) against the JAX
  package's ``tokenizer_frozen_predicate`` on the flax path, under each
  pair of tuning methods, and that LoRA blocks never fuse.

Tolerances: codes exact; values and gradients within 1e-4 of the largest
(fp32, two ViT blocks a side, summation order only).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.train import optim
from imagefolder_tpu_torch.utils.convert import flax_path, to_torch, vqmodel_state_dict_from_flax

from tests._torch_parity import one_torch_thread, random_params  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG, B, RANK = 64, 2, 4
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _margs(cls, enc="lat_lora", dec="lora"):
    return cls(codebook_size=64, codebook_embed_dim=8, v_patch_nums=(4,), enc_type="dinov2",
               dec_type="dinov2", encoder_model=TINY, decoder_model=TINY,
               semantic_guide="none", detail_guide="none", num_latent_tokens=16,
               abs_pos_embed=True, image_size=IMG, enc_tuning_method=enc,
               dec_tuning_method=dec, lora_rank=RANK)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def jax_path(name: str, cfg) -> str:
    """A port parameter's flax path: ``flax_path``, with the base Dense that
    a LoRADense holds under 'base' for qkv and proj under lat_lora."""
    path = flax_path(name)
    side = name.split(".", 1)[0]
    method = {"encoder": cfg.enc_tuning_method, "decoder": cfg.dec_tuning_method}.get(side)
    if method == "lat_lora":
        path = re.sub(r"/attn/(qkv|proj)/(kernel|bias)$", r"/attn/\1/base/\2", path)
    return path


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def lora_state_dict_from_flax(params, model: torch.nn.Module, cfg) -> dict:
    """The bridge for the adapters: each ``lora_a``/``lora_b`` weight of the
    port model from its flax kernel, transposed to (out, in)."""
    return to_torch({name: _leaf(params, jax_path(name, cfg)).T
                     for name, _ in model.named_parameters() if ".lora_" in name})


def _load(params, cfg) -> PtVQModel:
    model = PtVQModel(cfg, device="cpu")
    sd = vqmodel_state_dict_from_flax(params, cfg)
    sd.update(lora_state_dict_from_flax(params, model, cfg))
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def lora_models():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs))
    params = random_params(jm, jnp.asarray(img), train=False)
    cfg = _margs(PtArgs)
    return jm, params, _load(params, cfg), cfg, img


def test_adapters_where_the_jax_package_puts_them(lora_models):
    """lat_lora: adapters on qkv, proj, fc1 and fc2 of the encoder, latent
    deltas only, and the attention mask; lora: on fc1 and fc2 of the
    decoder, every token; no block of either fuses."""
    _, params, pm, cfg, _ = lora_models
    names = [n for n, _ in pm.named_parameters() if ".lora_" in n]
    enc = {re.sub(r"blocks\.\d+\.", "", n) for n in names if n.startswith("encoder.")}
    dec = {re.sub(r"blocks\.\d+\.", "", n) for n in names if n.startswith("decoder.")}
    assert enc == {f"encoder.model.{m}.{x}.lora_{ab}.weight" for m, x in
                   (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2"))
                   for ab in "ab"}
    assert dec == {f"decoder.model.mlp.{x}.lora_{ab}.weight" for x in ("fc1", "fc2")
                   for ab in "ab"}
    assert pm.encoder.use_attn_mask and pm.encoder.model.blocks[0].mlp.fc1.latent_tokens == 16
    assert pm.decoder.model.blocks[0].mlp.fc1.latent_tokens == 0
    assert pm.encoder.model.blocks[0].attn.qkv.lora_a.weight.shape == (RANK, 64)
    assert pt_vit.set_fused_sublayers(pm, True, True) == 0
    with pytest.raises(ValueError, match="never fuses"):
        pt_vit.Block(64, 2, lora_rank=RANK, fuse_attn=True)


def _apply(jm, params, method, *args):
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))(params, *args)


def test_encoder_decoder_and_round_trip_match_jax(lora_models):
    jm, params, pm, _, img = lora_models
    want = _apply(jm, params, lambda m, x: m.encoder(x), jnp.asarray(img))
    with torch.no_grad():
        got = pm.encoder(torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(np.asarray(want)).max())
    want = _apply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    with torch.no_grad():
        got = pm.img_to_reconstructed_img(torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    want_idx = _apply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    with torch.no_grad():
        got_idx = pm.img_to_idxBl(torch.from_numpy(img))
    np.testing.assert_array_equal(_np(got_idx[0][0]), np.asarray(want_idx[0][0]))


def test_training_forward_and_gradients_match_jax(lora_models):
    """The decoder output, the losses and every parameter's gradient of one
    scalar of them, the adapters' through the bridge."""
    jm, params, pm, cfg, img = lora_models
    w = np.random.default_rng(3).normal(size=img.shape).astype(np.float32)

    def scalar(out, w):
        return (out.dec * w).sum() + out.vq_loss + out.commit_loss

    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(img), train=True)
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    got = pm(torch.from_numpy(img), train=True)
    scalar(got, torch.from_numpy(w)).backward()
    for k in ("dec", "vq_loss", "commit_loss"):
        wv = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(got, k)), wv, rtol=0,
                                   atol=TOL * max(np.abs(wv).max(), 1.0), err_msg=k)
    gp = jax.tree_util.tree_map(np.asarray, gp)
    want_g = vqmodel_state_dict_from_flax(gp, cfg)
    want_g.update(lora_state_dict_from_flax(gp, pm, cfg))
    n_lora = 0
    for name, p in pm.named_parameters():
        wg = want_g[name].numpy()
        n_lora += ".lora_" in name and np.abs(wg).max() > 0
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=TOL * max(np.abs(wg).max(), 1e-12), err_msg=name)
    assert n_lora == 16 + 8  # every A and B of both sides carries gradient


@pytest.mark.parametrize("enc,dec", [("lat_lora", "lora"), ("lora", "frozen"),
                                     ("frozen", "lat_lora"), ("full", "lora")])
def test_frozen_predicate_matches_jax(lora_models, enc, dec):
    """Per parameter: the port's frozen label on its flax path equals the
    JAX package's on the JAX tree's path (adapters, the trunks' final
    norms and what lies outside the trunks train; 'frozen' freezes a whole
    side), and every path is a leaf of the JAX tree built the same way."""
    _, params, pm, _, _ = lora_models
    jcfg, pcfg = _margs(JaxArgs, enc, dec), _margs(PtArgs, enc, dec)
    model = pm if (enc, dec) == ("lat_lora", "lora") else PtVQModel(pcfg, device="cpu")
    jm = JaxVQModel(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)), train=False),
                            jax.random.PRNGKey(0))["params"]
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    jax_frozen = jax_optim.tokenizer_frozen_predicate(jcfg)
    port_frozen = optim.tokenizer_frozen_predicate(pcfg)
    paths = optim.module_flax_paths(model)
    counts = [0, 0]
    for name, _ in model.named_parameters():
        path = jax_path(name, pcfg)
        assert path in leaves, name
        assert port_frozen(paths[name]) == jax_frozen(path), (name, path)
        counts[jax_frozen(path)] += 1
    assert counts[0] > 0 and counts[1] > 0
