"""Port parity, ViT modules: ``imagefolder_tpu_torch/models/vit.py`` against
flax on the CPU, with params carried by ``vqmodel_state_dict_from_flax``.

A tiny preset (width 64, depth 2, 2 heads; 64 px images, patch 16, 16
latents, so the latent grid is the patch grid) is added to both packages'
``VIT_PRESETS``. LayerScale is raised from its 1e-5 init so that the blocks,
and the attention inside them, move the outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.utils.convert import vqmodel_state_dict_from_flax
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG = 64


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _margs(cls, **kw):
    base = dict(codebook_size=64, codebook_embed_dim=8, v_patch_nums=(4,),
                enc_type="dinov2", dec_type="dinov2", encoder_model=TINY,
                decoder_model=TINY, semantic_guide="none", detail_guide="none",
                num_latent_tokens=16, abs_pos_embed=True, image_size=IMG)
    return cls(**{**base, **kw})


def _excite_layerscale(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(np.float32)
                    if k in ("ls1", "ls2") else _excite_layerscale(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


def _build(**kw):
    """(flax model, numpy params, port model, image) at the tiny config."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs, **kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), train=False)["params"]
    params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, params), rng)
    pm = PtVQModel(_margs(PtArgs, **kw), device="cpu")
    pm.load_state_dict(vqmodel_state_dict_from_flax(params, _margs(PtArgs, **kw)),
                       strict=True)
    return jm, params, pm.eval(), img


@pytest.fixture(scope="module")
def fp32_models():
    return _build()


@pytest.mark.parametrize("masked", [False, True])
def test_block_matches_flax(fp32_models, masked):
    _, params, pm, _ = fp32_models
    rng = np.random.default_rng(1)
    n = 33
    x = rng.normal(size=(2, n, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((1, 1, n, n), np.float32)
        mask[..., : n - 16, n - 16:] = -np.inf
    blk = jax_vit.Block(num_heads=2)
    want = blk.apply({"params": params["encoder"]["model"]["block_0"]}, jnp.asarray(x),
                     None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = pm.encoder.model.blocks[0](
            torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    # fp32 on both sides, summation order only; |out| <~ 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("use_attn_mask", [False, True])
def test_latent_encoder_matches_flax(fp32_models, use_attn_mask):
    jm, params, pm, img = fp32_models if not use_attn_mask else _build(
        enc_use_attn_mask=True)
    want = jm.apply({"params": params}, jnp.asarray(img),
                    method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        got = pm.encoder(torch.from_numpy(img))
    assert got.shape == (2, 16, 64)
    # final LayerNorm output, O(1) entries; fp32 summation order over 2 blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_latent_decoder_matches_flax(fp32_models):
    jm, params, pm, _ = fp32_models
    z = np.random.default_rng(2).normal(size=(2, 16, 64)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(z),
                    method=lambda m, x: m.decoder(x))
    with torch.no_grad():
        got = pm.decoder(torch.from_numpy(z))
    assert got.shape == (2, IMG, IMG, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_decoder_backbone_has_no_patch_embed(fp32_models):
    _, params, pm, _ = fp32_models
    assert "patch_embed" not in params["decoder"]["model"]
    assert not [k for k in pm.state_dict() if k.startswith("decoder.model.patch_embed")]
    assert "encoder.model.patch_embed.proj.weight" in pm.state_dict()


def test_unported_backbone_options_raise():
    # pre_norm (the CLIP teacher) is ported: tests/test_torch_robusttok.py;
    # LoRA, learned latent pos embeds and the conv, siren and identity heads
    # too (tests/test_torch_lora.py, tests/test_torch_topixel.py): what
    # raises is what the JAX package does not build either
    with pytest.raises(NotImplementedError):  # no such tuning method
        pt_vit.LatentEncoder(TINY, IMG, 16, num_latent_tokens=16, tuning_method="prefix")
    with pytest.raises(NotImplementedError):
        pt_vit.LatentDecoder(TINY, IMG, 16, num_latent_tokens=16, tuning_method="adapter")
    with pytest.raises(NotImplementedError):  # no such head
        pt_vit.LatentDecoder(TINY, IMG, 16, num_latent_tokens=16, to_pixel="mlp")
    enc = pt_vit.LatentEncoder(TINY, IMG, 16, num_latent_tokens=64, abs_pos_embed=False,
                               tuning_method="lora")
    assert enc.latent_pos_embed.shape == (1, 64, 64) and not hasattr(enc, "lvl_embed")
    dec = pt_vit.LatentDecoder(TINY, IMG, 16, num_latent_tokens=16, to_pixel="conv")
    assert dec.to_pixel.last_layer.shape == (64, 3, 16, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_without_layerscale_matches_flax(dtype):
    """The no-LayerScale block (DinoDisc's trunk: the composed path, residual
    in the activation dtype), forward and input gradient, against flax's
    Block(init_values=None) with the same params."""
    rng = np.random.default_rng(3)
    n, c = 29, 128
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    blk = jax_vit.Block(num_heads=2, init_values=None, dtype=jd)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    g = rng.normal(size=(2, n, c)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, blk.init(
        jax.random.PRNGKey(3), jnp.asarray(x, jd))["params"])
    assert "ls1" not in params
    out, vjp = jax.vjp(lambda t: blk.apply({"params": params}, t), jnp.asarray(x, jd))
    dx, = vjp(jnp.asarray(g, jd))
    mine = pt_vit.Block(c, 2, init_values=None, dtype=td)
    sd = {}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = params[name]["scale"], params[name]["bias"]
    for name, p in (("attn.qkv", params["attn"]["qkv"]), ("attn.proj", params["attn"]["proj"]),
                    ("mlp.fc1", params["mlp"]["fc1"]["base"]),
                    ("mlp.fc2", params["mlp"]["fc2"]["base"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["kernel"].T, p["bias"]
    mine.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    got = mine(tx)
    got.backward(torch.from_numpy(g).to(td))
    assert got.dtype == td and tx.grad.dtype == td
    # fp32: summation order over one block (|out| <~ 10). bf16: the residual
    # and every sublayer output are bf16 on both sides, a few roundings of
    # 2**-8 at |x| <~ 10; XLA's attention normalizes p before its rounding
    tol = 2e-5 if dtype == "float32" else 0.15
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(out.astype(jnp.float32)),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(dx.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_remat_gives_the_same_gradients(fp32_models):
    """run_blocks with remat recomputes each block in the backward: the same
    outputs and gradients as without."""
    _, _, pm, img = fp32_models
    x = torch.from_numpy(img)
    results = []
    for remat in (False, True):
        pm.encoder.model.remat = remat
        pm.zero_grad()
        out = pm.encoder(x)
        out.square().mean().backward()
        results.append((out.detach(), [p.grad.clone() for p in pm.encoder.parameters()]))
    pm.encoder.model.remat = False
    pm.zero_grad()
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for g0, g1 in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=1e-7)


def test_latent_decoder_prelast_matches_flax(fp32_models):
    jm, params, pm, _ = fp32_models
    z = np.random.default_rng(4).normal(size=(2, 16, 64)).astype(np.float32)
    want, want_pre = jm.apply({"params": params}, jnp.asarray(z),
                              method=lambda m, x: m.decoder(x, return_prelast=True))
    with torch.no_grad():
        got, pre = pm.decoder(torch.from_numpy(z), return_prelast=True)
    assert pre.shape == (2, (IMG // 16) ** 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pre.numpy(), np.asarray(want_pre), rtol=0, atol=1e-4)
