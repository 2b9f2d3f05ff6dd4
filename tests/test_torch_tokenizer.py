"""Port parity, tokenizer round trip: ``imagefolder_tpu_torch`` against the JAX
``VQModel`` on the CPU at a tiny config (width 64, depth 2, 2 heads; 64 px,
patch 16, 16 latents; a 64 x 8 codebook), with params carried by
``vqmodel_state_dict_from_flax``. LayerScale is raised from its 1e-5 init so
that the blocks move the outputs.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.utils.convert_torch import export_vqmodel
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.utils.convert import vqmodel_state_dict_from_flax
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG = 64
NEAR_TIE = 1e-5  # tokens may differ only where the two distances are this close


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


def _build(dtype_str):
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs, dtype_str=dtype_str))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), train=False)["params"]
    params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, params), rng)
    margs = _margs(PtArgs, dtype_str=dtype_str)
    pm = PtVQModel(margs, device="cpu")
    pm.load_state_dict(vqmodel_state_dict_from_flax(params, margs), strict=True)
    return jm, params, pm.eval(), img


@pytest.fixture(scope="module")
def fp32_models():
    return _build("float32")


def _japply(jm, params, method, x):
    return np.asarray(jm.apply({"params": params}, jnp.asarray(x), method=method))


def _assert_tokens_agree(got, want, z_pre, codebook):
    """Equal tokens, except where the JAX distances of the two codes tie
    within NEAR_TIE (fp32 summation order may pick either)."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    z = z_pre.reshape(-1, z_pre.shape[-1]).astype(np.float64)
    z = z / (np.linalg.norm(z, axis=-1, keepdims=True) + 1e-12)
    e = codebook / (np.linalg.norm(codebook, axis=-1, keepdims=True) + 1e-12)
    d = (z ** 2).sum(-1)[:, None] + (e ** 2).sum(-1)[None] - 2 * z @ e.T
    gap = np.abs(d[diff, got[diff]] - d[diff, want[diff]])
    assert (gap <= NEAR_TIE).all(), (diff, gap)


def test_state_dict_matches_export_vqmodel(fp32_models):
    _, params, pm, _ = fp32_models
    want = export_vqmodel(params, _margs(JaxArgs))
    got = pm.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def test_round_trip_matches_jax_fp32(fp32_models):
    jm, params, pm, img = fp32_models
    codebook = params["quantize"]["codebook"].astype(np.float64)
    z_pre = _japply(jm, params, JaxVQModel.encode, img)
    want_tok = _japply(jm, params, JaxVQModel.encode_to_tokens, img)
    want_img = _japply(jm, params, JaxVQModel.img_to_reconstructed_img, img)
    want_dec = _japply(jm, params, JaxVQModel.decode_tokens, want_tok)
    with torch.no_grad():
        x = torch.from_numpy(img)
        got_pre = pm.encode(x)
        got_tok = pm.encode_to_tokens(x)
        got_img = pm.img_to_reconstructed_img(x)
        got_dec = pm.decode_tokens(torch.from_numpy(want_tok.astype(np.int64)))
    assert got_tok.shape == (3, 16) and got_img.shape == (3, IMG, IMG, 3)
    assert np.unique(want_tok).size > 4  # the search is not degenerate
    # fp32 on both sides (JAX at HIGHEST): summation order only
    np.testing.assert_allclose(got_pre.numpy(), z_pre, rtol=0, atol=1e-4)
    _assert_tokens_agree(got_tok.numpy(), want_tok, z_pre, codebook)
    np.testing.assert_allclose(got_dec.numpy(), want_dec, rtol=0, atol=1e-4)
    if np.array_equal(got_tok.numpy(), want_tok):
        np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=1e-4)
    assert got_img.abs().max() <= 1.0


def test_round_trip_bf16_dtype_flow():
    jm, params, pm, img = _build("bfloat16")
    z_pre = _japply(jm, params, JaxVQModel.encode, img)
    want_tok = _japply(jm, params, JaxVQModel.encode_to_tokens, img)
    want_dec = _japply(jm, params, JaxVQModel.decode_tokens, want_tok)
    with torch.no_grad():
        x = torch.from_numpy(img)
        got_pre = pm.encode(x)
        got_tok = pm.encode_to_tokens(x)
        got_dec = pm.decode_tokens(torch.from_numpy(want_tok.astype(np.int64)))
        tokens = pm.encoder(x)
    # the encoder ends in the activation dtype; quant_conv/ToPixel promote to fp32
    assert tokens.dtype == torch.bfloat16
    assert got_pre.dtype == torch.float32 and got_dec.dtype == torch.float32
    # bf16 activations: a few bf16 roundings (8 mantissa bits) of O(1) values
    # per block, which the two frameworks place differently in the attention
    np.testing.assert_allclose(got_pre.numpy(), z_pre, rtol=0, atol=5e-2)
    np.testing.assert_allclose(got_dec.numpy(), want_dec, rtol=0, atol=5e-2)
    # near-tied codes may flip under bf16 rounding (44 of 48 agree at this seed)
    assert (got_tok.numpy() == want_tok).mean() >= 0.8


# every option the JAX package's ModelArgs reaches is ported now (the CNN
# sides, LFQ/BSQ, learned latent pos embeds, LoRA and lat_lora, the conv,
# siren and identity heads: tests/test_torch_{cnn,lfq,lora,topixel}.py);
# what still raises is what the JAX package does not build either
VARIANTS = [
    dict(enc_type="cnn"), dict(dec_type="cnn"), dict(lfq=True, codebook_embed_dim=6),
    dict(v_patch_nums=(1, 2, 4), lfq=True, codebook_embed_dim=6), dict(abs_pos_embed=False),
    dict(enc_tuning_method="lat_lora"), dict(to_pixel="siren"),
    dict(dec_tuning_method="lora"),
]


@pytest.mark.parametrize("override", [
    dict(enc_type="vit"), dict(dec_type="stylegan"), dict(semantic_guide="clip"),
    dict(enc_tuning_method="prefix"), dict(dec_tuning_method="adapter"),
    dict(to_pixel="mlp"), dict(enc_type="cnn", dec_type="vit"), dict(to_pixel="deconv"),
])
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError):
        PtVQModel(_margs(PtArgs, **override), device="cpu")


@pytest.mark.parametrize("override", VARIANTS)
def test_variant_options_build(override):
    """The options that raised before the variants were ported now build."""
    model = PtVQModel(_margs(PtArgs, **override), device="cpu")
    for key, value in override.items():
        assert getattr(model.config, key) == value


def test_port_never_imports_jax():
    """Importing every module of the port and running a CPU round trip
    leaves jax, flax and the JAX package out of sys.modules."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import torch
        import imagefolder_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        from imagefolder_tpu_torch.models import vit
        from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
        vit.VIT_PRESETS["{TINY}"] = {TINY_PRESET!r}
        m = VQModel(ModelArgs(codebook_size=64, codebook_embed_dim=8,
                    v_patch_nums=(4,), enc_type="dinov2", dec_type="dinov2",
                    encoder_model="{TINY}", decoder_model="{TINY}",
                    semantic_guide="none", detail_guide="none",
                    num_latent_tokens=16, abs_pos_embed=True, image_size={IMG}),
                    generator=torch.Generator().manual_seed(0), device="cpu")
        x = torch.rand(1, {IMG}, {IMG}, 3, generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            y = m.img_to_reconstructed_img(x * 2 - 1)
        assert y.shape == (1, {IMG}, {IMG}, 3) and bool(torch.isfinite(y).all())
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "imagefolder_tpu"))
        assert not bad, bad
        print("no-jax-ok")
    """)
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout
