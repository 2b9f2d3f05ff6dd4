"""Port parity, multi-scale tokenizer: ``imagefolder_tpu_torch`` against the JAX
package on the CPU, on the same numpy-seeded inputs.

- ``resize_matrix`` / ``resize`` in all four modes;
- ``MultiScaleVQ``'s inference surface for each Phi sharing (0, 1, 4), over
  ``patch_nums`` (1, 2, 3) and over (1, 1, 2, 3, 3), whose repeated sizes are
  told apart by position; its training forward with an injected quantizer
  dropout draw (values, losses, hits and gradients), ``update_usage_ema``
  and ``usage_percent``;
- the product-quantized tokenizer (P = 2, scales (1, 2, 3), a 3x3 latent grid
  per branch under a 4x4 patch grid) at a tiny ViT preset (width 64, depth 2,
  2 heads; 64 px).

Params are carried by ``imagefolder_tpu_torch.utils.convert``. Tolerances:
indices equal; fp32 values within 1e-5 for the quantizer (a handful of fp32
matmuls) and 1e-4 for the tokenizer (two ViT blocks on each side, summation
order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.ops.resize import resize as jax_resize
from imagefolder_tpu.ops.resize import resize_matrix as jax_resize_matrix
from imagefolder_tpu.ops.quantize import MultiScaleVQ as JaxMSVQ
from imagefolder_tpu.ops.quantize import update_usage_ema as jax_update_usage_ema
from imagefolder_tpu.ops.quantize import usage_percent as jax_usage_percent
from imagefolder_tpu.utils.convert_torch import export_vqmodel
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.tokenizer import VQModel as PtVQModel
from imagefolder_tpu_torch.ops.resize import resize as pt_resize
from imagefolder_tpu_torch.ops.resize import resize_matrix as pt_resize_matrix
from imagefolder_tpu_torch.ops.quantize import MultiScaleVQ as PtMSVQ
from imagefolder_tpu_torch.ops.quantize import phi_index, update_usage_ema, usage_percent
from imagefolder_tpu_torch.utils.convert import (
    multiscale_vq_state_dict_from_flax,
    to_torch,
    vqmodel_state_dict_from_flax,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG = 64
V, C = 64, 8
Q_TOL, M_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------- resize ------------------------------- #

@pytest.mark.parametrize("mode", ["bicubic", "bicubic_aa", "area", "nearest"])
def test_resize_matrix_matches_jax(mode):
    for out_size, in_size in [(3, 11), (11, 3), (16, 37), (7, 7), (1, 5), (11, 16)]:
        np.testing.assert_array_equal(pt_resize_matrix(out_size, in_size, mode),
                                      jax_resize_matrix(out_size, in_size, mode))


@pytest.mark.parametrize("mode", ["bicubic", "area"])
def test_resize_matches_jax(mode):
    x = np.random.default_rng(0).normal(size=(2, 11, 11, 5)).astype(np.float32)
    for size in [(3, 3), (16, 16), (1, 1)]:
        want = jax_resize(jnp.asarray(x), size, mode)
        got = pt_resize(torch.from_numpy(x), size, mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=Q_TOL)
    with pytest.raises(ValueError):
        pt_resize(torch.from_numpy(x), (3, 3), "lanczos")


# ---------------------------- MultiScaleVQ ---------------------------- #

CASES = [(0, (1, 2, 3)), (1, (1, 2, 3)), (4, (1, 2, 3)), (4, (1, 1, 2, 3, 3))]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"share{c[0]}-pns{len(c[1])}")
def msvq(request):
    share, pns = request.param
    f = np.random.default_rng(1).normal(size=(3, pns[-1], pns[-1], C)).astype(np.float32)
    jq = JaxMSVQ(vocab_size=V, Cvae=C, v_patch_nums=pns, share_quant_resi=share)
    params = jax.tree_util.tree_map(
        np.asarray, jq.init(jax.random.PRNGKey(share), jnp.asarray(f))["params"])
    pq = PtMSVQ(V, C, pns, share_quant_resi=share)
    pq.load_state_dict(to_torch(multiscale_vq_state_dict_from_flax(params, len(pns), share)),
                       strict=True)
    return jq, params, pq.eval(), f


def _japply(jq, params, method, *args):
    return jq.apply({"params": params}, *args, method=method)


def test_msvq_indices_and_fhat(msvq):
    jq, params, pq, f = msvq
    want_idx = _japply(jq, params, JaxMSVQ.f_to_idxBl_or_fhat, jnp.asarray(f), False)
    want_fhat = _japply(jq, params, JaxMSVQ.f_to_idxBl_or_fhat, jnp.asarray(f), True)
    got_idx = pq.f_to_idxBl_or_fhat(torch.from_numpy(f), False)
    got_fhat = pq.f_to_idxBl_or_fhat(torch.from_numpy(f), True)
    assert len(got_idx) == len(want_idx) == len(pq.v_patch_nums)
    assert np.unique(np.concatenate([np.asarray(w).ravel() for w in want_idx])).size > 4
    for si, (g, w) in enumerate(zip(got_idx, want_idx)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=f"scale {si}")
    for g, w in zip(got_fhat, want_fhat):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=Q_TOL)


def test_msvq_var_input_and_embed_to_fhat(msvq):
    jq, params, pq, f = msvq
    idx = [np.asarray(i) for i in
           _japply(jq, params, JaxMSVQ.f_to_idxBl_or_fhat, jnp.asarray(f), False)]
    for prog_si in (-1, 2):
        want = _japply(jq, params, JaxMSVQ.idxBl_to_var_input,
                       [jnp.asarray(i) for i in idx], prog_si)
        got = pq.idxBl_to_var_input([torch.from_numpy(i.astype(np.int64)) for i in idx],
                                    prog_si)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=Q_TOL)
    pns = pq.v_patch_nums
    hs = [np.asarray(params["codebook"])[i].reshape(3, p, p, C) for i, p in zip(idx, pns)]
    for last_one in (False, True):
        want = _japply(jq, params, JaxMSVQ.embed_to_fhat, [jnp.asarray(h) for h in hs],
                       last_one)
        got = pq.embed_to_fhat([torch.from_numpy(h) for h in hs], last_one)
        for g, w in zip(got if not last_one else [got], want if not last_one else [want]):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=Q_TOL)


def test_msvq_next_autoregressive_input(msvq):
    jq, params, pq, f = msvq
    pns = pq.v_patch_nums
    rng = np.random.default_rng(2)
    f_hat = rng.normal(size=(3, pns[-1], pns[-1], C)).astype(np.float32)
    for si, pn in enumerate(pns):
        h = rng.normal(size=(3, pn, pn, C)).astype(np.float32)
        want = _japply(jq, params, JaxMSVQ.get_next_autoregressive_input, si, len(pns),
                       jnp.asarray(f_hat), jnp.asarray(h))
        got = pq.get_next_autoregressive_input(si, len(pns), torch.from_numpy(f_hat),
                                               torch.from_numpy(h))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=Q_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_msvq_training_forward_matches_jax(msvq, train):
    """The training call with codebook_drop 0.5 (the first of 3 samples
    adopts the injected dropout draw): f_hat, vq and commit losses, hits,
    and the gradients of one scalar of them in f, the codebook and the Phis."""
    jq0, params, pq0, f = msvq
    pns = pq0.v_patch_nums
    jq = JaxMSVQ(vocab_size=V, Cvae=C, v_patch_nums=pns, share_quant_resi=jq0.share_quant_resi,
                 codebook_drop=0.5)
    pq = PtMSVQ(V, C, pns, share_quant_resi=jq0.share_quant_resi, codebook_drop=0.5)
    pq.load_state_dict(pq0.state_dict(), strict=True)
    dropout_n = np.array([2, 1, 3])
    w = np.random.default_rng(4).normal(size=f.shape).astype(np.float32)

    def scalar(out, w):
        return (out.f_hat * w).sum() + out.vq_loss + 2.0 * out.commit_loss

    def jax_loss(p, x):
        out = jq.apply({"params": p}, x, dropout_n=jnp.asarray(dropout_n), train=train)
        return scalar(out, jnp.asarray(w)), out

    (_, want), (gp, gf) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(f))
    tf = torch.from_numpy(f).requires_grad_()
    got = pq(tf, dropout_n=torch.from_numpy(dropout_n), train=train)
    scalar(got, torch.from_numpy(w)).backward()
    np.testing.assert_allclose(_np(got.f_hat), np.asarray(want.f_hat), rtol=0, atol=Q_TOL)
    for k in ("vq_loss", "commit_loss", "entropy_loss"):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)), rtol=0,
                                   atol=Q_TOL, err_msg=k)
    np.testing.assert_array_equal(_np(got.hits_SV), np.asarray(want.hits_SV))
    assert got.hits_SV.shape == (len(pns), V) and got.hits_SV.sum() == 3 * sum(
        p * p for p in pns)
    np.testing.assert_allclose(_np(tf.grad), np.asarray(gf), rtol=0, atol=Q_TOL)
    want_g = to_torch(multiscale_vq_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, gp), len(pns), jq.share_quant_resi))
    for name, p in pq.named_parameters():
        wg = want_g[name].numpy()
        if p.grad is None:  # a Phi that no scale applies
            assert not wg.any(), name
            continue
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=Q_TOL * max(1.0, np.abs(wg).max()), err_msg=name)
    used = pq.phis_used()
    if pq.quant_resi is not None:
        assert {i for i, phi in enumerate(pq.quant_resi) if phi.weight.grad is not None} == used


@pytest.mark.parametrize("record_hit", [0, 5, 150])
def test_usage_ema_and_percent_match_jax(record_hit):
    rng = np.random.default_rng(record_hit)
    ema = rng.uniform(0, 3, (2, 3, V)).astype(np.float32)
    hits = rng.integers(0, 5, (2, 3, V)).astype(np.float32)
    want, want_rec = jax_update_usage_ema(jnp.asarray(ema), jnp.asarray(hits), record_hit)
    got, rec = update_usage_ema(torch.from_numpy(ema), torch.from_numpy(hits), record_hit)
    assert rec == int(want_rec) == record_hit + 1
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    pct = usage_percent(got, 12.0 * 3, V)
    assert pct.shape == (2, 3)
    np.testing.assert_allclose(_np(pct), np.asarray(jax_usage_percent(want, 12.0 * 3, V)),
                               rtol=0, atol=1e-4)


def test_msvq_embed(msvq):
    jq, params, pq, _ = msvq
    idx = np.random.default_rng(3).integers(0, V, (3, 4))
    want = _japply(jq, params, JaxMSVQ.embed, jnp.asarray(idx))
    got = pq.embed(torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ------------------------ product-quantized VQModel ------------------------ #

def _margs(cls, **kw):
    base = dict(codebook_size=V, codebook_embed_dim=C, v_patch_nums=(1, 2, 3),
                product_quant=2, enc_type="dinov2", dec_type="dinov2",
                encoder_model=TINY, decoder_model=TINY, semantic_guide="none",
                detail_guide="none", num_latent_tokens=9, abs_pos_embed=True,
                image_size=IMG)
    return cls(**{**base, **kw})


def _excite_layerscale(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(np.float32)
                    if k in ("ls1", "ls2") else _excite_layerscale(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def pq_models():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxVQModel(_margs(JaxArgs))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), train=False)["params"]
    params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, params), rng)
    margs = _margs(PtArgs)
    pm = PtVQModel(margs, device="cpu")
    pm.load_state_dict(vqmodel_state_dict_from_flax(params, margs), strict=True)
    return jm, params, pm.eval(), img


def _mapply(jm, params, method, *args):
    return jm.apply({"params": params}, *args, method=method)


def test_pq_state_dict_matches_export_vqmodel(pq_models):
    """Every key export_vqmodel writes, with its shape and value; the only
    extra keys are the Phi that no scale picks (of K = 4 over three scales,
    ratio 0.5 goes to phi_2, so phi_1 is never used), which flax never built
    and the converter fills with zeros."""
    _, params, pm, _ = pq_models
    want = export_vqmodel(params, _margs(JaxArgs))
    got = pm.state_dict()
    extra = sorted(set(got) - set(want))
    assert not set(want) - set(got)
    unused = sorted(set(range(4)) - {phi_index(si / 2, 4) for si in range(3)})
    assert unused == [1]
    assert extra == [f"quantizes.{i}.quant_resi.qresi_ls.{k}.{w}"
                     for i in range(2) for k in unused for w in ("bias", "weight")]
    assert all(not got[k].any() for k in extra)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def test_pq_encoder_resamples_pos_embed(pq_models):
    jm, params, pm, img = pq_models
    want = jm.apply({"params": params}, jnp.asarray(img), method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        got = pm.encoder(torch.from_numpy(img))
    assert got.shape == (2, 18, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=M_TOL)


def test_pq_img_to_idxBl(pq_models):
    jm, params, pm, img = pq_models
    want = _mapply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    with torch.no_grad():
        got = pm.img_to_idxBl(torch.from_numpy(img))
    assert len(got) == 2 and all(len(b) == 3 for b in got)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_pq_img_to_reconstructed_img(pq_models):
    jm, params, pm, img = pq_models
    want = _mapply(jm, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img), False)
    with torch.no_grad():
        got = pm.img_to_reconstructed_img(torch.from_numpy(img), last_one=False)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (2, IMG, IMG, 3)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=M_TOL)


def test_pq_var_interface(pq_models):
    """idxBl_to_var_input, get_next_autoregressive_input, embed_branch and
    fhat_to_img of the PQ tokenizer, on JAX's own codes."""
    jm, params, pm, img = pq_models
    idx = [[np.asarray(i) for i in b]
           for b in _mapply(jm, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))]
    t_idx = [[torch.from_numpy(i.astype(np.int64)) for i in b] for b in idx]
    with torch.no_grad():
        want = _mapply(jm, params, JaxVQModel.idxBl_to_var_input,
                       [[jnp.asarray(i) for i in b] for b in idx])
        got = pm.idxBl_to_var_input(t_idx)
        assert got.shape == (2, 1 + 4 + 9 - 1, 2 * C)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=Q_TOL)
        assert pm.idxBl_to_var_input(t_idx, prog_si=0) is None

        f_hat_j = jnp.zeros((2, 3, 3, 2 * C))
        f_hat_t = torch.zeros((2, 3, 3, 2 * C))
        for si, pn in enumerate((1, 2, 3)):
            hs_j = [_mapply(jm, params, JaxVQModel.embed_branch, i, jnp.asarray(idx[i][si]))
                    for i in range(2)]
            hs_t = [pm.embed_branch(i, t_idx[i][si]) for i in range(2)]
            for hj, ht in zip(hs_j, hs_t):
                np.testing.assert_array_equal(_np(ht), np.asarray(hj))
            h_j = jnp.concatenate([h.reshape(2, pn, pn, C) for h in hs_j], axis=-1)
            h_t = torch.cat([h.reshape(2, pn, pn, C) for h in hs_t], dim=-1)
            f_hat_j, nxt_j = _mapply(jm, params, JaxVQModel.get_next_autoregressive_input,
                                     si, 3, f_hat_j, h_j)
            f_hat_t, nxt_t = pm.get_next_autoregressive_input(si, 3, f_hat_t, h_t)
            np.testing.assert_allclose(_np(f_hat_t), np.asarray(f_hat_j), rtol=0, atol=Q_TOL)
            np.testing.assert_allclose(_np(nxt_t), np.asarray(nxt_j), rtol=0, atol=Q_TOL)
        want_img = _mapply(jm, params, JaxVQModel.fhat_to_img, f_hat_j)
        got_img = pm.fhat_to_img(f_hat_t)
        np.testing.assert_allclose(_np(got_img), np.asarray(want_img), rtol=0, atol=M_TOL)


def test_pq_soft_embed_branch(pq_models):
    jm, params, pm, _ = pq_models
    probs = np.random.default_rng(5).dirichlet(np.ones(V), size=(2, 4)).astype(np.float32)
    for i in range(2):
        want = _mapply(jm, params, JaxVQModel.soft_embed_branch, i, jnp.asarray(probs))
        got = pm.soft_embed_branch(i, torch.from_numpy(probs))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=Q_TOL)


def test_model_entry_points_default_to_the_card():
    """Without device="cpu" the model is moved to CUDA, which this build of
    torch refuses when it has no card, instead of staying on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        PtVQModel(_margs(PtArgs))
