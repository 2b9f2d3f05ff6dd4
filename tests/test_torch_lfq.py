"""Port parity, LFQ/BSQ: ``imagefolder_tpu_torch`` against the JAX package on
the CPU, on the same numpy-seeded inputs.

- ``MultiScaleLFQ``'s bits <-> indices at Cvae 12 and 14 (int32);
- its inference surface (codes, f_hat) and VAR interface
  (``idxBl_to_var_input``, ``get_next_autoregressive_input``, ``embed`` at
  each scale), for BSQ (``using_znorm``) and plain LFQ;
- its training call in both entropy modes (soft, the default, and MagViT's
  hard logits entropy) with quantizer dropout injected: f_hat, the vq,
  commit and entropy losses, the hits, and the gradients in f and the Phis
  through the straight-through path and the entropy loss;
- a tiny MSBR tokenizer (``configs/MSBR10P2-4096.yaml`` through both
  loaders, at a tiny ViT preset: width 64, depth 2, 2 heads; 64 px, P = 2,
  scales (1, 1, 2, 3), no teachers): the converter against ``export_vqmodel``, the round
  trip, ``img_to_idxBl``, the training forward (dropout injected) with its
  gradients, and a greedy ``var_sample`` on it, every code equal.

Tolerances: codes and greedy tokens exact; quantizer values and losses
within 1e-5 (fp32, a few resizes and 3x3 convs); the tokenizer within 1e-4
of the largest value (two ViT blocks a side, summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import build_vae_var as jax_build_vae_var
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.ops.quantize import MultiScaleLFQ as JaxLFQ
from imagefolder_tpu.train.var_train import var_sample as jax_var_sample
from imagefolder_tpu.utils.config import load_tokenizer_config as jax_load
from imagefolder_tpu.utils.convert_torch import export_vqmodel
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.ops.quantize import MultiScaleLFQ as PtLFQ
from imagefolder_tpu_torch.train.var_train import var_sample
from imagefolder_tpu_torch.utils.config import load_tokenizer_config as pt_load
from imagefolder_tpu_torch.utils.convert import (
    phi_bank_state_dict_from_flax,
    to_torch,
    var_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)

from tests._torch_parity import one_torch_thread, random_params  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
Q_TOL, M_TOL = 1e-5, 1e-4
C, PNS = 6, (1, 2, 3)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(znorm: bool, soft: bool = True, drop: float = 0.0, c: int = C, pns=PNS):
    kw = dict(using_znorm=znorm, codebook_drop=drop, scale=0.9, entropy_weight=0.1,
              soft_entropy=soft)
    jq = JaxLFQ(codebook_size=2 ** c, Cvae=c, v_patch_nums=pns, **kw)
    f = np.zeros((1, pns[-1], pns[-1], c), np.float32)
    params = random_params(jq, jnp.asarray(f), seed=c)
    pq = PtLFQ(2 ** c, c, pns, **kw)
    pq.load_state_dict(to_torch(phi_bank_state_dict_from_flax(params, len(pns), 4, c)),
                       strict=True)
    return jq, params, pq


@pytest.fixture(scope="module", params=[True, False], ids=["bsq", "lfq"])
def lfq(request):
    jq, params, pq = _pair(request.param)
    f = np.random.default_rng(1).normal(size=(3, PNS[-1], PNS[-1], C)).astype(np.float32)
    return jq, params, pq, f


def _is_array(a) -> bool:
    return isinstance(a, (jnp.ndarray, np.ndarray, list))


def _japply(jq, params, method, *args):
    """``method`` of the flax module, jitted with its array (and list of
    array) arguments traced and the rest static."""

    def fn(p, arrays):
        it = iter(arrays)
        return jq.apply({"params": p}, *(next(it) if _is_array(a) else a for a in args),
                        method=method)

    return jax.jit(fn)(params, [a for a in args if _is_array(a)])


@pytest.mark.parametrize("c", [12, 14])
def test_bits_and_indices_match_jax(c):
    """Neither side's bits touch a parameter: the JAX module is applied
    without any."""
    kw = dict(using_znorm=True, scale=0.9)
    jq = JaxLFQ(codebook_size=2 ** c, Cvae=c, v_patch_nums=(1, 2), **kw)
    pq = PtLFQ(2 ** c, c, (1, 2), **kw)
    rng = np.random.default_rng(c)
    bits = rng.integers(0, 2, (5, 7, c)).astype(bool)
    want = jq.apply({}, jnp.asarray(bits), method=JaxLFQ.bits_to_indices)
    got = pq.bits_to_indices(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    idx = rng.integers(0, 2 ** c, (4, 9))
    for si in (None, 0, 1):
        want = jq.apply({}, jnp.asarray(idx), si, method=JaxLFQ.indices_to_bits)
        got = pq.indices_to_bits(torch.from_numpy(idx), si)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert torch.equal(pq.bits_to_indices(pq.indices_to_bits(torch.from_numpy(idx))).long(),
                       torch.from_numpy(idx))


def test_lfq_codes_fhat_and_var_interface(lfq):
    jq, params, pq, f = lfq
    want_idx = _japply(jq, params, JaxLFQ.f_to_idxBl_or_fhat, jnp.asarray(f), False)
    want_fhat = _japply(jq, params, JaxLFQ.f_to_idxBl_or_fhat, jnp.asarray(f), True)
    got_idx = pq.f_to_idxBl_or_fhat(torch.from_numpy(f), False)
    got_fhat = pq.f_to_idxBl_or_fhat(torch.from_numpy(f), True)
    for g, w in zip(got_idx, want_idx):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert np.unique(np.concatenate([np.asarray(w).ravel() for w in want_idx])).size > 4
    for g, w in zip(got_fhat, want_fhat):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=Q_TOL)
    idx = [np.asarray(i) for i in want_idx]
    for prog_si in (-1, 2):
        want = _japply(jq, params, JaxLFQ.idxBl_to_var_input,
                       [jnp.asarray(i) for i in idx], prog_si)
        got = pq.idxBl_to_var_input([torch.from_numpy(i.astype(np.int64)) for i in idx],
                                    prog_si)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=Q_TOL)
    rng = np.random.default_rng(2)
    f_hat = rng.normal(size=(3, PNS[-1], PNS[-1], C)).astype(np.float32)
    for si, pn in enumerate(PNS):
        h = rng.normal(size=(3, pn, pn, C)).astype(np.float32)
        want = _japply(jq, params, JaxLFQ.get_next_autoregressive_input, si, len(PNS),
                       jnp.asarray(f_hat), jnp.asarray(h))
        got = pq.get_next_autoregressive_input(si, len(PNS), torch.from_numpy(f_hat),
                                               torch.from_numpy(h))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=Q_TOL)
        want = jq.apply({"params": params}, jnp.asarray(idx[si]), si, method=JaxLFQ.embed)
        np.testing.assert_array_equal(_np(pq.embed(torch.from_numpy(idx[si]), si)),
                                      np.asarray(want))


@pytest.mark.parametrize("znorm,soft", [(True, True), (False, False)],
                         ids=["bsq-soft", "lfq-hard"])
def test_lfq_training_forward_matches_jax(znorm, soft):
    """codebook_drop 0.5: the first of 3 samples adopts the injected
    dropout draw (2 of 3 scales), which the soft entropy loss weights out."""
    jq, params, pq = _pair(znorm, soft, drop=0.5)
    f = np.random.default_rng(5).normal(size=(3, PNS[-1], PNS[-1], C)).astype(np.float32)
    dropout_n = np.array([2, 1, 3])
    w = np.random.default_rng(4).normal(size=f.shape).astype(np.float32)

    def scalar(out, w):
        return (out.f_hat * w).sum() + out.vq_loss + 2.0 * out.commit_loss + 3.0 * out.entropy_loss

    def jax_loss(p, x):
        out = jq.apply({"params": p}, x, dropout_n=jnp.asarray(dropout_n), train=True)
        return scalar(out, jnp.asarray(w)), out

    (_, want), (gp, gf) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(f))
    tf = torch.from_numpy(f).requires_grad_()
    got = pq(tf, dropout_n=torch.from_numpy(dropout_n), train=True)
    scalar(got, torch.from_numpy(w)).backward()
    np.testing.assert_allclose(_np(got.f_hat), np.asarray(want.f_hat), rtol=0, atol=Q_TOL)
    for k in ("vq_loss", "commit_loss", "entropy_loss"):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)), rtol=0,
                                   atol=Q_TOL, err_msg=k)
    assert abs(float(want.entropy_loss)) > 1e-3
    np.testing.assert_array_equal(_np(got.hits_SV), np.asarray(want.hits_SV))
    np.testing.assert_allclose(_np(tf.grad), np.asarray(gf), rtol=0,
                               atol=Q_TOL * max(1.0, np.abs(np.asarray(gf)).max()))
    want_g = to_torch(phi_bank_state_dict_from_flax(_tree_np(gp), len(PNS), 4, C))
    for name, p in pq.named_parameters():
        wg = want_g[name].numpy()
        if p.grad is None:  # a Phi that no scale applies
            assert not wg.any(), name
            continue
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=Q_TOL * max(1.0, np.abs(wg).max()), err_msg=name)


# ------------------------------ tiny MSBR ------------------------------ #

MSBR_YAML = "configs/MSBR10P2-4096.yaml"
# the teachers' guide losses are the flagship step's (test_torch_tokenizer_train.py)
MSBR_TINY = dict(encoder_model=TINY, decoder_model=TINY, image_size=64, num_latent_tokens=9,
                 v_patch_nums=[1, 1, 2, 3], codebook_embed_dim=C, codebook_size=2 ** C,
                 semantic_guide="none", detail_guide="none", dtype_str="float32")
B = 2


@pytest.fixture(scope="module")
def msbr():
    """The YAML's model through both loaders at the tiny preset, params
    drawn from a numpy seed (``_torch_parity``) carried into the port; VAR-d2
    on its codes."""
    jm, pm = jax_load(MSBR_YAML, MSBR_TINY)[0], pt_load(MSBR_YAML, MSBR_TINY)[0]
    assert jm.lfq and pm.lfq and pm.codebook_l2_norm and pm.product_quant == 2
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    jvae, jvar = jax_build_vae_var(jm, depth=2, num_classes=10)
    params = random_params(jvae, jnp.asarray(img), train=False)
    cfg = jvar.config
    x_in = rng.normal(size=(B, cfg.L - cfg.first_l, cfg.Cvae)).astype(np.float32)
    var_params = random_params(jvar, jnp.asarray([0, 1]), jnp.asarray(x_in), seed=1)
    pvae, pvar = build_vae_var(pm, depth=2, num_classes=10, device="cpu")
    pvae.load_state_dict(vqmodel_state_dict_from_flax(params, pm), strict=True)
    pvar.load_state_dict(var_state_dict_from_flax(var_params, pvar.config), strict=True)
    return (jm, jvae, params, jvar, var_params), (pm, pvae.eval(), pvar.eval()), img


def test_msbr_state_dict_matches_export_vqmodel(msbr):
    """Every key export_vqmodel writes for the LFQ tokenizer (no codebook,
    no usage buffer), with its shape and value; the only extra keys are the
    Phi that no scale picks, zero-filled."""
    (jm, _, params, _, _), (_, pvae, _), _ = msbr
    want = export_vqmodel(params, jm)
    got = pvae.state_dict()
    assert not set(want) - set(got)
    assert not any("embedding" in k or "ema_vocab" in k for k in got)
    for k in set(got) - set(want):
        assert "quant_resi" in k and not got[k].any(), k
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


_mapply = _japply


def test_msbr_codes_and_round_trip(msbr):
    (_, jvae, params, _, _), (_, pvae, _), img = msbr
    want = _mapply(jvae, params, JaxVQModel.img_to_idxBl, jnp.asarray(img))
    with torch.no_grad():
        got = pvae.img_to_idxBl(torch.from_numpy(img))
        rec = pvae.img_to_reconstructed_img(torch.from_numpy(img))
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = _mapply(jvae, params, JaxVQModel.img_to_reconstructed_img, jnp.asarray(img))
    np.testing.assert_allclose(_np(rec), np.asarray(want), rtol=0, atol=M_TOL)
    with pytest.raises(NotImplementedError, match="LFQ/BSQ has none"):
        pvae.soft_embed_branch(0, torch.zeros(1, 1, 2 ** C))


def test_msbr_training_forward_matches_jax(msbr, monkeypatch):
    """The training forward with the dropout draw injected into both sides
    (codebook_drop 0.1 of 2 samples drops none, so the YAML's 0.5 is set):
    the decoder output, every loss (the entropy loss included), the hits,
    and every parameter's gradient of one scalar of them."""
    (jm, _, params, _, _), (pm, _, _), img = msbr
    jm, pm = (dataclasses.replace(m, codebook_drop=0.5) for m in (jm, pm))
    jmod = JaxVQModel(jm)
    dropout_n = np.array([3, 4], np.int32)
    real_randint = jax.random.randint

    def randint(key, shape, *a, **k):
        return jnp.asarray(dropout_n) if tuple(shape) == (B,) else real_randint(key, shape,
                                                                                *a, **k)

    monkeypatch.setattr(jax.random, "randint", randint)
    w = np.random.default_rng(3).normal(size=img.shape).astype(np.float32)

    def scalar(out, w):
        return ((out.dec * w).sum() + out.vq_loss + out.commit_loss + 5.0 * out.entropy_loss
                + out.sem_loss + out.dependency_loss)

    def jax_loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(img), train=True, epoch=70,
                         rng=jax.random.PRNGKey(1))
        return scalar(out, jnp.asarray(w)), out

    (_, want), gp = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    monkeypatch.undo()
    model = VQModel(pm, device="cpu")
    model.load_state_dict(vqmodel_state_dict_from_flax(params, pm), strict=True)
    got = model(torch.from_numpy(img), train=True, epoch=70,
                dropout_n=torch.from_numpy(dropout_n))
    scalar(got, torch.from_numpy(w)).backward()
    for k in ("dec", "vq_loss", "commit_loss", "entropy_loss", "sem_loss", "dependency_loss"):
        wv = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(got, k)), wv, rtol=0,
                                   atol=M_TOL * max(np.abs(wv).max(), 1.0), err_msg=k)
    assert abs(got.entropy_loss.item()) > 1e-3
    np.testing.assert_array_equal(_np(got.hits_PSV), np.asarray(want.hits_PSV))
    want_g = vqmodel_state_dict_from_flax(_tree_np(gp), pm)
    for name, p in model.named_parameters():
        if name.startswith("semantic_model."):
            assert p.grad is None, name
            continue
        wg = want_g[name].numpy()
        if p.grad is None:  # a never-applied Phi
            assert not wg.any(), name
            continue
        np.testing.assert_allclose(_np(p.grad), wg, rtol=0,
                                   atol=M_TOL * max(np.abs(wg).max(), 1e-12), err_msg=name)


def test_msbr_var_sample_greedy_matches_jax(msbr, monkeypatch):
    """Greedy CFG sampling of VAR-d2 on the MSBR tokenizer: the codes each
    sampler embeds, stage by stage and branch by branch (LFQ's codes are
    embedded at their scale), and the images."""
    (_, jvae, params, jvar, var_params), (_, pvae, pvar), _ = msbr
    seen = {"jax": [], "port": []}
    orig_j, orig_p = JaxVQModel.embed_branch, pvae.embed_branch

    def jax_wrap(self, i, idx, si=None):  # traced under jit: record through a callback
        jax.debug.callback(lambda x: seen["jax"].append((np.asarray(x), si)), idx,
                           ordered=True)
        return orig_j(self, i, idx, si)

    def port_wrap(i, idx, si=None):
        seen["port"].append((idx.numpy(), si))
        return orig_p(i, idx, si)

    monkeypatch.setattr(JaxVQModel, "embed_branch", jax_wrap)
    monkeypatch.setattr(pvae, "embed_branch", port_wrap)
    label = np.array([3, 7])
    kw = dict(cfg_scale=1.5, top_k=1, top_p=0.0)
    want = jax.jit(lambda vp, pp, lab, key: jax_var_sample(jvar, vp, jvae, pp, lab, key, **kw))(
        var_params, params, jnp.asarray(label), jax.random.PRNGKey(0))
    jax.effects_barrier()
    got = var_sample(pvar, pvae, torch.from_numpy(label), torch.Generator().manual_seed(0),
                     **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 4 * 2
    for (g, gsi), (w, wsi) in zip(seen["port"], seen["jax"]):
        assert gsi == wsi
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=M_TOL)
