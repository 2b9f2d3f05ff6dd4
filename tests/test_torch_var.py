"""Port parity, VAR: ``imagefolder_tpu_torch/models/var.py``,
``ops/sampling.py`` and ``train/var_train.py::var_sample`` against the JAX
package on the CPU, on the same numpy-seeded inputs.

VAR at depth 2 (width 128, 2 heads of 64) over ``patch_nums`` (1, 2, 3), with
params carried by ``var_state_dict_from_flax``; for sampling, the tiny
DINOv2 tokenizer (width 64, depth 2; 64 px, a 3x3 latent grid) of
``build_vae_var``. Tolerances: fp32 logits within 1e-4 (two blocks of width
128, summation order only; JAX runs its attention through XLA here, the port
its plain version); sampled tokens equal; images within 1e-4. Sampling noise
differs between the frameworks, so the samplers run greedy (``top_k=1``) and
``gumbel_softmax`` takes its noise as an argument.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import build_vae_var as jax_build_vae_var
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.models.var import VAR as JaxVAR
from imagefolder_tpu.models.var import VARConfig as JaxVARConfig
from imagefolder_tpu.ops import sampling as jax_sampling
from imagefolder_tpu.train.var_train import var_sample as jax_var_sample
from imagefolder_tpu.utils.convert_torch import export_var
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.var import VAR as PtVAR
from imagefolder_tpu_torch.models.var import VARConfig as PtVARConfig
from imagefolder_tpu_torch.ops import sampling as pt_sampling
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.train.var_train import var_sample
from imagefolder_tpu_torch.utils.convert import (
    var_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
PNS = (1, 2, 3)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _vcfg(cls, **kw):
    base = dict(vocab_size=32, Cvae=8, num_classes=10, depth=2, embed_dim=128,
                num_heads=2, patch_nums=PNS, cond_drop_rate=0.0)
    return cls(**{**base, **kw})


def _build_var(**kw):
    jcfg = _vcfg(JaxVARConfig, **kw)
    jv = JaxVAR(jcfg)
    rng = np.random.default_rng(0)
    label = rng.integers(0, 10, (3,))
    x_in = rng.normal(size=(3, jcfg.L - jcfg.first_l, 8)).astype(np.float32)
    params = jv.init(jax.random.PRNGKey(1), jnp.asarray(label), jnp.asarray(x_in))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = _vcfg(PtVARConfig, **kw)
    pv = PtVAR(pcfg, device="cpu")
    pv.load_state_dict(var_state_dict_from_flax(params, pcfg), strict=True)
    return jv, params, pv.eval(), label, x_in


VAR_CASES = [dict(attn_l2_norm=False, shared_aln=False), dict(attn_l2_norm=True),
             dict(shared_aln=True), dict(attn_l2_norm=True, shared_aln=True)]


@pytest.fixture(scope="module", params=VAR_CASES,
                ids=lambda kw: f"l2{int(kw.get('attn_l2_norm', False))}"
                               f"-shared{int(kw.get('shared_aln', False))}")
def var_models(request):
    return _build_var(**request.param)


def test_state_dict_matches_export_var(var_models):
    _, params, pv, _, _ = var_models
    want = export_var(params)
    got = pv.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def test_teacher_forcing_logits(var_models):
    jv, params, pv, label, x_in = var_models
    want = np.asarray(jv.apply({"params": params}, jnp.asarray(label), jnp.asarray(x_in)))
    with torch.no_grad():
        got = pv(torch.from_numpy(label), torch.from_numpy(x_in))
    assert got.shape == (3, 14, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_progressive_forward(var_models):
    """prog_si truncates the sequence at the end of scale prog_si."""
    jv, params, pv, label, x_in = var_models
    for prog_si in (0, 1):
        ed = (1, 5)[prog_si]
        xj = None if prog_si == 0 else jnp.asarray(x_in[:, :ed - 1])
        want = np.asarray(jv.apply({"params": params}, jnp.asarray(label), xj,
                                   prog_si=prog_si))
        with torch.no_grad():
            got = pv(torch.from_numpy(label),
                     None if prog_si == 0 else torch.from_numpy(x_in[:, :ed - 1]),
                     prog_si=prog_si)
        assert got.shape == (3, ed, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _staged_inputs(pv, label, x_in):
    """The teacher-forcing input embeddings, which the forward builds, cut
    into the stages that the cached decode feeds."""
    cond = pv.class_emb(label)
    sos = cond[:, None] + pv.pos_start
    x_all = torch.cat([sos, pv.word_embed(x_in)], dim=1) + pv._lvl_pos()
    return cond, [x_all[:, a:b] for a, b in pv.config.begin_ends]


def test_cached_decode_equals_teacher_forcing(var_models):
    """The KV cache filled in place, stage by stage with no bias, gives the
    block-causal forward's logits; a full cache refuses more positions."""
    _, _, pv, label, x_in = var_models
    label, x_in = torch.from_numpy(label), torch.from_numpy(x_in)
    with torch.no_grad():
        full = pv(label, x_in)
        cond, segs = _staged_inputs(pv, label, x_in)
        caches = pv.init_caches(3)
        staged = torch.cat([pv.decode_stage(seg, cond, caches) for seg in segs], dim=1)
    assert all(c.filled == 14 for c in caches)
    np.testing.assert_allclose(staged.numpy(), full.numpy(), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        caches[0].append(*(torch.zeros(3, 1, 2, 64),) * 2)


def test_cached_decode_matches_jax(var_models):
    jv, params, pv, label, x_in = var_models
    with torch.no_grad():
        cond, segs = _staged_inputs(pv, torch.from_numpy(label), torch.from_numpy(x_in))
        caches = pv.init_caches(3)
        got = [pv.decode_stage(seg, cond, caches) for seg in segs]
    jcaches = [(None, None)] * 2
    for seg, g in zip(segs, got):
        want, jcaches = jv.apply({"params": params}, jnp.asarray(seg.numpy()),
                                 jnp.asarray(cond.detach().numpy()), jcaches,
                                 method=JaxVAR.decode_stage)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_begin_and_next_stage_inputs(var_models):
    jv, params, pv, label, _ = var_models
    want_ntm, want_cond = jv.apply({"params": params}, jnp.asarray(label),
                                   method=JaxVAR.begin_tokens)
    nxt = np.random.default_rng(4).normal(size=(3, 2, 2, 8)).astype(np.float32)
    want_x = jv.apply({"params": params}, jnp.asarray(nxt), 1, 2,
                      method=JaxVAR.next_stage_input)
    with torch.no_grad():
        ntm, cond = pv.begin_tokens(torch.from_numpy(label))
        x = pv.next_stage_input(torch.from_numpy(nxt), 1, 2)
    for g, w in ((ntm, want_ntm), (cond, want_cond), (x, want_x)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# ------------------------------- sampling ------------------------------- #

@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.8), (7, 0.6), (900, 0.96),
                                         (64, 0.0), (1, 0.0)])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    """The same kept set as JAX's sort-free filter (top_k clamped to V = 64,
    the argmax always kept) on random logits with some exact ties."""
    rng = np.random.default_rng(top_k)
    logits = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    logits[0, 0, :8] = logits[0, 0, 8]  # a run of tied values
    want = np.asarray(jax_sampling.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p))
    got = pt_sampling.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    probs = pt_sampling.sample_with_top_k_top_p(torch.from_numpy(logits), None, top_k,
                                                top_p, return_p=True)
    want_p = jax_sampling.sample_with_top_k_top_p(jnp.asarray(logits), None, top_k, top_p,
                                                  return_p=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), rtol=0, atol=1e-6)


def test_sampling_draws_from_the_kept_set():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 50, 64)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(0)
    idx = pt_sampling.sample_with_top_k_top_p(logits, gen, top_k=3)
    assert idx.shape == (4, 50) and idx.dtype == torch.int64
    top3 = logits.topk(3, dim=-1).indices
    assert bool((top3 == idx[..., None]).any(-1).all())


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_with_injected_noise(hard):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 4, 16)).astype(np.float32)
    g = rng.gumbel(size=logits.shape).astype(np.float32)
    want = jax_sampling.gumbel_softmax(jnp.asarray(logits), None, tau=0.5, hard=hard,
                                       g=jnp.asarray(g))
    got = pt_sampling.gumbel_softmax(torch.from_numpy(logits), tau=0.5, hard=hard,
                                     g=torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _margs(cls, p):
    return cls(codebook_size=16, codebook_embed_dim=8, v_patch_nums=PNS, product_quant=p,
               enc_type="dinov2", dec_type="dinov2", encoder_model=TINY,
               decoder_model=TINY, semantic_guide="none", detail_guide="none",
               num_latent_tokens=9, abs_pos_embed=True, image_size=64)


def _excite_layerscale(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(np.float32)
                    if k in ("ls1", "ls2") else _excite_layerscale(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


_SAMPLERS = {}


def _sampler_models(p):
    """(JAX vae, its params, JAX VAR, its params), (port vae, port VAR) for
    P branches, built once per module."""
    if p in _SAMPLERS:
        return _SAMPLERS[p]
    rng = np.random.default_rng(p)
    jvae, jvar = jax_build_vae_var(_margs(JaxArgs, p), depth=2, num_classes=10)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    vae_params = jvae.init(jax.random.PRNGKey(0), jnp.asarray(img), train=False)["params"]
    vae_params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, vae_params), rng)
    cfg = jvar.config
    x_in = rng.normal(size=(2, cfg.L - cfg.first_l, cfg.Cvae)).astype(np.float32)
    var_params = jax.tree_util.tree_map(np.asarray, jvar.init(
        jax.random.PRNGKey(1), jnp.asarray([0, 1]), jnp.asarray(x_in))["params"])
    margs = _margs(PtArgs, p)
    pvae, pvar = build_vae_var(margs, depth=2, num_classes=10, device="cpu")
    pvae.load_state_dict(vqmodel_state_dict_from_flax(vae_params, margs), strict=True)
    pvar.load_state_dict(var_state_dict_from_flax(var_params, pvar.config), strict=True)
    _SAMPLERS[p] = (jvae, vae_params, jvar, var_params), (pvae.eval(), pvar.eval())
    return _SAMPLERS[p]


def _record_codes(monkeypatch, pvae):
    """Wrap both packages' embed_branch to record the codes each sampler
    picks, per stage and branch."""
    seen = {"jax": [], "port": []}
    orig_j, orig_p = JaxVQModel.embed_branch, pvae.embed_branch

    def jax_wrap(self, i, idx, si=None):
        seen["jax"].append(np.asarray(idx))
        return orig_j(self, i, idx, si)

    def port_wrap(i, idx, si=None):
        seen["port"].append(idx.numpy())
        return orig_p(i, idx, si)

    monkeypatch.setattr(JaxVQModel, "embed_branch", jax_wrap)
    monkeypatch.setattr(pvae, "embed_branch", port_wrap)
    return seen


@pytest.mark.parametrize("p,joint", [(1, False), (2, False), (2, True)])
def test_var_sample_greedy_matches_jax(monkeypatch, p, joint):
    (jvae, vae_params, jvar, var_params), (pvae, pvar) = _sampler_models(p)
    seen = _record_codes(monkeypatch, pvae)
    label = np.array([3, 7])
    kw = dict(cfg_scale=1.5, top_k=1, top_p=0.0, joint_sample=joint)
    want = jax_var_sample(jvar, var_params, jvae, vae_params, jnp.asarray(label),
                          jax.random.PRNGKey(0), **kw)
    got = var_sample(pvar, pvae, torch.from_numpy(label), torch.Generator().manual_seed(0),
                     **kw)
    assert len(seen["port"]) == len(seen["jax"]) == len(PNS) * p
    for g, w in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(g, w)
    assert np.unique(np.concatenate([w.ravel() for w in seen["jax"]])).size > 1
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_var_sample_more_smooth_runs():
    """more_smooth draws its gumbel noise from the torch generator, so only
    its form is checked: images in [0, 1], and the same generator seed gives
    the same images."""
    _, (pvae, pvar) = _sampler_models(2)
    label = torch.tensor([1, 2])
    before = pt_attn.FUSED_LAUNCHES
    a, b = (var_sample(pvar, pvae, label, torch.Generator().manual_seed(5),
                       more_smooth=True, top_k=4) for _ in range(2))
    assert pt_attn.FUSED_LAUNCHES == before  # the CPU never launches a kernel
    assert a.shape == (2, 64, 64, 3) and bool(torch.isfinite(a).all())
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    """Without device="cpu" VAR and build_vae_var move to CUDA, which this
    build of torch refuses when it has no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        PtVAR(_vcfg(PtVARConfig))
    with pytest.raises((AssertionError, RuntimeError)):
        build_vae_var(_margs(PtArgs, 1), depth=2, num_classes=10)
