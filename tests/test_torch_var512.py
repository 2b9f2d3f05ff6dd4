"""Port parity, the 512 px slice: MSVR10P2-4096-512 (image 512, the 512 px
pyramid (1, 2, 3, 4, 6, 9, 13, 18, 24, 32), 1024 latents per PQ branch, two
branches) under VAR (L = 2240) against the JAX package on the CPU, on the
same numpy-seeded inputs.

The recipe is the JAX package's own (``scripts/soak.py:76-81``), at a tiny
width: the tokenizer's ViT has 2 blocks of width 64 with 2 heads and a 16 x 8
codebook per branch; VAR has depth 2 (width 128, 2 heads of 64). Params are
carried by the numpy converters. At these lengths every attention call is
past the single-block budget: the encoder's N = 1 + 1024 + 2 * 1024 = 3073,
the decoder's 1 + 1024 + 1 + 1024 = 2050 and VAR's L = 2240, so the port
computes the q-blocked kernel's function (o / l after p v) where the JAX
package, on the CPU, computes XLA's. Tolerances, as in ``test_torch_msvq.py``,
``test_torch_var.py`` and ``test_torch_var_train.py``: codes and greedy
tokens equal; fp32 values within 1e-4 (two blocks on each side, summation
order only); the loss within 1e-5 relative; parameters after one AdamW step
within 1% of the step's lr wherever the gradient is above 1e-3 of its
tensor's max.
"""

import dataclasses

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
from imagefolder_tpu.ops.quantize import phi_index as jax_phi_index
from imagefolder_tpu.ops.resize import resize_matrix as jax_resize_matrix
from imagefolder_tpu.train import var_train as jax_var_train
from imagefolder_tpu.utils.convert_torch import export_var, export_vqmodel
from imagefolder_tpu_torch.models import build_vae_var
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
from imagefolder_tpu_torch.models.var import VAR as PtVAR
from imagefolder_tpu_torch.models.var import VARConfig as PtVARConfig
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.ops.quantize import phi_index
from imagefolder_tpu_torch.ops.resize import resize_matrix
from imagefolder_tpu_torch.train.var_train import (
    ProgressiveController,
    VARTrainConfig,
    VARTrainer,
    var_sample,
)
from imagefolder_tpu_torch.utils.convert import (
    var_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
PNS = (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)  # the 512 px pyramid, L = 2240
IMG = 512
TOL = 1e-4


def msvr512_margs(cls, encoder_model=TINY):
    """MSVR10P2-4096-512 (``configs/MSVR10P2-4096.yaml`` at 512 px with the
    512 px pyramid and a 32 x 32 latent grid per branch), at the tiny width."""
    return cls(codebook_size=16, codebook_embed_dim=8, v_patch_nums=PNS, product_quant=2,
               enc_type="dinov2", dec_type="dinov2", encoder_model=encoder_model,
               decoder_model=encoder_model, semantic_guide="none", detail_guide="none",
               num_latent_tokens=PNS[-1] ** 2, abs_pos_embed=True, image_size=IMG)


def _excite_layerscale(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(np.float32)
                    if k in ("ls1", "ls2") else _excite_layerscale(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    """(JAX vae, its params, JAX VAR, its params), (port vae, port VAR), two
    512 px images and their labels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        rng = np.random.default_rng(0)
        jvae, jvar = jax_build_vae_var(msvr512_margs(JaxArgs), depth=2, num_classes=10)
        imgs = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
        vae_params = jax.jit(lambda k, x: jvae.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(imgs))["params"]
        vae_params = _excite_layerscale(jax.tree_util.tree_map(np.asarray, vae_params), rng)
        cfg = jvar.config
        x_in = np.zeros((2, cfg.L - cfg.first_l, cfg.Cvae), np.float32)
        var_params = jax.tree_util.tree_map(np.asarray, jax.jit(jvar.init)(
            jax.random.PRNGKey(1), jnp.asarray([0, 1]), jnp.asarray(x_in))["params"])
        margs = msvr512_margs(PtArgs)
        pvae, pvar = build_vae_var(margs, depth=2, num_classes=10, device="cpu")
        pvae.load_state_dict(vqmodel_state_dict_from_flax(vae_params, margs), strict=True)
        pvar.load_state_dict(var_state_dict_from_flax(var_params, pvar.config), strict=True)
        yield ((jvae, vae_params, jvar, var_params), (pvae.eval(), pvar.eval()), imgs,
               np.array([3, 7]))


def _spy_qblk(monkeypatch):
    """Count the calls that reach the q-blocked kernel's plain version."""
    seen = []
    orig = pt_attn.fused_attention_qblk_reference

    def wrap(q, *a, **kw):
        seen.append(q.shape[1])
        return orig(q, *a, **kw)

    monkeypatch.setattr(pt_attn, "fused_attention_qblk_reference", wrap)
    return seen


def test_512_state_dicts_match_the_exports(models):
    """The converters carry the 512 px shapes: the tokenizer's pos embeds
    over 1 + 32 x 32 positions, VAR's ``pos_1LC`` of 2240 rows and its ten
    level embeddings; every key, shape and value that ``export_vqmodel`` and
    ``export_var`` write (no Phi goes unused over ten scales)."""
    (_, vae_params, jvar, var_params), (pvae, pvar), _, _ = models
    assert sorted({phi_index(si / 9, 4) for si in range(10)}) == [0, 1, 2, 3]
    for got, want in ((pvae.state_dict(), export_vqmodel(vae_params, msvr512_margs(JaxArgs))),
                      (pvar.state_dict(), export_var(var_params))):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(np.shape(v)), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    sd = pvar.state_dict()
    assert sd["pos_1LC"].shape == (1, 2240, 128) and sd["lvl_embed.weight"].shape == (10, 128)
    assert pvae.state_dict()["encoder.model.pos_embed"].shape == (1, 1 + 1024, 64)
    assert jvar.config.L == pvar.config.L == 2240


def test_512_phi_bank_resize_and_progressive_schedule_match_jax():
    """The Phi picked at each of the ten scales; the area and bicubic resize
    matrices between the 32-wide grid and every scale; the progressive
    schedule over the ten stages (pg0 = 4, the default made for a 10-scale
    pyramid)."""
    for k in (1, 4, 10):
        assert [phi_index(si / 9, k) for si in range(10)] == \
            [jax_phi_index(si / 9, k) for si in range(10)]
    for pn in PNS:
        np.testing.assert_array_equal(resize_matrix(pn, 32, "area"),
                                      jax_resize_matrix(pn, 32, "area"))
        np.testing.assert_array_equal(resize_matrix(32, pn, "bicubic"),
                                      jax_resize_matrix(32, pn, "bicubic"))
    mk = dict(num_stages=len(PNS), pg=0.6, prog_wp_it=3.0)
    mine, ref = ProgressiveController(**mk), jax_var_train.ProgressiveController(**mk)
    trajectory = []
    for g_it in range(80):
        si = mine.stage(g_it, 5, 100)
        assert si == ref.stage(g_it, 5, 100)
        trajectory.append(mine.step(si))
        assert trajectory[-1] == ref.step(si)
    assert {t[0] for t in trajectory} == {4, 5, 6, 7, 8, -1}


@pytest.fixture(scope="module")
def jax_encoded(models):
    """The JAX encoder's latents and ``img_to_idxBl``'s codes of the two
    images, from one jitted call."""
    (jvae, vae_params, _, _), _, imgs, _ = models
    return jax.jit(lambda p, x: jvae.apply(
        {"params": p}, x, method=lambda m, y: (m.encoder(y), m.img_to_idxBl(y))))(
        vae_params, jnp.asarray(imgs))


@pytest.fixture(scope="module")
def jax_var_forward(models):
    (_, _, jvar, var_params), _, _, _ = models
    fwd = jax.jit(lambda p, label, x: jvar.apply({"params": p}, label, x))
    return lambda label, x: np.asarray(fwd(var_params, jnp.asarray(label), jnp.asarray(x)))


def test_512_encoder_and_codes_match_jax(models, jax_encoded, monkeypatch):
    """The encoder at N = 3073 (the 32 x 32 patch grid, its pos embed, two
    branches of 1024 latents), then ``img_to_idxBl``'s codes, every scale of
    both branches equal; each encoder block takes the q-blocked route."""
    _, (pvae, _), imgs, _ = models
    want_h, want = jax_encoded
    seen = _spy_qblk(monkeypatch)
    with torch.no_grad():
        got = pvae.encoder(torch.from_numpy(imgs))
    assert got.shape == (2, 2048, 64) and seen == [3073, 3073]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_h), rtol=0, atol=TOL)
    with torch.no_grad():
        got = pvae.img_to_idxBl(torch.from_numpy(imgs))
    assert [[tuple(i.shape) for i in b] for b in got] == [[(2, pn * pn) for pn in PNS]] * 2
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.unique(np.concatenate([np.asarray(w).ravel() for b in want for w in b])).size > 1


def test_512_round_trip_matches_jax(models, monkeypatch):
    """img_to_reconstructed_img through the decoder at N = 2050."""
    (jvae, vae_params, _, _), (pvae, _), imgs, _ = models
    want = jax.jit(lambda p, x: jvae.apply({"params": p}, x,
                                           method=JaxVQModel.img_to_reconstructed_img))(
        vae_params, jnp.asarray(imgs))
    seen = _spy_qblk(monkeypatch)
    with torch.no_grad():
        got = pvae.img_to_reconstructed_img(torch.from_numpy(imgs))
    assert seen == [3073] * 2 + [2050] * 2
    assert got.shape == (2, IMG, IMG, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_512_var_forward_logits_match_jax(models, jax_encoded, jax_var_forward, monkeypatch):
    """Teacher forcing at L = 2240 under the block-causal bias, on the JAX
    tokenizer's codes."""
    (jvae, vae_params, _, _), (_, pvar), _, labels = models
    x_in = np.array(jvae.apply({"params": vae_params}, jax_encoded[1],
                               method=JaxVQModel.idxBl_to_var_input))
    want = jax_var_forward(labels, x_in)
    seen = _spy_qblk(monkeypatch)
    with torch.no_grad():
        got = pvar(torch.from_numpy(labels), torch.from_numpy(x_in))
    assert seen == [2240, 2240]
    assert got.shape == (2, 2240, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_512_var_sample_greedy_matches_jax(models, jax_var_forward, monkeypatch):
    """Greedy CFG sampling over the ten stages: every code the port picks is
    the JAX model's greedy pick given the same prefix. The JAX sampler's
    stages are its teacher forcing cut by scale (its KV-cached decode equals
    the block-causal forward), so the JAX VAR's forward on the port's codes,
    for the labels and for the unconditional class, gives each stage's CFG
    logits (1 + t) cond - t uncond with t = 1.5 si / 9, whose per-branch
    argmax must be the port's code at every position of every stage (a
    greedy sampler that agrees on every prefix agrees on the whole
    sequence). The port's decode stays under the budget (its last stage is
    1024 x 2240, on #3); its images come from the decoder at N = 2050."""
    (jvae, vae_params, jvar, _), (pvae, pvar), _, labels = models
    codes = [[], []]
    orig = pvae.embed_branch

    def record(i, idx, si=None):
        codes[i].append(idx.numpy())
        return orig(i, idx, si)

    monkeypatch.setattr(pvae, "embed_branch", record)
    qblk = _spy_qblk(monkeypatch)
    with torch.no_grad():
        img = var_sample(pvar, pvae, torch.from_numpy(labels), torch.Generator().manual_seed(0),
                         cfg_scale=1.5, top_k=1, top_p=0.0)
    assert qblk == [2050, 2050]
    assert img.shape == (2, IMG, IMG, 3) and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0
    assert [[c.shape for c in b] for b in codes] == [[(2, pn * pn) for pn in PNS]] * 2
    x_in = np.array(jvae.apply({"params": vae_params}, [[jnp.asarray(c) for c in b]
                                                         for b in codes],
                               method=JaxVQModel.idxBl_to_var_input))
    nc = jvar.config.num_classes
    both = jax_var_forward(np.concatenate([labels, [nc, nc]]), np.concatenate([x_in, x_in]))
    v = both.shape[-1] // 2
    for si, (a, b) in enumerate(jvar.config.begin_ends):
        t = 1.5 * si / (len(PNS) - 1)
        logits = (1 + t) * both[:2, a:b] - t * both[2:, a:b]
        for i in range(2):
            np.testing.assert_array_equal(codes[i][si], logits[..., i * v:(i + 1) * v].argmax(-1),
                                          err_msg=f"stage {si} branch {i}")
    assert np.unique(np.concatenate([c.ravel() for b in codes for c in b])).size > 1


def test_512_train_step_matches_jax(models, monkeypatch):
    """One VARTrainer step over the 512 px tokenizer's codes: the loss,
    accuracies and gradient norm, and every updated parameter; the
    ProgressiveController runs over the ten stages (pg 0: the whole
    sequence), the CE over 2240 positions of the 32-way head; VAR's
    gradient comes through the q-blocked backward's plain version. Class
    dropout and drop path are off, so that both sides take the same masks."""
    (jvae, vae_params, jvar, var_params), (pvae, _), imgs, labels = models
    jcfg = dataclasses.replace(jvar.config, drop_path_rate=0.0, cond_drop_rate=0.0)
    pcfg = PtVARConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    pvar = PtVAR(pcfg, device="cpu")
    pvar.load_state_dict(var_state_dict_from_flax(var_params, pcfg), strict=True)
    tcfg = VARTrainConfig(lr=1e-3, warmup_steps=2, total_steps=10, label_smooth=0.1)
    jtr = jax_var_train.VARTrainer(jvae, JaxVAR(jcfg), jax_var_train.VARTrainConfig(
        **dataclasses.asdict(tcfg)))
    ptr = VARTrainer(pvae, pvar, tcfg)
    state = jax_var_train.VARTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, var_params),
        opt_state=jtr.tx.init(var_params), vae_params=vae_params, ema_params=None,
        step=jnp.zeros((), jnp.int32))
    state, want = jtr.train_step(state, jnp.asarray(imgs), jnp.asarray(labels),
                                 jax.random.PRNGKey(0))
    bwd = []
    orig = pt_attn.fused_attention_qblk_bwd

    def spy_bwd(q, *a, **kw):
        bwd.append(q.shape[1])
        return orig(q, *a, **kw)

    monkeypatch.setattr(pt_attn, "fused_attention_qblk_bwd", spy_bwd)
    p0 = {k: v.detach().clone() for k, v in pvar.named_parameters()}
    got = ptr.train_step(torch.from_numpy(imgs), torch.from_numpy(labels))
    assert bwd == [2240, 2240]
    for k in ("loss", "acc_mean", "acc_tail", "grad_norm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    tol = 0.01 * 1e-3 * 0.005  # 1% of the first step's lr
    want_p = var_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params), pcfg)
    for name, p in pvar.named_parameters():
        w = want_p[name].numpy()
        if p.grad is None:  # empty_emb, with token dropout off
            np.testing.assert_array_equal(p.detach().numpy(), w, err_msg=name)
            continue
        g = p.grad.abs()
        firm = (g > 1e-3 * g.max()).numpy()
        assert firm.any() and not torch.equal(p.detach(), p0[name]), name
        np.testing.assert_allclose(p.detach().numpy()[firm], w[firm], rtol=0, atol=tol,
                                   err_msg=name)
