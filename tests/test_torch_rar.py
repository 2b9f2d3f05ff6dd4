"""Port parity, RAR: ``imagefolder_tpu_torch/models/rar.py`` against the JAX
package's ``imagefolder_tpu/models/rar.py`` on the CPU, with params carried
by ``rar_state_dict_from_flax``.

A tiny RAR (depth 2, width 64, 4 heads, 16 image tokens, a codebook of 32,
10 classes), fp32. The AdaLN-zero layers start at zero, which would leave
every block out of the output: their params are drawn at random instead.
Sampling is held token for token: the JAX sampler's Gumbel draws are
replayed from its own key splits (``rar.py:361-364``, ``:395-397``;
``jax.random.categorical`` is argmax(logits + gumbel(key, logits.shape)))
and handed to the port as ``noise=``.

A second tiny RAR has heads of 48 (width 96, 2 heads, depth 1), RAR-B's head dim
(768 / 16), which the card's attention kernels #3 and #6 take since they
were built for it: its training forward and every parameter's gradient of
``ar_loss`` are held against the JAX model and ``jax.grad``.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import build_rar as jax_build_rar
from imagefolder_tpu.models.rar import RAR as JaxRAR
from imagefolder_tpu.models.rar import RARConfig as JaxRARConfig
from imagefolder_tpu.models.rar import ar_loss as jax_ar_loss
from imagefolder_tpu.models.rar import rar_generate as jax_rar_generate
from imagefolder_tpu.utils.convert_torch import export_rar
from imagefolder_tpu_torch.models import build_rar
from imagefolder_tpu_torch.models.rar import RARConfig, ar_loss, rar_generate
from imagefolder_tpu_torch.utils.convert import rar_state_dict_from_flax
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = dict(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=4, num_classes=10)
TINY48 = dict(TINY, hidden=96, heads=2, depth=1)  # RAR-B's head dim, 48
B, L, V = 2, 16, 32
SAMPLING = dict(guidance_scale=4.0, randomize_temperature=1.0, guidance_scale_pow=2.75)


def _excite_adaln(tree, rng):
    """Random params for the zero-initialised AdaLN layers (``adaLN``,
    ``final_ada``), so that the gates, shifts and scales move the output."""
    if isinstance(tree, dict):
        return {k: (jax.tree_util.tree_map(
                    lambda v: rng.normal(0, 0.5, np.shape(v)).astype(np.float32), dict(v))
                    if k in ("adaLN", "final_ada") else _excite_adaln(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


def _build(tiny):
    jr = jax_build_rar(**tiny)
    ids = jnp.zeros((B, L), jnp.int32)
    params = jax.jit(jr.init)(jax.random.PRNGKey(0), ids, jnp.zeros((B,), jnp.int32))["params"]
    params = _excite_adaln(jax.tree_util.tree_map(np.asarray, params),
                           np.random.default_rng(0))
    pr = build_rar(**tiny, device="cpu")
    pr.load_state_dict(rar_state_dict_from_flax(params), strict=True)
    return jr, params, pr.eval()


@pytest.fixture(scope="module")
def models():
    return _build(TINY)


def test_converter_matches_export_rar(models):
    _, params, _ = models
    want = export_rar(params)
    got = rar_state_dict_from_flax(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def test_build_rar_config_matches_jax(models):
    """The tiny config, and build_rar's and RARConfig's defaults (RAR-B:
    768 wide, 24 deep, 16 heads), as the JAX package's."""
    jr, _, pr = models
    assert dataclasses.asdict(pr.config) == dataclasses.asdict(jr.config)
    defaults = lambda fn: {k: p.default for k, p in inspect.signature(fn).parameters.items()
                           if k not in ("generator", "device")}  # noqa: E731
    assert defaults(build_rar) == defaults(jax_build_rar)
    assert dataclasses.asdict(RARConfig()) == dataclasses.asdict(JaxRARConfig())
    assert (RARConfig().embed_dim, RARConfig().depth, RARConfig().num_heads) == (768, 24, 16)


def test_forward_matches_jax(models):
    """The training forward with per-sample orders (one raster, one random
    permutation): logits, shuffled labels, and the AR loss."""
    jr, params, pr = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, V, (B, L))
    cond = rng.integers(0, 10, B) + V + 1
    orders = np.stack([np.arange(L), rng.permutation(L)])
    want, want_labels = jax.jit(jr.apply)({"params": params}, jnp.asarray(ids),
                                          jnp.asarray(cond), jnp.asarray(orders))
    with torch.no_grad():
        got, labels = pr(torch.from_numpy(ids), torch.from_numpy(cond),
                         torch.from_numpy(orders))
    assert got.shape == (B, 1 + L, V) and got.dtype == torch.float32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    # fp32 on both sides over two blocks: summation order only; |logits| <~ 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    want_loss, want_acc = jax_ar_loss(want, want_labels)
    loss, acc = ar_loss(got, labels)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    assert acc.item() == float(want_acc)


def test_decode_steps_match_jax(models):
    """The prefill and every decode step, position by position, with the JAX
    package's full-length caches and the port's growing ones: each step's
    logits (both CFG halves)."""
    jr, params, pr = models
    cfg = jr.config
    rng = np.random.default_rng(2)
    cond = np.concatenate([rng.integers(0, 10, B) + V + 1,
                           np.full(B, cfg.none_condition_id)])
    toks = rng.integers(0, V, (L, 2 * B))
    hd = cfg.embed_dim // cfg.num_heads
    caches = [(jnp.zeros((2 * B, L + 2, cfg.num_heads, hd)),) * 2 for _ in range(cfg.depth)]
    jcond = jnp.asarray(cond)

    @jax.jit
    def prefill(caches):
        x0, ct0 = jr.apply({"params": params}, jcond, method=JaxRAR.embed_prefill)
        return jr.apply({"params": params}, x0, ct0, caches, 0, method=JaxRAR.decode_step)

    @jax.jit
    def step(caches, tok, i):  # i traced: one compile for every position
        x = jr.apply({"params": params}, tok, i, method=JaxRAR.embed_decode_token)
        ct = jr.apply({"params": params}, jcond, i, method=JaxRAR.decode_cond_token)
        return jr.apply({"params": params}, x, ct, caches, i + 2, method=JaxRAR.decode_step)

    lg, caches = prefill(caches)
    want = [np.asarray(lg[:, -1])]
    for i in range(L - 1):
        lg, caches = step(caches, jnp.asarray(toks[i]), i)
        want.append(np.asarray(lg[:, -1]))
    tcond = torch.from_numpy(cond)
    with torch.no_grad():
        pcaches = pr.init_caches(2 * B, chunk=4)
        got = [pr.decode_step(*pr.embed_prefill(tcond), pcaches)[:, -1]]
        for i in range(L - 1):
            x = pr.embed_decode_token(torch.from_numpy(toks[i]), i)
            got.append(pr.decode_step(x, pr.decode_cond_token(tcond, i), pcaches)[:, -1])
    assert pcaches[0].filled == L + 1
    # fp32, summation order only (the JAX cache attends to -inf-masked
    # unwritten positions, the port to the written prefix)
    np.testing.assert_allclose(torch.stack(got).numpy(), np.stack(want), rtol=0, atol=2e-5)


def _jax_gumbel(key, steps: int, shape) -> np.ndarray:
    """The Gumbel draws of ``rar_generate``'s steps: one key split per step,
    ``jax.random.categorical``'s gumbel(ks, logits.shape) for each."""
    out = []
    for _ in range(steps):
        key, ks = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(ks, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("guidance", [SAMPLING["guidance_scale"], 0.0])
def test_rar_generate_tokens_match_jax(models, guidance):
    """Sampled tokens equal the JAX sampler's (jitted) with the same draws,
    with CFG and without, and the port's chunked cache equals its full one."""
    jr, params, pr = models
    kw = dict(SAMPLING, guidance_scale=guidance)
    labels = np.array([3, 7])
    key = jax.random.PRNGKey(11)
    gen = jax.jit(lambda p, c, k: jax_rar_generate(jr, p, c, k, **kw))
    want = np.asarray(gen(params, jnp.asarray(labels), key))
    noise = torch.from_numpy(_jax_gumbel(key, L, (B, V)))
    got = {chunk: rar_generate(pr, torch.from_numpy(labels), noise=noise, decode_chunk=chunk,
                               **kw) for chunk in (None, 4)}
    assert got[None].shape == (B, L)
    np.testing.assert_array_equal(got[None].numpy(), want)
    assert torch.equal(got[4], got[None])
    again = rar_generate(pr, torch.from_numpy(labels), torch.Generator().manual_seed(0), **kw)
    assert again.shape == (B, L) and 0 <= int(again.min()) and int(again.max()) < V



def test_training_forward_and_gradients_at_head_dim_48():
    """RAR at head dim 48: the training forward's logits with per-sample
    orders, the AR loss, and every parameter's gradient of it against the
    JAX model's and ``jax.grad`` of the JAX ``ar_loss`` (the flax gradients
    carried to the port's layout by the same converter as the params)."""
    jr, params, pr = _build(TINY48)
    assert pr.config.embed_dim // pr.config.num_heads == 48
    rng = np.random.default_rng(5)
    ids = rng.integers(0, V, (B, L))
    cond = rng.integers(0, 10, B) + V + 1
    orders = np.stack([rng.permutation(L), np.arange(L)])

    def jax_loss(p):
        logits, labels = jr.apply({"params": p}, jnp.asarray(ids), jnp.asarray(cond),
                                  jnp.asarray(orders))
        return jax_ar_loss(logits, labels)[0], logits

    (want_loss, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    want_grads = rar_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    pr.zero_grad(set_to_none=True)
    got, labels = pr(torch.from_numpy(ids), torch.from_numpy(cond), torch.from_numpy(orders))
    loss, _ = ar_loss(got, labels)
    loss.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    named = dict(pr.named_parameters())
    assert sorted(named) == sorted(want_grads)
    top = max(float(t.abs().max()) for t in want_grads.values())
    for name, param in named.items():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if param.grad is None else param.grad.numpy()
        # fp32 on both sides, summation order only: within 1e-4 of the
        # tensor's largest gradient, plus 1e-6 of the model's largest for
        # the gradients that are 0 in exact arithmetic and rounding noise on
        # both sides (k_norm's bias adds q.b to every score of a row, which
        # the softmax cancels)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-6 * top,
                                   err_msg=name)
