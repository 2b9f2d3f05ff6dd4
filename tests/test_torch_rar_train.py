"""Port parity, the RAR trainer: ``imagefolder_tpu_torch/train/rar_train.py``
and the schedules it takes from ``imagefolder_tpu_torch/train/optim.py``
against the JAX package's ``imagefolder_tpu/train/rar_train.py`` and
``imagefolder_tpu/train/optim.py`` (and optax) on the CPU.

The random-ratio annealing over a table of steps; the EMA decay at steps
0-50 with and without warmup and with ``update_after_step``; optax's
warmup-cosine schedule at every step of short runs; ``RAR.sample_orders``
with the uniforms and permutations that JAX draws injected; and two
``RARTrainer`` steps of a tiny RAR (depth 2, width 64, 4 heads; AdaLN
params drawn at random, as ``test_torch_rar.py`` does) against the JAX
``RARTrainer`` from the same params, with the condition drops and orders
that JAX drew from ``jax.random.split(rng)`` replayed: loss,
``correct_tokens``, ``grad_norm``, the clipped gradients (against
``jax.grad`` of the same loss times the clip factor), parameters, Adam
moments (the first, and the square root of the second, which is in the
gradient's units: the second itself doubles a gradient's relative error)
and EMA within
1e-5 of their max abs (parameters and EMA with a floor of 1e-2 of the lr
summed over the steps: fp32 Adam's normalised step loses relative
precision where a gradient changes sign), with the EMA updated every step
and every other step. ``k_norm``'s bias has a gradient of 0 in exact arithmetic (it adds a
constant to every score of a query's row) and rounding noise on each side,
which Adam divides by its own size: its entries are held to a gradient and
first moment below 1e-6 of the model's largest gradient on both sides, and
to parameters and EMA within 2 lr summed over the steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from imagefolder_tpu.models import build_rar as jax_build_rar
from imagefolder_tpu.models.rar import RAR as JaxRAR
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu.train import rar_train as jax_rar_train
from imagefolder_tpu_torch.models import build_rar
from imagefolder_tpu_torch.train import optim
from imagefolder_tpu_torch.train.rar_train import (RARTrainConfig, RARTrainer,
                                                   get_rar_random_ratio)
from imagefolder_tpu_torch.utils.convert import rar_key_map, rar_state_dict_from_flax
from test_torch_rar import _excite_adaln
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = dict(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=4, num_classes=10)
B, L, V = 2, 16, 32
TOL = 1e-5
ZERO_GRAD = "attn.k_norm.bias"  # a parameter whose gradient is 0 in exact arithmetic
ZERO_GRAD_FLOOR = 1e-6  # of the model's largest gradient
# of the lr summed over the steps: fp32 Adam's step m / sqrt(v) loses relative
# precision where a gradient's sign flips between steps (a parameter that
# starts at 0, a bias, is all update), as test_torch_var_train.py bounds it
UPDATE_FLOOR = 1e-2


@pytest.mark.parametrize("start,end", [(0, 100), (10, 20), (5, 5), (0, 0)])
def test_get_rar_random_ratio_matches_jax(start, end):
    for step in (0, 1, 4, 5, 6, 10, 15, 19, 20, 21, 50, 100, 101):
        assert get_rar_random_ratio(start, end, step) == \
            jax_rar_train.get_rar_random_ratio(start, end, step), (start, end, step)


@pytest.mark.parametrize("kw", [dict(), dict(use_ema_warmup=True),
                                dict(update_after_step=3), dict(decay=0.999, min_decay=0.5),
                                dict(use_ema_warmup=True, update_after_step=3, inv_gamma=2.0,
                                     power=0.75)])
def test_ema_decay_schedule_matches_jax(kw):
    """open-muse's decay at steps 0-50 (fp32 in JAX, fp64 here)."""
    for step in range(51):
        want = float(jax_optim.ema_decay_schedule(step, **kw))
        got = optim.ema_decay_schedule(step, **kw)
        assert (got == 0.0) == (want == 0.0), step
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("args", [(0.0, 4e-4, 5, 30, 1e-5), (0.0, 2e-4, 1, 20, 0.0),
                                  (1e-5, 1e-3, 0, 12, 1e-4), (0.0, 1.0, 3, 4, 0.1)])
def test_warmup_cosine_decay_schedule_matches_optax(args):
    """From step 0 (the first lr is init, or with no warmup the peak) to past
    the end of the decay."""
    init, peak, warmup, decay, end = args
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end_value=end)
    got = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay, end_value=end)
    for step in range(decay + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))
    assert got(0) == (init if warmup else peak)


@pytest.fixture(scope="module")
def tiny():
    jr = jax_build_rar(**TINY)
    params = jax.jit(jr.init)(jax.random.PRNGKey(0), jnp.zeros((B, L), jnp.int32),
                              jnp.zeros((B,), jnp.int32))["params"]
    params = _excite_adaln(jax.tree_util.tree_map(np.asarray, params),
                           np.random.default_rng(0))
    return jr, params


def _port(params):
    pr = build_rar(**TINY, device="cpu")
    pr.load_state_dict(rar_state_dict_from_flax(params), strict=True)
    return pr


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_sample_orders_matches_jax(tiny, ratio):
    """JAX's orders from the uniforms and permutations it draws, injected;
    without them every row is the raster order or a permutation of it."""
    jr, params = tiny
    b, key = 6, jax.random.PRNGKey(4)
    want = jr.apply({"params": params}, key, b, ratio, method=JaxRAR.sample_orders)
    k1, k2 = jax.random.split(key)
    uniforms = np.array(jax.random.uniform(k1, (b, 1)))[:, 0]
    perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, L))(jax.random.split(k2, b)))
    pr = _port(params)
    got = pr.sample_orders(b, ratio, uniforms=torch.from_numpy(uniforms),
                           permutations=torch.from_numpy(perms))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = pr.sample_orders(b, ratio, torch.Generator().manual_seed(0))
    assert torch.equal(drawn.sort(dim=1).values, torch.arange(L).expand(b, L))
    raster = (drawn == torch.arange(L)).all(1)
    if ratio == 0.0:
        assert bool(raster.all())
    if ratio == 1.0:
        assert not bool(raster.any())


def test_train_config_matches_jax():
    assert dataclasses.asdict(RARTrainConfig()) == \
        dataclasses.asdict(jax_rar_train.RARTrainConfig())


def _flat(tree) -> dict:
    """{"a/b/leaf": array} of a flax tree, MaskedNode leaves left out."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in leaves if not isinstance(v, optax.MaskedNode)}


def _by_name(flat: dict) -> dict:
    """A flat flax tree as the port's parameter names (Dense kernels
    transposed)."""
    return {name: flat[path].T if transposed else flat[path]
            for name, (path, transposed) in rar_key_map(TINY["depth"]).items()}


def _adam_moments(opt_state) -> tuple:
    """(mu, nu) by port name from the JAX trainer's optimizer state: clip,
    then a multi_transform whose decay and no-decay chains each start with
    scale_by_adam over their own parameters."""
    mu, nu = {}, {}
    for label, inner in opt_state[1].inner_states.items():
        if label == "frozen":
            continue
        adam = inner.inner_state[0]
        mu.update(_flat(adam.mu))
        nu.update(_flat(adam.nu))
    return _by_name(mu), _by_name(nu)


def _close(got: np.ndarray, want: np.ndarray, what: str, floor: float = 1e-30):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(TOL * np.abs(want).max(), floor), err_msg=what)


@pytest.mark.parametrize("every", [1, 2])
def test_two_trainer_steps_match_jax(tiny, every):
    jr, params = tiny
    tcfg = RARTrainConfig(lr=1e-3, end_lr=1e-5, warmup_steps=2, total_steps=10,
                          class_label_dropout=0.5, ema_update_every=every)
    jtr = jax_rar_train.RARTrainer(jr, jax_rar_train.RARTrainConfig(**dataclasses.asdict(tcfg)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_rar_train.RARTrainState(params=jp, opt_state=jtr.tx.init(jp),
                                        ema_params=jax.tree_util.tree_map(jnp.copy, jp),
                                        step=jnp.zeros((), jnp.int32))
    pr = _port(params)
    ptr = RARTrainer(pr, tcfg)
    rng = np.random.default_rng(8)
    lr_sum = 0.0
    for step in range(2):
        tokens = rng.integers(0, V, (B, L))
        labels = rng.integers(0, 10, B)
        key = jax.random.fold_in(jax.random.PRNGKey(9), step)
        ratio = 0.5
        # the draws the JAX step makes from its key, for the port to replay
        k_cond, k_ord = jax.random.split(key)
        drop = np.array(jax.random.uniform(k_cond, (B,)) < tcfg.class_label_dropout)
        orders = np.array(jr.apply({"params": state.params}, k_ord, B, ratio,
                                   method=JaxRAR.sample_orders))
        grads = jax.jit(jax.grad(lambda p: jax_rar_train.ar_loss(*jr.apply(
            {"params": p}, jnp.asarray(tokens),
            jr.apply({"params": p}, jnp.asarray(labels), k_cond, tcfg.class_label_dropout,
                     method=JaxRAR.preprocess_condition),
            orders=jnp.asarray(orders)))[0]))(state.params)
        state, metrics = jtr.train_step(state, jnp.asarray(tokens), jnp.asarray(labels), key,
                                        ratio)
        lr_sum += ptr.opt.lr_schedule(step)
        got = ptr.train_step(torch.from_numpy(tokens), torch.from_numpy(labels), ratio,
                             drop=torch.from_numpy(drop), orders=torch.from_numpy(orders))
        for name in ("loss", "correct_tokens", "grad_norm"):
            np.testing.assert_allclose(got[name].item(), float(metrics[name]), rtol=TOL,
                                       err_msg=f"step {step} {name}")
        # the port's optimizer clips p.grad in place: compare the clipped one
        clip = min(1.0, tcfg.grad_clip / float(metrics["grad_norm"]))
        want_g = {k: v * clip for k, v in _by_name(_flat(grads)).items()}
        top = max(np.abs(w).max() for w in want_g.values())
        want_p, want_e = _by_name(_flat(state.params)), _by_name(_flat(state.ema_params))
        want_mu, want_nu = _adam_moments(state.opt_state)
        for (name, p), e in zip(pr.named_parameters(), ptr.ema):
            s = ptr.opt.opt.state[p]
            got_all = dict(grad=p.grad.numpy(), param=p.detach().numpy(), ema=e.numpy(),
                           mu=s["exp_avg"].numpy(), sqrt_nu=np.sqrt(s["exp_avg_sq"].numpy()))
            want_all = dict(grad=want_g[name], param=want_p[name], ema=want_e[name],
                            mu=want_mu[name], sqrt_nu=np.sqrt(want_nu[name]))
            what = f"step {step} {name}"
            if name.endswith(ZERO_GRAD):
                floor = ZERO_GRAD_FLOOR * top
                for key_ in ("grad", "mu"):
                    for x in (got_all[key_], want_all[key_]):
                        assert np.abs(x).max() <= floor, f"{what} {key_}"
                for key_ in ("param", "ema"):
                    np.testing.assert_allclose(got_all[key_], want_all[key_], rtol=0,
                                               atol=2 * lr_sum, err_msg=f"{what} {key_}")
                continue
            for key_ in got_all:
                floor = UPDATE_FLOOR * lr_sum if key_ in ("param", "ema") else 1e-30
                _close(got_all[key_], want_all[key_], f"{what} {key_}", floor)
    assert ptr.step == 2 and int(state.step) == 2
    restored = RARTrainer(_port(params), tcfg)
    restored.load_state_dict(ptr.state_dict())
    assert restored.step == 2 and restored.opt.count == 2
    for a, b in zip(restored.ema, ptr.ema):
        assert torch.equal(a, b)
