"""Port parity, the VAR optimizer: ``imagefolder_tpu_torch/train/optim.py``
against ``imagefolder_tpu/train/optim.py`` on the CPU.

Schedules at every step of a 50-step run; the decay / no-decay label of
every VAR parameter through the converter's key map; three clipped AdamW
steps of ``adamw_with_freezing`` on one parameter tree from the same
numpy-seeded gradients; the EMA update. Tolerances: schedules 1e-6 relative
(JAX evaluates them in fp32, the port in fp64); parameters 1e-6 absolute
(fp32 AdamW arithmetic in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from imagefolder_tpu.models.var import VAR as JaxVAR
from imagefolder_tpu.models.var import VARConfig as JaxVARConfig
from imagefolder_tpu.train import optim as jax_optim
from imagefolder_tpu_torch.models.var import VAR as PtVAR
from imagefolder_tpu_torch.models.var import VARConfig as PtVARConfig
from imagefolder_tpu_torch.train import optim

SCHEDS = ["cos", "lin", "lin0", "lin00", "lin0.3", "exp", "const"]


@pytest.mark.parametrize("sched", SCHEDS)
def test_lr_wd_annealing_matches_jax(sched):
    want_fn = jax_optim.lr_wd_annealing(sched, 3e-4, 10, 50, 0.1)
    got_fn = optim.lr_wd_annealing(sched, 3e-4, 10, 50, 0.1)
    want = np.array([float(want_fn(s)) for s in range(50)])
    got = np.array([got_fn(s) for s in range(50)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(3e-4 * 0.005)  # optax counts from 0: lr * wp0 first


def test_wd_cosine_anneal_matches_jax():
    want_fn, got_fn = jax_optim.wd_cosine_anneal(0.05, 0.2, 50), optim.wd_cosine_anneal(0.05,
                                                                                        0.2, 50)
    np.testing.assert_allclose([got_fn(s) for s in range(50)],
                               [float(want_fn(s)) for s in range(50)], rtol=1e-6)


def _labels(tree):
    """flax path -> the JAX package's no-decay label, over a param tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax_optim._path_str(path): jax_optim.no_decay_predicate(jax_optim._path_str(path))
            for path, _ in flat}


@pytest.mark.parametrize("kw", [dict(attn_l2_norm=True), dict(shared_aln=True, p_drop=0.0)],
                         ids=["l2norm", "shared_aln"])
def test_no_decay_labels_of_every_var_parameter_match_jax(kw):
    base = dict(vocab_size=32, Cvae=8, num_classes=10, depth=2, embed_dim=128, num_heads=2,
                patch_nums=(1, 2, 3))
    jcfg = JaxVARConfig(**base, **kw)
    x_in = jnp.zeros((2, jcfg.L - jcfg.first_l, 8))
    params = jax.jit(JaxVAR(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray([0, 1]),
                                        x_in)["params"]
    want = _labels(params)
    pvar = PtVAR(PtVARConfig(**base, **kw), device="cpu")
    paths = optim.var_flax_paths(pvar)
    assert sorted(paths) == sorted(n for n, _ in pvar.named_parameters())
    got = {paths[n]: optim.no_decay_predicate(paths[n]) for n, _ in pvar.named_parameters()}
    assert got == want
    # the JAX package decays q_bias and v_bias (upstream's filter_params
    # exempts every 1-D parameter): the port keeps the JAX labels
    assert not got["block_0/attn/q_bias"] and not got["block_0/attn/v_bias"]
    opt = optim.adamw_with_freezing(pvar, lambda s: 1e-4, weight_decay=0.05, paths=paths)
    decay, plain = opt.opt.param_groups
    names = {id(p): n for n, p in pvar.named_parameters()}
    assert {names[id(p)] for p in plain["params"]} == {n for n in paths if got[paths[n]]}
    assert decay["weight_decay"] == 0.05 and plain["weight_decay"] == 0.0


class _Tree(nn.Module):
    """One small parameter tree: a Dense (kernel decayed, bias not), a norm
    scale (not decayed) and a free matrix (decayed)."""

    PATHS = {"dense.weight": "dense/kernel", "dense.bias": "dense/bias",
             "ln.weight": "final_norm/scale", "w": "block_0/w"}

    def __init__(self, arrays):
        super().__init__()
        self.dense = nn.Linear(4, 3)
        self.ln = nn.LayerNorm(3, bias=False)
        self.w = nn.Parameter(torch.zeros(5, 2))
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(arrays[self.PATHS[name]]))


@pytest.mark.parametrize("wd_end", [None, 0.5])
def test_three_clipped_adamw_steps_match_jax(wd_end):
    """Steps with gradient norms below, above and far above the clip of 1,
    under a warmup schedule, with constant or cosine-annealed decay."""
    rng = np.random.default_rng(0)
    shapes = {"dense/kernel": (3, 4), "dense/bias": (3,), "final_norm/scale": (3,),
              "block_0/w": (5, 2)}
    arrays = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.05, 0.8, 30.0)]

    def nest(flat):
        out = {}
        for k, v in flat.items():
            a, b = k.split("/")
            out.setdefault(a, {})[b] = jnp.asarray(v)
        return out

    sched_j = jax_optim.lr_wd_annealing("cos", 0.1, 2, 3, 0.1)
    tx = jax_optim.adamw_with_freezing(sched_j, weight_decay=0.05, b1=0.9, b2=0.95,
                                       grad_clip=1.0, weight_decay_end=wd_end, total_steps=3)
    params = nest(arrays)
    state = tx.init(params)
    model = _Tree(arrays)
    opt = optim.adamw_with_freezing(model, optim.lr_wd_annealing("cos", 0.1, 2, 3, 0.1),
                                    weight_decay=0.05, b1=0.9, b2=0.95, grad_clip=1.0,
                                    weight_decay_end=wd_end, total_steps=3, paths=_Tree.PATHS)
    for g in grads:
        updates, state = tx.update(nest(g), state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[_Tree.PATHS[name]].copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(nest(g))), rtol=1e-6)
        for name, p in model.named_parameters():
            a, b = _Tree.PATHS[name].split("/")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[a][b]), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert opt.count == 3
    restored = optim.adamw_with_freezing(_Tree(arrays), lambda s: 0.1, paths=_Tree.PATHS)
    restored.load_state_dict(opt.state_dict())
    assert restored.count == 3


def test_frozen_parameters_stay_out_of_the_optimizer():
    model = _Tree({k: np.ones(s, np.float32) for k, s in
                   {"dense/kernel": (3, 4), "dense/bias": (3,), "final_norm/scale": (3,),
                    "block_0/w": (5, 2)}.items()})
    model.w.requires_grad_(False)
    opt = optim.adamw_with_freezing(model, lambda s: 1e-3, paths=_Tree.PATHS)
    assert not any(p is model.w for p in opt.params)
    with pytest.raises(ValueError):
        optim.adamw_with_freezing(model, lambda s: 1e-3, weight_decay=0.1,
                                  weight_decay_end=0.0)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(3)
    ema = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2)]
    new = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2)]
    want = jax_optim.ema_update([jnp.asarray(e) for e in ema], [jnp.asarray(p) for p in new],
                                decay=0.99)
    got = [torch.from_numpy(e.copy()) for e in ema]
    optim.ema_update(got, [torch.from_numpy(p) for p in new], decay=0.99)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def test_var_config_fields_match_jax():
    """The port's VARTrainConfig mirrors the JAX one field for field."""
    from imagefolder_tpu.train.var_train import VARTrainConfig as JaxCfg
    from imagefolder_tpu_torch.train.var_train import VARTrainConfig

    assert dataclasses.asdict(VARTrainConfig()) == dataclasses.asdict(JaxCfg())
