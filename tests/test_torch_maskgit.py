"""Port parity, MaskGIT: ``imagefolder_tpu_torch/models/maskgit.py`` and
``MaskGITTrainer`` (``imagefolder_tpu_torch/train/rar_train.py``) against
the JAX package's ``imagefolder_tpu/models/maskgit.py`` and its MaskGIT
step (``scripts/train_rar.py:338-352``) on the CPU.

A tiny MaskGIT of each trunk (``bert`` and ``uvit``: depth 2, width 96, 2
heads of 48, MaskGIT-B's head dim; 16 image tokens, a codebook of 32, 10
classes), fp32, with the JAX params (every one moved off its init by a
small normal draw, so that a norm's scale and bias or a zero bias tell
apart) carried by ``maskgit_state_dict_from_flax`` and loaded strict.
Every random draw of the JAX side is replayed into the port from its own
key splits: the condition drop (``uniform(rng, (B,)) < p``), the masking's
t and scores (``mask_input_tokens``' two keys), and each sampling step's
two Gumbel draws (``maskgit_generate``'s three-way split). Tolerances:
logits, loss, gradients and updated parameters within 1e-5 of their max
abs (fp32, summation order only); masks and tokens exact. One exception:
the key third of the bert trunk's qkv bias adds a constant to every score
of a query's row, so its gradient is 0 in exact arithmetic and rounding
noise on each side; Adam divides that noise by its own size, so those
entries' updates differ by up to the lr. They are held to a gradient
below 1e-6 of the model's largest on both sides, and to parameters within
2 lr summed over the steps.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from imagefolder_tpu.models import build_maskgit as jax_build_maskgit
from imagefolder_tpu.models.maskgit import MaskGITConfig as JaxMaskGITConfig
from imagefolder_tpu.models.maskgit import _gumbel as jax_gumbel
from imagefolder_tpu.models.maskgit import mask_input_tokens as jax_mask_input_tokens
from imagefolder_tpu.models.maskgit import maskgit_generate as jax_maskgit_generate
from imagefolder_tpu.models.maskgit import mlm_loss as jax_mlm_loss
from imagefolder_tpu.utils.convert_torch import convert_maskgit_uvit
from imagefolder_tpu_torch.models import build_maskgit
from imagefolder_tpu_torch.models.maskgit import (MaskGITConfig, mask_input_tokens,
                                                  maskgit_generate, mlm_loss)
from imagefolder_tpu_torch.train.rar_train import MaskGITTrainer
from imagefolder_tpu_torch.utils.convert import maskgit_state_dict_from_flax
from tests._torch_parity import one_torch_thread  # noqa: F401


TINY = dict(seq_len=16, codebook_size=32, hidden=96, depth=2, heads=2, num_classes=10)
B, L, V = 2, 16, 32
TOL = 1e-5
ARCHS = ["bert", "uvit"]
ZERO_GRAD_FLOOR = 1e-6  # of the model's largest gradient: the key bias's noise


def _key_bias(name: str, p: torch.Tensor):
    """The entries of ``name`` whose gradient is 0 in exact arithmetic: the
    key third of a qkv bias (None elsewhere)."""
    if not name.endswith("attn.qkv.bias"):
        return None
    d = p.shape[0] // 3
    return slice(d, 2 * d)


def _build(arch):
    jm = jax_build_maskgit(**TINY, arch=arch)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((B, L), jnp.int32),
                                       jnp.zeros((B,), jnp.int32), rng=k))(key)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.02, np.shape(x))).astype(np.float32), params)
    pm = build_maskgit(**TINY, arch=arch, device="cpu")
    pm.load_state_dict(maskgit_state_dict_from_flax(params, pm.config), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _build(request.param)


def _close(got: np.ndarray, want: np.ndarray, what: str, tol: float = TOL):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def test_config_and_builder_match_jax():
    """MaskGITConfig's fields and defaults and build_maskgit's defaults
    (MaskGIT-B: 768 wide, 24 deep, 16 heads, the bert trunk) as the JAX
    package's."""
    assert dataclasses.asdict(MaskGITConfig()) == dataclasses.asdict(JaxMaskGITConfig())
    defaults = lambda fn: {k: p.default for k, p in inspect.signature(fn).parameters.items()
                           if k not in ("generator", "device")}  # noqa: E731
    assert defaults(build_maskgit) == defaults(jax_build_maskgit)
    cfg = MaskGITConfig()
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.arch) == (768, 24, 16, "bert")
    for name in ("mask_token_id", "vocab", "none_condition_id"):
        assert getattr(cfg, name) == getattr(JaxMaskGITConfig(), name)


def test_uvit_state_dict_is_what_convert_maskgit_uvit_reads():
    """The uvit state dict is upstream UViTBert's: ``convert_maskgit_uvit``
    reads every one of its keys and gives back the flax params, key for
    key, shape for shape, value for value."""
    _, params, pm = _build("uvit")
    sd = {k: v.numpy() for k, v in maskgit_state_dict_from_flax(params, pm.config).items()}
    assert sorted(sd) == sorted(pm.state_dict())

    class Reads(dict):
        read = set()

        def __getitem__(self, key):
            self.read.add(key)
            return dict.__getitem__(self, key)

        def __contains__(self, key):
            return dict.__contains__(self, key)

    src = Reads(sd)
    back = convert_maskgit_uvit(src, TINY["depth"])
    assert src.read == set(sd)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert sorted(map(str, flat_back)) == sorted(map(str, flat_want))
    for path, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), want, err_msg=str(path))


@pytest.mark.parametrize("drop", ["none", "replayed", "all"])
def test_forward_matches_jax(models, drop):
    """Logits for masked inputs under no drop, the condition-drop mask JAX
    draws from its rng replayed (one of the two samples dropped), and every
    condition dropped (cond_drop_prob 1)."""
    jm, params, pm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, V + 1, (B, L))  # the mask token V among them
    cond = rng.integers(0, 10, B)
    p, key = {"none": 0.0, "replayed": 0.5, "all": 1.0}[drop], jax.random.PRNGKey(3)
    want = jax.jit(lambda i, c: jm.apply({"params": params}, i, c, cond_drop_prob=p, rng=key))(
        jnp.asarray(ids), jnp.asarray(cond))
    mask = None
    if drop == "replayed":
        mask = torch.from_numpy(np.array(jax.random.uniform(key, (B,)) < p))
        assert 0 < int(mask.sum()) < B
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(cond), cond_drop_prob=p, drop=mask)
    assert got.shape == (B, L, V) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), f"logits, drop {drop}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_input_tokens_matches_jax(seed):
    """The arccos masking with JAX's t and scores replayed: the masked
    tokens and the mask exactly (``jnp.round`` and ``torch.round`` both
    round half to even, both argsorts are stable); per sample at least one
    and at most L tokens masked."""
    b, l = 8, 256
    tokens = np.random.default_rng(seed).integers(0, V, (b, l))
    key = jax.random.PRNGKey(seed)
    want_tok, want_mask = jax.jit(lambda t, k: jax_mask_input_tokens(t, k, V))(
        jnp.asarray(tokens), key)
    k1, k2 = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.uniform(k1, (b,))))
    scores = torch.from_numpy(np.array(jax.random.uniform(k2, (b, l))))
    got_tok, got_mask = mask_input_tokens(torch.from_numpy(tokens), V, t=t, scores=scores)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    counts = got_mask.sum(1)
    assert bool((counts >= 1).all()) and bool((counts <= l).all())


def test_mlm_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, L, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (3, L))
    targets[:, :4] = logits[:, :4].argmax(-1)  # some right answers
    masks = rng.random((3, L)) < 0.5
    want_loss, want_acc = jax_mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                                       jnp.asarray(masks))
    loss, acc = mlm_loss(*(torch.from_numpy(x) for x in (logits, targets, masks)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(acc.item(), float(want_acc), rtol=1e-6)


def _jax_noise(key, steps: int, shape):
    """The Gumbel draws ``maskgit_generate`` makes, from its own key splits."""
    noise = []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        noise.append(tuple(torch.from_numpy(np.array(jax_gumbel(k, s)))
                           for k, s in ((k1, shape), (k2, shape[:2]))))
    return noise


@pytest.mark.parametrize("decay,anneal", [("constant", False), ("linear", False),
                                          ("power-cosine", False), ("constant", True),
                                          ("power-cosine", True)])
def test_generate_matches_jax(models, decay, anneal):
    """``maskgit_generate``'s tokens identical to JAX's with its Gumbel draws
    replayed, under each guidance decay and with softmax temperature
    annealing on."""
    jm, params, pm = models
    cond = np.array([3, 7])
    key = jax.random.PRNGKey(11)
    kw = dict(guidance_scale=3.0, guidance_decay=decay, guidance_scale_pow=3.0,
              randomize_temperature=4.5, softmax_temperature_annealing=anneal,
              num_sample_steps=8)
    want = jax_maskgit_generate(jm, params, jnp.asarray(cond), key, **kw)
    got = maskgit_generate(pm, torch.from_numpy(cond), noise=_jax_noise(key, 8, (B, L, V)),
                           **kw)
    assert got.shape == (B, L) and bool(((got >= 0) & (got < V)).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_draws_from_the_generator():
    """Without ``noise`` the draws come from the generator: the same seed
    gives the same tokens, another seed others; an unknown decay raises."""
    pm = build_maskgit(**TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    cond = torch.tensor([1, 2])
    run = lambda s: maskgit_generate(pm, cond, torch.Generator().manual_seed(s))  # noqa: E731
    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))
    with pytest.raises(ValueError, match="guidance_decay"):
        maskgit_generate(pm, cond, guidance_decay="cosine")


def test_trainer_steps_match_jax(models):
    """Two ``MaskGITTrainer`` steps against the JAX package's ``step_fn``
    (``optax.adamw`` on ``warmup_cosine_decay_schedule(0, 2e-4, 1, 20)``,
    weight decay 0.03 on every parameter) with its masking and drop draws
    replayed: loss, accuracy, every gradient and the updated parameters.
    The first step runs at lr 0 (the schedule starts at 0), the second at
    the peak."""
    jm, params, pm = models
    cfg = jm.config
    total = 20
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 2e-4, total // 20, total),
                     weight_decay=0.03)

    @jax.jit
    def step_fn(p, opt, toks, labels, k):
        k1, k2 = jax.random.split(k)
        masked, masks = jax_mask_input_tokens(toks, k1, cfg.mask_token_id)

        def loss_fn(pp):
            logits = jm.apply({"params": pp}, masked, labels, cond_drop_prob=0.1, rng=k2)
            return jax_mlm_loss(logits, toks, masks)

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, upd), opt, loss, acc, grads

    ptr = MaskGITTrainer(pm, total)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    rng = np.random.default_rng(5)
    lr_sum = 0.0
    for step in range(2):
        lr_sum += ptr.opt.lr_schedule(step)
        toks = rng.integers(0, V, (B, L))
        labels = rng.integers(0, 10, B)
        k = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jp, opt, loss, acc, grads = step_fn(jp, opt, jnp.asarray(toks), jnp.asarray(labels), k)
        k1, k2 = jax.random.split(k)
        k11, k12 = jax.random.split(k1)
        got = ptr.train_step(
            torch.from_numpy(toks), torch.from_numpy(labels),
            t=torch.from_numpy(np.array(jax.random.uniform(k11, (B,)))),
            scores=torch.from_numpy(np.array(jax.random.uniform(k12, (B, L)))),
            drop=torch.from_numpy(np.array(jax.random.uniform(k2, (B,)) < 0.1)))
        np.testing.assert_allclose(got["loss"].item(), float(loss), rtol=TOL)
        np.testing.assert_allclose(got["correct_tokens"].item(), float(acc), rtol=1e-6)
        want_g = maskgit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                                              pm.config)
        want_p = maskgit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp),
                                              pm.config)
        top = max(np.abs(w.numpy()).max() for w in want_g.values())
        for name, p in pm.named_parameters():
            g, w, q, wq = p.grad.numpy(), want_g[name].numpy(), p.detach().numpy(), \
                want_p[name].numpy()
            k = _key_bias(name, p)
            if k is not None:
                for x in (g[k], w[k]):
                    assert np.abs(x).max() <= ZERO_GRAD_FLOOR * top, f"step {step} {name}"
                np.testing.assert_allclose(q[k], wq[k], rtol=0, atol=2 * lr_sum,
                                           err_msg=f"step {step} param {name}, key third")
                keep = np.ones(g.shape[0], bool)
                keep[k] = False
                g, w, q, wq = g[keep], w[keep], q[keep], wq[keep]
            _close(g, w, f"step {step} grad {name}")
            _close(q, wq, f"step {step} param {name}")
    assert ptr.opt.count == 2
