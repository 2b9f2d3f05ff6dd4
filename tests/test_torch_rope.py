"""Port parity, the ViT decoder's RoPE blocks and ``cond_latent``:
``imagefolder_tpu_torch`` against the JAX package on the CPU, on the same
numpy-seeded inputs and parameters (``_torch_parity.random_params``).

- the numpy helpers (``init_1d_freqs``, ``init_2d_freqs``, ``init_t_xy``)
  bit-equal to the JAX module's, and ``compute_mixed_cis`` and
  ``apply_rotary`` in torch against the JAX module's;
- ``RoPEAttention`` alone (width 64, 2 heads; cls, a 4 x 4 image grid and 16
  latents), with and without a shared bias: the output and, by
  ``jax.vjp``, the gradients of the input and of every parameter;
- ``LatentDecoder`` at a tiny preset (width 64, depth 2, 2 heads; 64 px,
  16 latents) with ``use_rope=True, abs_pos_embed=False``, and with
  ``cond_latent=True`` under absolute and learned latent position
  embeddings: the pixels and the pre-last activation, and every gradient,
  the parameters carried by ``latent_decoder_state_dict_from_flax`` (the
  JAX package exports none of ``freqs``, ``freqs_1d`` or ``cl_*``) and
  each port parameter read back from its ``flax_path``;
- RoPE blocks never fuse (``set_fused_sublayers`` skips them).

Tolerance: values and gradients within 1e-4 of the largest (fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.ops import rope as jax_rope
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.ops import rope as pt_rope
from imagefolder_tpu_torch.utils.convert import flax_path, latent_decoder_state_dict_from_flax

from tests._torch_parity import one_torch_thread, random_params  # noqa: F401

TINY = "tiny_test_vit"
TINY_PRESET = dict(embed_dim=64, depth=2, num_heads=2)
IMG, PATCH, NL, B = 64, 16, 16, 2
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, what: str):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= TOL * scale, f"{what}: {err:.3e} over max {scale:.3e}"


@pytest.mark.parametrize("dim,end", [(32, 16), (64, 256), (48, 7)])
def test_init_1d_freqs_bit_equal(dim, end):
    np.testing.assert_array_equal(pt_rope.init_1d_freqs(dim, end),
                                  jax_rope.init_1d_freqs(dim, end))


@pytest.mark.parametrize("seed,rotate", [(0, True), (7, True), (3, False)])
def test_init_2d_freqs_bit_equal(seed, rotate):
    got = pt_rope.init_2d_freqs(64, 12, 10.0, rotate=rotate, seed=seed)
    np.testing.assert_array_equal(got, jax_rope.init_2d_freqs(64, 12, 10.0, rotate, seed))


def test_init_t_xy_bit_equal():
    for a, b in zip(pt_rope.init_t_xy(16, 16), jax_rope.init_t_xy(16, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("per_head", [True, False], ids=["mixed-2d", "1d"])
def test_rotary_matches_jax(per_head):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 3, 32)).astype(np.float32)
    if per_head:
        freqs = pt_rope.init_2d_freqs(32, 3, seed=5)
        tx, ty = pt_rope.init_t_xy(4, 4)
        cis_t = pt_rope.compute_mixed_cis(*map(torch.from_numpy, (freqs, tx, ty)))
        cis_j = jax_rope.compute_mixed_cis(*map(jnp.asarray, (freqs, tx, ty)))
        _close(cis_t, cis_j, "compute_mixed_cis")
    else:
        cis_t = torch.from_numpy(pt_rope.init_1d_freqs(32, 16))
        cis_j = jnp.asarray(cis_t.numpy())
    got = pt_rope.apply_rotary(torch.from_numpy(x), cis_t)
    _close(got, jax_rope.apply_rotary(jnp.asarray(x), cis_j), "apply_rotary")


def _grads_by_flax_path(module: torch.nn.Module, gp, what: str):
    """Each port parameter's gradient against the JAX gradient at its
    flax path (a Dense kernel transposed); a parameter the forward never
    reads (no port gradient) against zeros."""
    for name, p in module.named_parameters():
        leaf = gp
        for k in flax_path(name).split("/"):
            leaf = leaf[k]
        want = np.asarray(leaf)
        if name.endswith(".weight") and want.ndim == 2 and "embed" not in name:
            want = want.T
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got, want, f"{what} gradient of {name}")


@pytest.mark.parametrize("masked", [False, True], ids=["no-bias", "shared-bias"])
def test_rope_attention_matches_jax(masked):
    dim, heads, nimg = 64, 2, 16
    n = 1 + nimg + NL
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, n, dim)).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.uniform(size=(1, 1, n, n)) < 0.2, -np.inf, 0.0).astype(np.float32)
        np.fill_diagonal(mask[0, 0], 0.0)
    jm = jax_vit.RoPEAttention(heads, num_latent_tokens=NL, num_image_tokens=nimg)
    params = random_params(jm, jnp.asarray(x))
    params = dict(params, freqs=jnp.asarray(jax_rope.init_2d_freqs(dim // heads, heads, seed=3)),
                  freqs_1d=jnp.asarray(jax_rope.init_1d_freqs(dim // heads, NL)))
    pm = pt_vit.RoPEAttention(dim, heads, NL, nimg)
    sd = {f"{n}.{w}": torch.from_numpy(np.asarray(params[n][k]).T.copy())
          for n in ("qkv", "proj") for w, k in (("weight", "kernel"), ("bias", "bias"))}
    sd.update({n: torch.from_numpy(np.array(params[n])) for n in ("freqs", "freqs_1d")})
    pm.load_state_dict(sd, strict=True)
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(jax.jit(lambda p, xx: jm.apply({"params": p}, xx, jmask)), params,
                        jnp.asarray(x))
    w = rng.normal(size=want.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt, None if mask is None else torch.from_numpy(mask))
    _close(got, want, "RoPEAttention output")
    got.backward(torch.from_numpy(w))
    _close(xt.grad, gx, "RoPEAttention input gradient")
    for name, p in pm.named_parameters():
        leaf = gp
        for k in flax_path(name).split("/"):
            leaf = leaf[k]
        want_g = np.asarray(leaf).T if name.endswith(".weight") else np.asarray(leaf)
        _close(p.grad, want_g, f"RoPEAttention gradient of {name}")


DECODERS = {
    "rope": dict(use_rope=True, abs_pos_embed=False),
    "cond-latent-abs-pos": dict(cond_latent=True, abs_pos_embed=True),
    "cond-latent-latent-pos": dict(cond_latent=True, abs_pos_embed=False),
}


@pytest.mark.parametrize("kind", list(DECODERS))
def test_latent_decoder_matches_jax(kind):
    kw = DECODERS[kind]
    rng = np.random.default_rng(4)
    z = rng.normal(size=(B, NL, TINY_PRESET["embed_dim"])).astype(np.float32)
    jm = jax_vit.LatentDecoder(model_name=TINY, img_size=IMG, patch_size=PATCH,
                               num_latent_tokens=NL, **kw)
    params = random_params(jm, jnp.asarray(z), seed=5)
    pm = pt_vit.LatentDecoder(TINY, IMG, PATCH, NL, **kw)
    sd = latent_decoder_state_dict_from_flax(params)
    if kw.get("use_rope"):
        assert {"model.blocks.0.attn.freqs", "model.blocks.1.attn.freqs_1d"} <= set(sd)
        assert not any(k.startswith(("lvl_embed", "latent_pos_embed", "cl_")) for k in sd)
    else:
        assert {"cl_mlp1.fc1.weight", "cl_mlp2.norm.weight", "cl_norm1.bias"} <= set(sd)
    pm.load_state_dict(sd, strict=True)

    def jax_fn(p, zz):
        return jm.apply({"params": p}, zz, return_prelast=True)

    (want, want_pre), vjp = jax.vjp(jax.jit(jax_fn), params, jnp.asarray(z))
    w = rng.normal(size=want.shape).astype(np.float32)
    w_pre = rng.normal(size=want_pre.shape).astype(np.float32)
    gp, gz = vjp((jnp.asarray(w), jnp.asarray(w_pre)))
    zt = torch.from_numpy(z).requires_grad_()
    got, got_pre = pm(zt, return_prelast=True)
    _close(got, want, f"{kind} pixels")
    _close(got_pre, want_pre, f"{kind} pre-last activation")
    ((got * torch.from_numpy(w)).sum() + (got_pre * torch.from_numpy(w_pre)).sum()).backward()
    _close(zt.grad, gz, f"{kind} latent gradient")
    _grads_by_flax_path(pm, gp, kind)


def test_rope_blocks_never_fuse():
    dec = pt_vit.LatentDecoder(TINY, IMG, PATCH, NL, use_rope=True, abs_pos_embed=False)
    assert pt_vit.set_fused_sublayers(dec, True, True) == 0
    assert all(isinstance(b.attn, pt_vit.RoPEAttention) for b in dec.model.blocks)
    with pytest.raises(ValueError, match="never fuses"):
        pt_vit.Block(64, 2, use_rope=True, num_latent_tokens=NL, num_image_tokens=16,
                     fuse_attn=True)
