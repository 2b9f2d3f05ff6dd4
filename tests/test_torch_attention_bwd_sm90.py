"""The bf16 attention backward of kernels #2 and #5 on the card
(``csrc/attention_bwd_sm90.cuh``), modelled on the CPU and held against the
JAX package.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain versions. Here a plain tile-by-tile model of its
algorithm, in fp32 with its bf16 rounding points, runs the same inputs as
the JAX package's ``_fused_attention_qblk_bwd`` (#5) and
``_attention_qkv_bwd_impl`` (#2) in Pallas's interpreter. The model takes
what the card's kernel takes: lse from the forward (``attention_lse_reference``),
delta = rowsum(o g) from the forward's bf16 output, and the blank-tile map
(``blank_tile_map_reference``), whose 64 x 64 tiles it never visits; it sums
dk and dv per key tile and dq tile by tile across key tiles. The bound is
the card's: each gradient within 2e-2 of the JAX result's max abs.

Also here: the map's plain version against a brute-force scan of the bias,
and the check's teeth: the model with one non-blank tile wrongly skipped
must fail the bound. #5 also runs at head dim 48 (RAR-B's 768 / 16) and at
32 and 40, which the kernel zero-pads to its 64-wide tiles: the model pads
the same way.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from imagefolder_tpu.ops.pallas import attention as jax_attn
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from tests._torch_parity import one_torch_thread  # noqa: F401


HD = 64
HD_PADDED = 64  # the kernels' tile width: a 48-wide head runs zero-padded to it
TILE = 64
TOL = 2e-2  # chip_smoke.py's bf16 bound: of the plain result's max abs
PYRAMID = (1, 3, 5, 7, 9)  # block-causal, L = 165: three tiles a side, one blank


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tile_width(hd: int) -> int:
    """The width of the kernels' shared tiles for a head of ``hd``: 64, or
    two 64-wide halves side by side for 72-128."""
    return HD_PADDED if hd <= HD_PADDED else 2 * HD_PADDED


def pad_head(x: torch.Tensor) -> torch.Tensor:
    """(..., hd) zero-padded to the kernels' tile width (``tile_width``),
    as the card's tile loads fill the columns past hd with zeros."""
    return F.pad(x, (0, tile_width(x.shape[-1]) - x.shape[-1]))


def sm90_model(q, k, v, g, bias, scale, o, lse, skip=()):
    """The card kernel's algorithm on (B, L, H, hd) bf16 q, k, v, g (hd up
    to 128, zero-padded to ``tile_width`` as the kernel's tiles are, and the
    padding columns dropped from the results), with the forward's bf16 o and fp32
    (B, H, L) lse: for every (64 keys, 64 q rows)
    tile that the blank-tile map leaves, p^T = exp(k q^T * scale + bias^T -
    lse), dv += bf16(p^T) g, dp^T = v g^T, ds^T = p^T (dp^T - delta), dk +=
    bf16(ds^T) q, dq += bf16(ds) k; then bf16(dq * scale), bf16(dk * scale),
    bf16(dv). ``skip`` names (q tile, key tile) pairs to leave out as well
    (a planted fault)."""
    b, l, h, hd = q.shape
    t = -(-l // TILE)
    qf, kf, vf, gf = (pad_head(x.float()).transpose(1, 2) for x in (q, k, v, g))  # (B, H, L, w)
    delta = (pad_head(o.float()) * pad_head(g.float())).sum(-1).transpose(1, 2)  # (B, H, L)
    blank = (pt_attn.blank_tile_map_reference(bias).clone() if bias is not None
             else torch.zeros((t, t), dtype=torch.uint8))
    for qt, kt in skip:
        blank[qt, kt] = 1
    dq, dk, dv = (torch.zeros((b, h, l, tile_width(hd))) for _ in range(3))
    for kt in range(t):
        ks = slice(kt * TILE, min(l, kt * TILE + TILE))
        for qt in range(t):
            if blank[qt, kt]:
                continue
            qs = slice(qt * TILE, min(l, qt * TILE + TILE))
            s = kf[:, :, ks] @ qf[:, :, qs].transpose(-1, -2) * scale  # rows keys
            if bias is not None:
                s = s + bias[0, 0][qs, ks].float().T
            p = torch.exp(s - lse[:, :, None, qs])
            dv[:, :, ks] += _bf(p) @ gf[:, :, qs]
            dp = vf[:, :, ks] @ gf[:, :, qs].transpose(-1, -2)
            ds = p * (dp - delta[:, :, None, qs])
            dk[:, :, ks] += _bf(ds) @ qf[:, :, qs]
            dq[:, :, qs] += _bf(ds).transpose(-1, -2) @ kf[:, :, ks]
    return tuple(x[..., :hd].to(torch.bfloat16).transpose(1, 2)
                 for x in (dq * scale, dk * scale, dv))


def _inputs(b, l, h, seed, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, h, hd)).astype(np.float32) for _ in range(4)]


def _bias(kind: str, l: int):
    if kind == "none":
        return None
    if kind == "block_causal":
        bias = build_attn_bias(PYRAMID).numpy()
        assert bias.shape == (1, 1, l, l)
        return bias
    bias = np.random.default_rng(7).normal(size=(1, 1, l, l)).astype(np.float32)
    bias[..., :TILE, TILE:] = -np.inf  # two blank tiles, ragged last key tile
    bias[..., TILE:, 5:9] = -np.inf
    return bias


def _worst(got, want) -> float:
    """The largest of the gradients' max abs errors over their JAX max abs."""
    errs = []
    for a, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert np.isfinite(w).all()
        errs.append(np.abs(a.float().numpy() - w).max() / np.abs(w).max())
    return max(errs)


def _qblk_case(bias_kind, seed=0, hd=HD):
    l = 165 if bias_kind == "block_causal" else 150
    q, k, v, g = _inputs(2, l, 2, seed, hd)
    bias = _bias(bias_kind, l)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    scale = 1.0 / np.sqrt(hd)
    o = pt_attn.fused_attention_qblk_reference(tq, tk, tv, tb, scale)
    lse = pt_attn.attention_lse_reference(tq, tk, tb, scale)
    want = jax_attn._fused_attention_qblk_bwd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), jnp.asarray(g, jnp.bfloat16),
        interpret=True)[:3]
    return (tq, tk, tv, tg, tb, scale, o, lse), want


@pytest.mark.parametrize("bias_kind", ["none", "block_causal", "dense"])
def test_model_matches_pallas_qblk_bwd(bias_kind):
    """#5: the card's algorithm against ``_fused_attention_qblk_bwd`` in
    interpret mode, bf16, ragged L, within the card's bound."""
    args, want = _qblk_case(bias_kind)
    got = sm90_model(*args)
    assert all(x.dtype == torch.bfloat16 for x in got)
    assert _worst(got, want) <= TOL


@pytest.mark.parametrize("bias_kind", ["none", "block_causal", "dense"])
def test_model_matches_pallas_qblk_bwd_at_head_dim_48(bias_kind):
    """#5 at head dim 48: the model on zero-padded 64-wide tiles against
    ``_fused_attention_qblk_bwd`` in interpret mode on the unpadded
    48-wide inputs, bf16, within the card's bound; the gradients come back
    48 wide."""
    args, want = _qblk_case(bias_kind, seed=3, hd=48)
    got = sm90_model(*args)
    assert all(x.dtype == torch.bfloat16 and x.shape == args[0].shape for x in got)
    assert _worst(got, want) <= TOL


@pytest.mark.parametrize("hd", [32, 40])
@pytest.mark.parametrize("bias_kind", ["none", "block_causal"])
def test_model_matches_pallas_qblk_bwd_at_head_dims_32_and_40(bias_kind, hd):
    """#5 at head dims 32 and 40, which the card runs on the head-dim-48
    code: the model on tiles zero-padded to 64 against
    ``_fused_attention_qblk_bwd`` in interpret mode on the narrow inputs,
    within the card's bound; the gradients come back hd wide."""
    args, want = _qblk_case(bias_kind, seed=3, hd=hd)
    got = sm90_model(*args)
    assert all(x.dtype == torch.bfloat16 and x.shape == args[0].shape for x in got)
    assert _worst(got, want) <= TOL


@pytest.mark.parametrize("masked", [False, True])
def test_model_matches_pallas_qkv_bwd(masked):
    """#2: the same algorithm on the (B, N, H, 64) views of a packed qkv
    against ``_attention_qkv_bwd_impl`` in interpret mode, dqkv re-packed."""
    b, n, h = 2, 150, 2
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(b, n, 3 * h * HD)).astype(np.float32)
    g = rng.normal(size=(b, n, h * HD)).astype(np.float32)
    bias = _bias("dense", n) if masked else None
    want, _ = jax_attn._attention_qkv_bwd_impl(
        jnp.asarray(qkv, jnp.bfloat16), None if bias is None else jnp.asarray(bias),
        jnp.asarray(g, jnp.bfloat16), heads=h, scale=None, interpret=True)
    tqkv, tg = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16()
    tb = None if bias is None else torch.from_numpy(bias)
    scale = 1.0 / np.sqrt(HD)
    q, k, v = tqkv.view(b, n, 3, h, HD).unbind(2)
    o = pt_attn.attention_qkv_reference(tqkv, h, tb, scale)
    lse = pt_attn.attention_lse_reference(q, k, tb, scale)
    dq, dk, dv = sm90_model(q, k, v, tg.view(b, n, h, HD), tb, scale, o.view(b, n, h, HD), lse)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(b, n, 3 * h * HD)
    assert _worst([dqkv], [want]) <= TOL


@pytest.mark.parametrize("skip", [(2, 2), (1, 0)])
def test_model_with_a_skipped_tile_fails(skip):
    """The bound has teeth: the same model with one tile the mask leaves
    (the last diagonal one; a full off-diagonal one) wrongly skipped misses
    it by a wide margin."""
    args, want = _qblk_case("block_causal")
    assert not pt_attn.blank_tile_map_reference(args[4])[skip]
    assert _worst(sm90_model(*args, skip=(skip,)), want) > 5 * TOL


def test_model_with_a_skipped_tile_fails_at_head_dim_48():
    """The bound keeps its teeth at head dim 48: the last diagonal tile
    wrongly skipped misses it by a wide margin."""
    args, want = _qblk_case("block_causal", seed=3, hd=48)
    assert _worst(sm90_model(*args, skip=((2, 2),)), want) > 5 * TOL


def _brute_map(bias: np.ndarray) -> np.ndarray:
    l = bias.shape[-1]
    t = -(-l // TILE)
    out = np.zeros((t, t), np.uint8)
    for i in range(t):
        for j in range(t):
            tile = bias[..., i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE]
            out[i, j] = np.isneginf(tile).all()
    return out


@pytest.mark.parametrize("case", ["pyramid", "pyramid_512", "dense", "encoder_2049",
                                  "all_finite", "one_row"])
def test_blank_tile_map_matches_brute_force(case):
    """``blank_tile_map_reference`` against a scan of every tile: the block-
    causal pyramids (L = 165, and the 512 px L = 2240 with its 34% blank
    tiles), a dense bias with whole tiles masked, a ragged (2049, 2049) mask
    whose last tile is one row and column, no -inf at all, and L = 1."""
    if case == "pyramid":
        bias = build_attn_bias(PYRAMID).numpy()
    elif case == "pyramid_512":
        bias = build_attn_bias((1, 2, 3, 4, 6, 9, 13, 18, 24, 32)).numpy()
    elif case == "dense":
        bias = _bias("dense", 150)
    elif case == "encoder_2049":
        bias = np.zeros((2049, 2049), np.float32)
        bias[:1024, 1024:] = -np.inf  # the latents' rows see no image row past 1024
        bias[1024:, 2048:] = -np.inf
    elif case == "all_finite":
        bias = np.random.default_rng(3).normal(size=(1, 1, 130, 130)).astype(np.float32)
    else:
        bias = np.full((1, 1), -np.inf, np.float32)
    got = pt_attn.blank_tile_map_reference(torch.from_numpy(bias))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _brute_map(bias))
    if case == "pyramid_512":
        assert abs(got.float().mean().item() - 0.342) < 1e-3
