"""The bf16 backward of #6 and #5 at head dims 72-128 on wgmma
(``csrc/attention_bwd_sm90.cuh`` at kD = 128), modelled on the CPU and held
against the JAX package.

On the card these widths run the kD = 128 instantiations: each q, k, v and
g tile is two 64-wide halves, zero past hd; the score products run
ceil(hd / 16) K-steps and the gradient products the head's width. The
arithmetic is the wgmma backward's at 48 and 64: lse from the forward,
delta = rowsum(o g), p = exp(s - lse), bf16(p) for dv, bf16(ds) for dk and
dq, fp32 sums, the tiles that the blank-tile map marks never visited. Here
``sm90_model`` runs it on tiles zero-padded to 128 (``pad_head``), fed #3's
o and lse from the two-pass forward's model for #6 and the plain o and lse
for #5, against ``_fused_attention_bwd_impl`` and
``_fused_attention_qblk_bwd`` in Pallas's interpreter, within 2e-2 of each
JAX gradient's max abs (the card's bound); a tile wrongly skipped must
miss it. Also here: what the wrappers pass to the C entries at these
widths (``_launch`` recorded): o, lse and kd 128 for a bf16 call without
dbias at L > 1, neither for dbias, L = 1 or fp32.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagefolder_tpu.ops.pallas import attention as jax_attn
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from test_torch_attention_bwd_sm90 import sm90_model
from test_torch_bnhd_sm90 import fwd_sm90_model
from tests._torch_parity import one_torch_thread  # noqa: F401


TOL = 2e-2  # chip_smoke.py's bf16 bound: of the plain result's max abs
L = 130  # three 64-row tiles, the last two rows; under the causal mask 3 of 9 blank


def _causal(l: int) -> np.ndarray:
    """RAR's training mask: (1, 1, l, l), -inf above the diagonal."""
    return np.triu(np.full((l, l), -np.inf, np.float32), 1)[None, None]


@functools.cache
def _case(kernel: str, hd: int, bias_kind: str):
    """(model arguments, JAX gradients as fp32 numpy) for B = 1, H = 2 at
    head dim hd: #6 on the forward model's o and lse, #5 on the plain ones."""
    rng = np.random.default_rng(hd)
    q, k, v, g = (rng.normal(size=(1, L, 2, hd)).astype(np.float32) for _ in range(4))
    bias = _causal(L) if bias_kind == "causal" else None
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    scale = 1.0 / np.sqrt(hd)
    if kernel == "#6":
        o, lse = fwd_sm90_model(tq, tk, tv, tb, scale)
        jax_bwd = jax_attn._fused_attention_bwd_impl
    else:
        o = pt_attn.fused_attention_qblk_reference(tq, tk, tv, tb, scale)
        lse = pt_attn.attention_lse_reference(tq, tk, tb, scale)
        jax_bwd = jax_attn._fused_attention_qblk_bwd
    want = jax_bwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                   None if bias is None else jnp.asarray(bias), jnp.asarray(g, jnp.bfloat16),
                   interpret=True)[:3]
    return (tq, tk, tv, tg, tb, scale, o, lse), [np.asarray(w.astype(jnp.float32)) for w in want]


def _worst(got, want) -> float:
    """The largest of the gradients' max abs errors over their JAX max abs."""
    errs = []
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape and np.isfinite(w).all()
        errs.append(np.abs(a.float().numpy() - w).max() / np.abs(w).max())
    return max(errs)


@pytest.mark.parametrize("bias_kind", ["none", "causal"])
@pytest.mark.parametrize("kernel,hd", [("#6", 80), ("#6", 88), ("#6", 128), ("#5", 80)])
def test_model_matches_pallas_at_head_dims_72_to_128(kernel, hd, bias_kind):
    """#6 at RAR-XL's 80, RAR-XXL's 88 and 128, and #5 at 80: the model on
    tiles zero-padded to 128 against the Pallas backward on the unpadded
    inputs, with no bias and under the causal mask, within the card's
    bound; the gradients come back hd wide."""
    args, want = _case(kernel, hd, bias_kind)
    assert _worst(sm90_model(*args), want) <= TOL


def test_model_with_a_skipped_tile_fails_at_head_dim_80():
    """The bound has teeth at 80: the model with one tile that the causal
    mask leaves (64 q rows against the first 64 keys) wrongly skipped
    misses it by a wide margin."""
    args, want = _case("#6", 80, "causal")
    assert not pt_attn.blank_tile_map_reference(args[4])[1, 0]
    assert _worst(sm90_model(*args, skip=((1, 0),)), want) > 5 * TOL


def _recorded(monkeypatch) -> list:
    """``_launch`` replaced by a recorder of (what, C entry arguments)."""
    calls = []
    monkeypatch.setattr(pt_attn, "_launch", lambda what, entry, device, *args: calls.append(
        (what, args)))
    return calls


def _operands(hd: int, l: int, dtype):
    gen = torch.Generator().manual_seed(hd + l)
    q, k, v, g, o = (torch.randn((1, l, 2, hd), generator=gen).to(dtype) for _ in range(5))
    bias = torch.from_numpy(_causal(l))
    return q, k, v, g, o, torch.zeros((1, 2, l)), bias


BWD = (("fused_attention backward", pt_attn._fused_attention_bwd_cuda),
       ("fused_attention_qblk backward", pt_attn._fused_attention_qblk_bwd_cuda))


@pytest.mark.parametrize("hd", [80, 88, 128])
def test_bf16_calls_at_72_to_128_pass_o_and_lse(hd, monkeypatch):
    """A bf16 call at 80, 88 or 128 with L > 1 and no dbias gives #6's and
    #5's C entries the forward's o and lse (and the blank-tile map's
    scratch, under a bias), bf16 and kd 128: the wgmma backward."""
    calls = _recorded(monkeypatch)
    q, k, v, g, o, lse, bias = _operands(hd, 70, torch.bfloat16)
    for _, bwd in BWD:
        bwd(q, k, v, bias, g, 0.125, False, o=o, lse=lse)
    assert [w for w, _ in calls] == [w for w, _ in BWD]
    for _, args in calls:
        assert args[4:6] == (o.data_ptr(), lse.data_ptr()) and args[12] is not None
        assert args[-3:] == (1, hd, 128)


def test_direct_bf16_call_at_80_runs_the_forward_first(monkeypatch):
    """A direct bf16 call at 80 without o and lse runs #3 first, with its lse
    store, and hands the backward what that launch wrote."""
    calls = _recorded(monkeypatch)
    q, k, v, g, _, _, bias = _operands(80, 70, torch.bfloat16)
    pt_attn._fused_attention_bwd_cuda(q, k, v, bias, g, 0.125, False)
    assert [w for w, _ in calls] == ["fused_attention", "fused_attention backward"]
    fwd, bwd = calls[0][1], calls[1][1]
    assert fwd[5] is not None and bwd[4:6] == (fwd[4], fwd[5])


@pytest.mark.parametrize("case", ["dbias", "L=1", "fp32"])
def test_dbias_l1_and_fp32_calls_pass_neither(case, monkeypatch):
    """A call that asks for dbias, #6 at L = 1, and fp32 keep the two-kernel
    design: their C entries get no o, no lse and no blank-tile map."""
    calls = _recorded(monkeypatch)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v, g, o, lse, bias = _operands(80, 1 if case == "L=1" else 70, dtype)
    for _, bwd in BWD[:1] if case == "L=1" else BWD:
        bwd(q, k, v, bias, g, 0.125, case == "dbias", o=o, lse=lse)
    assert len(calls) == (1 if case == "L=1" else 2)
    for _, args in calls:
        assert args[4:6] == (None, None) and args[12] is None and args[-1] == 128
