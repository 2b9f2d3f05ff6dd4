"""``chip_smoke.py``'s bf16 check of the fused sublayers (``_sublayer_check``,
#7 attention and #8 MLP) against a model of the kernels' numerics, on the
CPU.

The kernels cannot run here, so a plain PyTorch model of their numerics
stands in for them: each GEMM's fp32 sum in 64-wide k-tiles (the wgmma
GEMM's k-tile, ``csrc/gemm_epilogue.cuh``'s kBK), rounded to bf16 before
its bias add (the Dense epilogue), GELU in fp32 rounded to bf16,
LayerScale and the fp32 residual add in the last epilogue; #7's
attention as #1's tiles (64 keys, an online max and row sum in fp32, p
rounded against the running max before p v, o / l at the end). The check
must pass that model at #7's decoder shape (N = 514, the last k/v tile
holds 2 keys) and #8's encoder shape (N = 513, the last 128-row tile is
partly filled), and fail it once a fault is planted in it: the last k/v
tile or a GEMM's last k-tile dropped, the bias omitted, LayerScale
skipped, or the last partial row tile left unstored.
"""

from __future__ import annotations

import functools

import pytest
import torch

import chip_smoke as cs
from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda import block
from tests._torch_parity import one_torch_thread  # noqa: F401


K_STEP, ROW_TILE, KV_TILE = 64, 128, 64


def _attention(qkv, heads, fault=None):
    """#1's tiled attention over packed (B, N, 3C) qkv, no bias."""
    b, n, c3 = qkv.shape
    q, k, v = (t.float().transpose(1, 2) for t in qkv.view(b, n, 3, heads, -1).unbind(2))
    scale = q.shape[-1] ** -0.5
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    tiles = list(range(0, n, KV_TILE))
    if fault == "last k/v tile dropped":
        tiles = tiles[:-1]
    for k0 in tiles:
        s = q @ k[:, :, k0:k0 + KV_TILE].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ v[:, :, k0:k0 + KV_TILE]
        m = m_new
    return (o / l[..., None]).to(qkv.dtype).transpose(1, 2).reshape(b, n, c3 // 3)


def _dense(x, w, b, fault=None):
    """A GEMM with the Dense epilogue: fp32 sums over 64-wide k-tiles in
    order, rounded to x's dtype, then + b in x's dtype."""
    wt = w.to(x.dtype)
    steps = list(range(0, x.shape[-1], K_STEP))
    if fault == "last k-step dropped":
        steps = steps[:-1]
    acc = torch.zeros(x.shape[:-1] + (w.shape[0],))
    for k0 in steps:
        acc += x[..., k0:k0 + K_STEP].float() @ wt[:, k0:k0 + K_STEP].float().T
    acc = acc.to(x.dtype)
    return acc if fault == "bias omitted" else acc + b.to(x.dtype)


def _ls_res(res, ls, y, fault):
    """The LayerScale and fp32 residual epilogue, with its row tiles."""
    out = res.float() + (1.0 if fault == "LayerScale skipped" else ls) * y.float()
    if fault == "last row tile unstored":
        flat = out.view(-1, out.shape[-1])
        flat[flat.shape[0] // ROW_TILE * ROW_TILE:] = 0.0
    return out


def _gemm_fault(fault, which):
    if fault == f"{which} GEMM's last k-step dropped":
        return "last k-step dropped"
    return fault if which == "second" and fault == "bias omitted" else None


def _attn_model(xn, res, wq, bq, wp, bp, ls, heads, fault=None):
    o = _attention(_dense(xn, wq, bq, _gemm_fault(fault, "first")), heads, fault)
    return _ls_res(res, ls, _dense(o, wp, bp, _gemm_fault(fault, "second")), fault)


def _mlp_model(xn, res, w1, b1, w2, b2, ls, fault=None):
    h = gelu_exact(_dense(xn, w1, b1, _gemm_fault(fault, "first")))
    return _ls_res(res, ls, _dense(h, w2, b2, _gemm_fault(fault, "second")), fault)


@functools.cache
def _sublayer_case(kind, res):
    """(model, operands, plain output) at #7's decoder shape (N = 514: the
    last k/v tile holds 2 keys) or #8's encoder shape (N = 513: the last
    128-row tile is partly filled), B = 2, bf16, from a seed."""
    gen = torch.Generator().manual_seed(1)
    res = {"fp32": torch.float32, "0": None}[res]
    if kind == "#7":
        ops = cs._sublayer_operands(gen, 2, 514, 768, 3 * 768, torch.bfloat16,
                                    torch.device("cpu"), res)
        model = functools.partial(_attn_model, heads=cs.HEADS)
        want = block.attn_sublayer_fused_reference(*ops, cs.HEADS)
    else:
        ops = cs._sublayer_operands(gen, 2, 513, 768, 3072, torch.bfloat16,
                                    torch.device("cpu"), res)
        model, want = _mlp_model, block.mlp_sublayer_fused_reference(*ops)
    return model, ops, want


@pytest.mark.parametrize("res", ["fp32", "0"])
@pytest.mark.parametrize("kind", ["#7", "#8"])
def test_sublayer_check_passes_the_tiled_numerics(kind, res):
    model, ops, want = _sublayer_case(kind, res)
    err, note = cs._sublayer_check(kind, model(*ops), want, ops[1], ops[-1], torch.bfloat16)
    worst = float(note.split("per element ")[1].split(" ")[0])
    assert err > 0  # the model is not the plain version
    assert worst <= 0.75, note  # a margin of at least 1/0.75 under the bound


SUBLAYER_FAULTS = ["first GEMM's last k-step dropped", "second GEMM's last k-step dropped",
                   "bias omitted", "LayerScale skipped", "last row tile unstored"]


@pytest.mark.parametrize("case", [("#7", "last k/v tile dropped")]
                         + [(kind, f) for kind in ("#7", "#8") for f in SUBLAYER_FAULTS])
def test_sublayer_check_fails_a_planted_fault(case):
    kind, fault = case
    model, ops, want = _sublayer_case(kind, "fp32")
    with pytest.raises(AssertionError, match="of its bound"):
        cs._sublayer_check(kind, model(*ops, fault=fault), want, ops[1], ops[-1],
                           torch.bfloat16)
