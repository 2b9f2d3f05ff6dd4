"""``chip_smoke.py``'s bf16 forward check (``_fwd_check``) against a model of
the attention kernels' numerics, on the CPU.

The kernels cannot run here, so a plain PyTorch model of their tiled
numerics stands in for them: 64-key tiles, an online max and row sum in
fp32, p rounded to bf16 against the running max before p v, o / l at the
end (#1 and #4), or two passes with p / l rounded (#3). The check must pass
that model at the 512 px shapes and past the JAX package's caps, and fail
it once a fault is planted in it: the last k/v tile dropped (a ragged-tail
fault), or the running max's rescale skipped.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke as cs
from imagefolder_tpu_torch.models.var import build_attn_bias
from imagefolder_tpu_torch.ops.cuda import attention as attn
from tests._torch_parity import one_torch_thread  # noqa: F401


TILE = 64


def _scores(qf, kf, bias, scale, k0):
    s = qf @ kf[:, :, k0:k0 + TILE].transpose(-1, -2) * scale
    return s if bias is None else s + bias[..., k0:k0 + TILE].float()


def _tiled_after(q, k, v, bias, scale, fault=None):
    """#1/#4's numerics: online softmax over 64-key tiles, o / l at the end."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    m = torch.full(qf.shape[:3], float("-inf"))
    l = torch.zeros(qf.shape[:3])
    o = torch.zeros(qf.shape)
    tiles = list(range(0, kf.shape[2], TILE))
    if fault == "last tile dropped":
        tiles = tiles[:-1]
    for k0 in tiles:
        s = _scores(qf, kf, bias, scale, k0)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.ones_like(m) if fault == "rescale skipped" else torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + TILE]
        m = m_new
    return (o / l[..., None]).to(q.dtype).transpose(1, 2).contiguous()


def _tiled_before(q, k, v, bias, scale, fault=None):
    """#3's numerics: a pass for the max and the row sum, then p / l rounded
    to bf16 before p v, over 64-key tiles."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    tiles = list(range(0, kf.shape[2], TILE))
    m = torch.full(qf.shape[:3], float("-inf"))
    l = torch.zeros(qf.shape[:3])
    for k0 in tiles:
        s = _scores(qf, kf, bias, scale, k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    if fault == "last tile dropped":
        tiles = tiles[:-1]
    o = torch.zeros(qf.shape)
    for k0 in tiles:
        p = torch.exp(_scores(qf, kf, bias, scale, k0) - m[..., None]) / l[..., None]
        o = o + p.bfloat16().float() @ vf[:, :, k0:k0 + TILE]
    return o.to(q.dtype).transpose(1, 2).contiguous()


def _case(name):
    """(model, plain version, q, k, v, bias, scale) at one head of a path's
    shape, from a seed."""
    gen = torch.Generator().manual_seed(0)
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    after = (_tiled_after, attn.fused_attention_qblk_reference)
    if name == "VAR teacher forcing 512":
        return (*after, *cs._bnhd(gen, 1, 2240, 2240, 1, bf16, cpu),
                build_attn_bias(cs.PNS512), 1.0)
    if name == "decoder 512 packed views":
        return (*after, *cs._packed_views(gen, 1, 2050, 1, bf16, cpu), None, 0.125)
    if name == "ragged L=2049, bias":
        return (*after, *cs._bnhd(gen, 1, 2049, 2049, 1, bf16, cpu),
                cs.encoder_mask(2049, 683, cpu, 1), 1.0)
    if name == "ragged L=2817, no bias":
        return (*after, *cs._bnhd(gen, 1, 2817, 2817, 1, bf16, cpu, l2=False), None, 0.125)
    if name == "#1 encoder, -inf first tiles":
        return (*after, *cs._packed_views(gen, 2, 513, 1, bf16, cpu),
                cs.encoder_mask(513, 256, cpu, 128), 0.125)
    if name == "#3 last 256 px sampling stage":
        return (_tiled_before, attn.fused_attention_reference,
                *cs._bnhd(gen, 4, 121, 286, 1, bf16, cpu), None, 1.0)
    if name == "#3 512 px last sampling stage":
        return (_tiled_before, attn.fused_attention_reference,
                *cs._bnhd(gen, 1, 1024, 2240, 1, bf16, cpu), None, 1.0)
    raise KeyError(name)


CASES = ["VAR teacher forcing 512", "decoder 512 packed views", "ragged L=2049, bias",
         "ragged L=2817, no bias", "#1 encoder, -inf first tiles",
         "#3 last 256 px sampling stage", "#3 512 px last sampling stage"]


@pytest.mark.parametrize("name", CASES)
def test_fwd_check_passes_the_tiled_numerics(name):
    model, plain, q, k, v, bias, scale = _case(name)
    err, note = cs._fwd_check(name, model(q, k, v, bias, scale), plain(q, k, v, bias, scale))
    worst = float(note.split("per element ")[1].split(" ")[0])
    assert err > 0 or "sampling" in name  # the model is not the plain version
    assert worst <= 0.6, note  # a margin of at least 1/0.6 under the bound


@pytest.mark.parametrize("fault", ["last tile dropped", "rescale skipped"])
@pytest.mark.parametrize("name", CASES)
def test_fwd_check_fails_a_planted_fault(name, fault):
    model, plain, q, k, v, bias, scale = _case(name)
    if fault == "rescale skipped" and model is _tiled_before:
        fault = "last tile dropped"  # #3 has no running rescale
    with pytest.raises(AssertionError):
        cs._fwd_check(name, model(q, k, v, bias, scale, fault), plain(q, k, v, bias, scale))


def test_fwd_check_bound_alone_catches_a_ragged_tail():
    """At L = 2049 the last tile holds one key: dropping it stays inside
    TOL's 2e-2 max abs, and only the per-element bound catches it."""
    model, plain, q, k, v, bias, scale = _case("ragged L=2049, bias")
    got, want = model(q, k, v, bias, scale, "last tile dropped"), plain(q, k, v, bias, scale)
    assert (got.float() - want.float()).abs().max().item() <= cs.TOL[torch.bfloat16]
    with pytest.raises(AssertionError, match="of its bound"):
        cs._fwd_check("ragged L=2049, bias", got, want)
