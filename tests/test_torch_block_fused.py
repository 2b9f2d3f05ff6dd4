"""Port parity, fused ViT sublayers: the plain versions of kernels #7
(``attn_sublayer_fused``), #8 (``mlp_sublayer_fused``) and #10
(``fused_mlp``) in ``imagefolder_tpu_torch/ops/cuda/block.py`` against the
JAX package on the CPU, their gradients against ``jax.vjp`` of its XLA
mirrors, and the routing that ``Block`` and ``set_fused_sublayers`` give.

#7 and #8 are held against the Pallas kernels themselves in interpret mode
(``_attn_sublayer_fused(..., interpret=True)``,
``_mlp_sublayer_fused(..., blk=8, interpret=True)``) at (2, 20, 64) with 4
heads: N = 20 is not a multiple of 8, so #7's zeroed padding rows are
crossed, and #8 runs three row blocks. #10 lives inside
``scripts/perf.py::probe_mlp`` and cannot be imported; its body
(``perf.py:241-249``) is transcribed below. The CUDA kernels never run
here: on a CPU tensor each wrapper takes its plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.ops.activations import gelu_exact as jax_gelu_exact
from imagefolder_tpu.ops.pallas.block import (
    _attn_sublayer_fused,
    _attn_sublayer_xla,
    _mlp_sublayer_fused,
    _mlp_sublayer_xla,
)
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.ops.cuda import attention as pt_attn
from imagefolder_tpu_torch.ops.cuda import block as pt_block
from tests._torch_parity import one_torch_thread  # noqa: F401


B, N, C, HEADS, HID = 2, 20, 64, 4, 256
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _params(seed: int, hidden: int = 3 * C):
    """xn, res and one sublayer's parameters in the flax (in, out) layout,
    LayerScale of order 1 so that the sublayer moves the output."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"xn": rng.normal(size=(B, N, C)).astype(f32),
         "res": rng.normal(size=(B, N, C)).astype(f32),
         "w1": rng.uniform(-C ** -0.5, C ** -0.5, (C, hidden)).astype(f32),
         "b1": rng.normal(0, 0.1, hidden).astype(f32),
         "w2": rng.uniform(-C ** -0.5, C ** -0.5, (hidden if hidden != 3 * C else C, C)
                           ).astype(f32),
         "b2": rng.normal(0, 0.1, C).astype(f32),
         "ls": rng.uniform(0.5, 1.0, C).astype(f32)}
    return p


def _launches():
    return (pt_block.SUBLAYER_ATTN_LAUNCHES, pt_block.SUBLAYER_MLP_LAUNCHES,
            pt_block.FUSED_MLP_LAUNCHES, pt_attn.LAUNCHES, pt_attn.BWD_LAUNCHES)


def _check_bf16(got: np.ndarray, want: np.ndarray, res: np.ndarray, ls: np.ndarray):
    """Every element's bf16 error within ls * (2^-6 |y| + 2^-6 RMS(y's row))
    + 2^-20 |out|, with y = (want - res) / ls the sublayer's bf16 output: two
    roundings of y (the product's and the bias add's) may each land one bf16
    ulp (<= 2^-7 |y|) apart on the two sides, a rounding flip inside (a qkv,
    o or h element) moves y by a small share of its row's RMS, and the last
    term covers the fp32 residual add."""
    y = (want - res) / ls
    rms = np.sqrt(np.mean(y ** 2, axis=-1, keepdims=True))
    bound = ls * (2.0 ** -6 * np.abs(y) + 2.0 ** -6 * rms) + 2.0 ** -20 * np.abs(want)
    worst = float(np.max(np.abs(got - want) / bound))
    assert worst <= 1.0, worst
    return worst


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("res_dtype", ["float32", "act"])
def test_attn_sublayer_plain_matches_pallas(dtype, res_dtype):
    jd, td = DTYPES[dtype]
    p = _params(0)
    res_j = jnp.asarray(p["res"]) if res_dtype == "float32" else jnp.asarray(p["res"], jd)
    want = np.asarray(_attn_sublayer_fused(
        jnp.asarray(p["xn"], jd), res_j, jnp.asarray(p["w1"], jd), jnp.asarray(p["b1"]),
        jnp.asarray(p["w2"], jd), jnp.asarray(p["b2"]), jnp.asarray(p["ls"]), heads=HEADS,
        interpret=True))
    res_t = torch.from_numpy(np.array(res_j.astype(jnp.float32))).to(
        torch.float32 if res_dtype == "float32" else td)
    args = (torch.from_numpy(p["xn"]).to(td), res_t, torch.from_numpy(p["w1"].T),
            torch.from_numpy(p["b1"]), torch.from_numpy(p["w2"].T), torch.from_numpy(p["b2"]),
            torch.from_numpy(p["ls"]))
    before = _launches()
    got = pt_block.attn_sublayer_fused(*args, HEADS)
    plain = pt_block.attn_sublayer_fused_reference(*args, HEADS)
    assert _launches() == before  # the CPU launches nothing
    assert got.dtype == torch.float32 and got.shape == (B, N, C)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    if dtype == "float32":
        # fp32 on both sides, summation order only; |out| <~ 5
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        _check_bf16(got.numpy(), want, res_t.float().numpy(), p["ls"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_sublayer_plain_matches_pallas(dtype):
    jd, td = DTYPES[dtype]
    p = _params(1, HID)
    want = np.asarray(_mlp_sublayer_fused(
        jnp.asarray(p["xn"], jd), jnp.asarray(p["res"]), jnp.asarray(p["w1"], jd),
        jnp.asarray(p["b1"]), jnp.asarray(p["w2"], jd), jnp.asarray(p["b2"]),
        jnp.asarray(p["ls"]), blk=8, interpret=True))
    args = (torch.from_numpy(p["xn"]).to(td), torch.from_numpy(p["res"]),
            torch.from_numpy(p["w1"].T), torch.from_numpy(p["b1"]), torch.from_numpy(p["w2"].T),
            torch.from_numpy(p["b2"]), torch.from_numpy(p["ls"]))
    before = _launches()
    got = pt_block.mlp_sublayer_fused(*args)
    assert _launches() == before
    torch.testing.assert_close(got, pt_block.mlp_sublayer_fused_reference(*args), rtol=0,
                               atol=0)
    if dtype == "float32":
        # fp32, summation order and the A&S erf (<= 1.5e-7) of the JAX GELU
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        _check_bf16(got.numpy(), want, p["res"], p["ls"])


def _perf_mlp(x, w1, b1, w2, b2):
    """scripts/perf.py:241-249 (``_mlp_kernel``'s body), transcribed:
    fp32 accumulators, fp32 biases, GELU with the A&S erf before the cast.
    ``gelu_exact`` on an fp32 input is perf.py's ``_gelu_exact`` (the same
    A&S expansion)."""
    h = jax.lax.dot_general(x, w1, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    h = h + b1
    h = jax_gelu_exact(h).astype(x.dtype)
    o = jax.lax.dot_general(h, w2, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return (o + b2).astype(x.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_mlp_plain_matches_perf_probe(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    m, d, hid = 45, 64, 256
    x = rng.normal(size=(m, d)).astype(np.float32)
    w1 = (rng.normal(size=(d, hid)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(hid, d)) * 0.1).astype(np.float32)
    b1 = rng.normal(0, 0.1, hid).astype(np.float32)
    b2 = rng.normal(0, 0.1, d).astype(np.float32)
    want = np.asarray(_perf_mlp(jnp.asarray(x, jd), jnp.asarray(w1, jd), jnp.asarray(b1),
                                jnp.asarray(w2, jd), jnp.asarray(b2)).astype(jnp.float32))
    got = pt_block.fused_mlp(torch.from_numpy(x).to(td), torch.from_numpy(w1.T),
                             torch.from_numpy(b1), torch.from_numpy(w2.T), torch.from_numpy(b2))
    assert got.dtype == td and got.shape == (m, d)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        # one rounding of o (<= 2^-8 |o|, one ulp apart at most) and
        # rounding flips of h elements, a small share of the row's RMS
        rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 2.0 ** -5 * rms)


@pytest.mark.parametrize("which", ["attn", "mlp"])
def test_fused_sublayer_gradients_match_jax_vjp(which):
    """Autograd of the fused sublayer (its backward recomputes through the
    composed path) against jax.vjp of the XLA mirror, every input's
    gradient, fp32."""
    p = _params(3, 3 * C if which == "attn" else HID)
    g = np.random.default_rng(4).normal(size=(B, N, C)).astype(np.float32)
    names = ["xn", "res", "w1", "b1", "w2", "b2", "ls"]
    jargs = [jnp.asarray(p[k]) for k in names]
    f = (lambda *a: _attn_sublayer_xla(*a, HEADS)) if which == "attn" else _mlp_sublayer_xla

    @jax.jit
    def out_and_vjp(g, *a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(g)

    out, want = out_and_vjp(jnp.asarray(g), *jargs)
    targs = [torch.from_numpy(p[k].T.copy() if k in ("w1", "w2") else p[k]).requires_grad_()
             for k in names]
    fused = pt_block.attn_sublayer_fused if which == "attn" else pt_block.mlp_sublayer_fused
    got = fused(*targs, HEADS) if which == "attn" else fused(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    got.backward(torch.from_numpy(g))
    for k, t, w in zip(names, targs, want):
        mine = t.grad.numpy().T if k in ("w1", "w2") else t.grad.numpy()
        # fp32 summation order; gradients are O(1-10) over 40 rows
        np.testing.assert_allclose(mine, np.asarray(w), rtol=0, atol=2e-4, err_msg=k)


def _block(seed: int = 5, fuse=(False, False)) -> pt_vit.Block:
    torch.manual_seed(seed)
    blk = pt_vit.Block(C, HEADS, init_values=0.7, fuse_attn=fuse[0], fuse_mlp=fuse[1],
                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            lin.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed))
    return blk


@pytest.mark.parametrize("fuse", [(True, False), (False, True), (True, True)])
def test_block_fused_equals_composed(fuse):
    """On the CPU the fused sublayers' plain versions are the composed path's
    ops: a Block with the flags on gives the same bits, forward and
    gradients, and launches nothing."""
    x = torch.randn(B, N, C, generator=torch.Generator().manual_seed(6))
    before = _launches()
    results = []
    for flags in ((False, False), fuse):
        blk = _block(fuse=flags)  # the same weights from the same seed
        assert (blk.fuse_attn, blk.fuse_mlp) == flags
        xx = x.clone().requires_grad_()
        out = blk(xx)
        out.square().sum().backward()
        results.append((out.detach(), xx.grad, [p.grad.clone() for p in blk.parameters()]))
    assert _launches() == before
    (o0, gx0, gp0), (o1, gx1, gp1) = results
    assert torch.equal(o0, o1) and torch.equal(gx0, gx1)
    for a, b in zip(gp0, gp1):
        assert torch.equal(a, b)


def test_fused_sublayers_backward_under_activation_checkpointing():
    """A ViT with ``remat`` (each block recomputed in the backward, as the
    flagship GAN recipe trains) and both fused sublayers on: the backward
    reads each fused sublayer's saved inputs once (activation checkpointing
    refuses a second read), and forward and gradients equal the composed
    path's without remat, bit for bit."""
    img = torch.rand(B, 32, 32, 3, generator=torch.Generator().manual_seed(9)) * 2 - 1
    results = []
    for remat, fused in ((False, False), (True, True)):
        vit = pt_vit.ViTBackbone(img_size=32, patch_size=8, embed_dim=C, depth=2,
                                 num_heads=HEADS, remat=remat,
                                 generator=torch.Generator().manual_seed(10))
        assert pt_vit.set_fused_sublayers(vit, fused, fused) == 2
        out = vit(img)
        out.square().sum().backward()
        results.append((out.detach(), [p.grad for p in vit.parameters()]))
    (o0, g0), (o1, g1) = results
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_router_keeps_masked_and_long_attention_composed(monkeypatch):
    """The fused attention is taken only with no mask and N * N within
    ``_SINGLE_MAX_ELEMS`` (the JAX router's contract); the fused MLP at any N."""
    calls = []
    real_attn, real_mlp = pt_block.attn_sublayer_fused, pt_block.mlp_sublayer_fused
    monkeypatch.setattr(pt_block, "attn_sublayer_fused",
                        lambda *a: calls.append("attn") or real_attn(*a))
    monkeypatch.setattr(pt_block, "mlp_sublayer_fused",
                        lambda *a: calls.append("mlp") or real_mlp(*a))
    p = _params(7)
    t = {k: torch.from_numpy(v.T.copy() if k in ("w1", "w2") else v) for k, v in p.items()}
    args = (t["xn"], t["res"], t["w1"], t["b1"], t["w2"], t["b2"], t["ls"], HEADS)
    mask = torch.zeros(1, 1, N, N)
    mask[..., :N - 4, N - 4:] = float("-inf")
    pt_block.attn_sublayer(*args, mask=mask, fused=True)
    pt_block.attn_sublayer(*args, fused=False)
    assert calls == []
    pt_block.attn_sublayer(*args, fused=True)
    assert calls == ["attn"]
    monkeypatch.setattr(pt_attn, "_SINGLE_MAX_ELEMS", N * N - 1)
    pt_block.attn_sublayer(*args, fused=True)  # past the budget: composed
    assert calls == ["attn"]
    h = torch.randn(C, HID)
    pt_block.mlp_sublayer(t["xn"], t["res"], h.T, torch.zeros(HID), h, torch.zeros(C), t["ls"],
                          fused=True)
    assert calls == ["attn", "mlp"]


TINY = "tiny_fused_vit"


def test_decode_tokens_with_fused_sublayers_equals_default():
    """``set_fused_sublayers`` on a tokenizer: every LayerScale block of the
    encoder and decoder, and the same decode on the CPU, launching nothing."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pt_vit.VIT_PRESETS, TINY, dict(embed_dim=C, depth=2, num_heads=HEADS))
        cfg = ModelArgs(codebook_size=64, codebook_embed_dim=8, v_patch_nums=(4,),
                        enc_type="dinov2", dec_type="dinov2", encoder_model=TINY,
                        decoder_model=TINY, semantic_guide="none", detail_guide="none",
                        num_latent_tokens=16, abs_pos_embed=True, image_size=64)
        gen = torch.Generator().manual_seed(8)
        model = VQModel(cfg, generator=gen, device="cpu").eval()
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, pt_vit.LayerScale):
                    mod.gamma.uniform_(0.5, 1.0, generator=gen)
        tokens = torch.randint(0, 64, (2, 16), generator=gen)
        img = torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
        with torch.no_grad():
            want = model.decode_tokens(tokens), model.img_to_reconstructed_img(img)
            assert pt_vit.set_fused_sublayers(model, True, True) == 4
            blocks = [b for b in model.modules() if isinstance(b, pt_vit.Block)]
            assert all(b.fuse_attn and b.fuse_mlp for b in blocks)
            before = _launches()
            got = model.decode_tokens(tokens), model.img_to_reconstructed_img(img)
            assert _launches() == before
            assert pt_vit.set_fused_sublayers(model, False, False) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_block_without_layerscale_never_fuses():
    blk = pt_vit.Block(C, HEADS, init_values=None)
    assert pt_vit.set_fused_sublayers(blk, True, True) == 0
    assert not (blk.fuse_attn or blk.fuse_mlp)
    for flags in ((True, False), (False, True)):
        with pytest.raises(ValueError, match="never fuses"):
            pt_vit.Block(C, HEADS, init_values=None, fuse_attn=flags[0], fuse_mlp=flags[1])


def test_kernel_wrappers_refuse_before_launching():
    """The card wrappers' checks run before any launch: widths that are not
    multiples of 64, a head dim other than 64, and tensors on two devices."""
    xn = torch.zeros(2, 5, 96)
    with pytest.raises(ValueError, match="multiples of 64"):
        pt_block._mlp_sublayer_cuda(xn, xn, torch.zeros(384, 96), torch.zeros(384),
                                    torch.zeros(96, 384), torch.zeros(96), torch.zeros(96))
    with pytest.raises(ValueError, match="multiples of 64"):
        pt_block._fused_mlp_cuda(torch.zeros(7, 64), torch.zeros(100, 64), torch.zeros(100),
                                 torch.zeros(64, 100), torch.zeros(64))
    x = torch.zeros(2, 5, 128)
    with pytest.raises(NotImplementedError, match="head dim"):
        pt_block._attn_sublayer_cuda(x, x, torch.zeros(384, 128), torch.zeros(384),
                                     torch.zeros(128, 128), torch.zeros(128), torch.zeros(128),
                                     4)
    meta = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        pt_block._fused_mlp_cuda(torch.zeros(7, 64), torch.zeros(64, 64), torch.zeros(64),
                                 torch.zeros(64, 64), meta)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pt_block._fused_mlp_cuda(torch.zeros(7, 64, dtype=torch.float16), torch.zeros(64, 64),
                                 torch.zeros(64), torch.zeros(64, 64), torch.zeros(64))
