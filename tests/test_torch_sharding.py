"""The port's sharded steps (``parallel/mesh.py``): the counterparts of
tests/test_sharding.py's four tests and the tensor parallelism of the
tokenizer's ViTs, RAR and MaskGIT, on four gloo processes on the CPU
against one process on the whole batch (``tests/_torch_sharding_worker.py``
runs both at once), B = 8:

- the GAN step on a 2 x 2 data x fsdp mesh at test_sharding.py's CNN
  tokenizer (32 px, PatchGAN, the adaptive weight), the tokenizer and its
  EMA split by the JAX rule at min_size 2^10 (one step: the first lr of both
  schedules is 0, so it checks the gradients and moments; the parameters
  move on the next step, whose Adam update magnifies the fp32 reorderings
  of near-zero gradient entries past 1e-6);
- the same step's layout: each split parameter's local tensor holds 1/2 of
  it, the EMA is placed like the parameters, every gathered copy is freed;
- VAR-d2 (width 64, 2 heads) on a data-only mesh of 4, and on a 2 x 2 data
  x model mesh under ``tp_shard_params`` (10 parameters split), two steps
  each, EMA on;
- the flagship GAN recipe at a tiny ViT width (4 heads of 16, remat, the
  frozen DINOv2 teacher, linear ToPixel) with PatchGAN on data x model
  under ``tp_shard_params`` (one step), and the tokenizer's encoder and
  decoder with the fused sublayers on (#7's plain version under TP);
- the RAR and MaskGIT trainers (width 64, 4 heads, 2 blocks) on data x
  fsdp and data x model, two steps each (one for ImageBert, whose qkv
  bias's key third has a gradient of 0 in exact arithmetic: see the
  GAN step's);
- the tiny ViT tokenizer's GAN step with ``grad_accum_steps=2`` on data x
  fsdp over two updates, and the same run resumed mid-accumulation from a
  ``state_dict``, bit-equal to the straight run;
- ``rar_generate`` on a RAR split over the model axis, its Gumbel draws
  given: the unsharded tokens.

Tolerances: every tensor the steps leave (parameters, buffers, gradients,
Adam's moments, EMAs, usage, LeCam, metrics) within 1e-6 of its max abs (1e-6
absolute under a max of 1), as test_torch_data_parallel.py's TOL, and 1e-5
under tensor parallelism, whose row layers sum their products in two
halves; loss and acc_mean within test_sharding.py's rtol of 1e-4. The
four processes hold the same whole tensors bit for bit.

The placement rules are held to the JAX package's: ``fsdp_shard_params``
and ``tp_shard_params`` of imagefolder_tpu/parallel/mesh.py on the
conftest's 8 virtual devices, each parameter's sharded flax dimension
carried to the port's name and torch dimension through the converter
(``utils/convert.py``, and the LoRA adapters through test_torch_lora.py's
bridge), on marker arrays that vary along that dimension, for every model
family the JAX TP rule reaches.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import build_maskgit as jax_build_maskgit
from imagefolder_tpu.models import build_rar as jax_build_rar
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.models.var import VAR as JaxVAR
from imagefolder_tpu.models.var import VARConfig as JaxVARConfig
from imagefolder_tpu.parallel import mesh as jax_mesh
from imagefolder_tpu_torch.models import build_maskgit, build_rar
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import VAR, VARConfig
from imagefolder_tpu_torch.parallel import dist
from imagefolder_tpu_torch.parallel.mesh import fsdp_placements, tp_placements, tp_shard_params
from imagefolder_tpu_torch.utils.convert import (latent_decoder_state_dict_from_flax,
                                                 maskgit_state_dict_from_flax,
                                                 rar_state_dict_from_flax,
                                                 var_state_dict_from_flax,
                                                 vqmodel_state_dict_from_flax)
from tests._torch_parity import one_torch_thread  # noqa: F401
from tests.test_torch_lora import lora_state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
TP_TOL = 1e-5
RTOL = 1e-4
TIMEOUT = 240  # seconds a worker may take (about 20 alone)

CNN = dict(codebook_size=32, codebook_embed_dim=8, encoder_ch_mult=(1, 2),
           decoder_ch_mult=(1, 2), z_channels=32, enc_type="cnn", dec_type="cnn",
           semantic_guide="none", detail_guide="none")
GAN_ARGS = dict(CNN, num_latent_tokens=256, image_size=32, v_patch_nums=(1, 16), start_drop=1)
VAR_VAE_ARGS = dict(CNN, num_latent_tokens=9, image_size=6, v_patch_nums=(1, 2, 3))
VAR_CFG = dict(vocab_size=32, Cvae=8, num_classes=10, depth=2, embed_dim=64, num_heads=2,
               patch_nums=(1, 2, 3), drop_path_rate=0.0, cond_drop_rate=0.0, p_drop=0.0)
TINY = "tiny_sharding_vit"  # the ViT preset of the rule tests: 2 blocks, 4 heads of 16
VIT_ARGS = dict(enc_type="dinov2", dec_type="dinov2", encoder_model=TINY, decoder_model=TINY,
                codebook_size=16, codebook_embed_dim=8, v_patch_nums=(1, 1, 2),
                num_latent_tokens=4, image_size=32, detail_guide="none")
GEN_ARGS = dict(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=4, num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        for presets in (jax_vit.VIT_PRESETS, pt_vit.VIT_PRESETS):
            mp.setitem(presets, TINY, dict(embed_dim=64, depth=2, num_heads=4))
        yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four processes on a mesh and one on the whole batch, all at once."""
    out = tmp_path_factory.mktemp("sharding")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, str(ROOT / "tests" / "_torch_sharding_worker.py")]
    procs = [subprocess.Popen(cmd + [f"localhost:{port}", "4", str(r), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    procs.append(subprocess.Popen(cmd + ["localhost:0", "1", "0", str(out)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and "sharding ok" in stdout, err[-3000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def _load(runs, case):
    one = torch.load(runs / f"{case}_1_0.pt")
    four = [torch.load(runs / f"{case}_4_{r}.pt") for r in range(4)]
    return one, four


def _held(one: dict, four: list, tol: float):
    """Every tensor of the four processes' states bit-equal across them and
    within ``tol`` of its max abs of the one process's."""
    want_state, got_state = one["state"], four[0]["state"]
    assert set(want_state) == set(got_state)
    assert any(k.startswith("grad.") for k in want_state)
    for k, want in want_state.items():
        for other in four[1:]:
            assert torch.equal(other["state"][k], got_state[k]), f"{k}: the ranks differ"
        got = got_state[k]
        assert got.shape == want.shape, k
        if torch.equal(got, want):  # integers, VAR's -inf bias
            continue
        assert want.is_floating_point(), k
        scale = max(want.abs().max().item(), 1.0) if want.numel() else 1.0
        err = (got - want).abs().max().item() if want.numel() else 0.0
        assert err <= tol * scale, f"{k}: {err:.3e} of max {scale:.3e}"


def _metrics_close(one: dict, four: list, keys):
    for k in keys:
        np.testing.assert_allclose(four[0]["state"][f"metric.{k}"].item(),
                                   one["state"][f"metric.{k}"].item(), rtol=RTOL, err_msg=k)


def test_gan_step_on_data_x_fsdp_matches_one_process(runs):
    one, four = _load(runs, "gan_fsdp")
    _held(one, four, TOL)
    _metrics_close(one, four, ("gen_loss", "disc_loss", "rec_loss", "vq_loss"))
    rule = fsdp_placements(VQModel(ModelArgs(**GAN_ARGS), device="cpu"), 2, 2 ** 10)
    assert four[0]["placements"] == {k: str(v) for k, v in rule.items()}


def test_gan_step_layout(runs):
    """After the step each split parameter's local tensor is half of it, the
    EMA copy has the parameters' placement, and FSDP2 holds no gathered
    copy."""
    _, four = _load(runs, "gan_fsdp")
    for run in four:
        layout = run["layout"]
        assert layout["sharded"] > 0 and layout["sharded"] == len(layout["shares"])
        assert set(layout["shares"].values()) == {0.5}
        assert layout["ema_same"]
        assert layout["gathered_buffers"] >= layout["sharded"]
        assert layout["gathered_bytes"] == 0


def test_var_step_on_data_mesh_matches_one_process(runs):
    one, four = _load(runs, "var_data")
    _held(one, four, TOL)
    _metrics_close(one, four, ("loss", "acc_mean"))


def test_var_tp_step_on_data_x_model_matches_one_process(runs):
    one, four = _load(runs, "var_tp")
    _held(one, four, TP_TOL)
    _metrics_close(one, four, ("loss", "acc_mean"))
    split = [k for k, v in four[0]["placements"].items() if v.startswith("S")]
    assert len(split) >= 8, split


def test_gan_tp_step_on_data_x_model_matches_one_process(runs):
    """The tiny flagship GAN step with the tokenizer under tensor
    parallelism: each ViT block's qkv (by heads) and proj, the teacher's
    too, and ToPixel's linear proj split, as the rule places them."""
    one, four = _load(runs, "gan_tp")
    _held(one, four, TP_TOL)
    _metrics_close(one, four, ("gen_loss", "disc_loss", "rec_loss", "vq_loss", "sem_loss"))
    placements = four[0]["placements"]
    split = {k for k, v in placements.items() if v.startswith("S")}
    assert "decoder.to_pixel.model.weight" in split
    assert placements["decoder.to_pixel.model.weight"] == "S(1)"
    assert {"encoder.model.blocks.0.attn.qkv.bias",
            "semantic_model.blocks.1.attn.proj.weight"} <= split
    assert not any(".mlp." in k for k in split)
    assert len(split) == 3 * 6 + 1  # qkv, its bias and proj in 6 ViT blocks; ToPixel


def test_gan_tp_adaptive_weight_matches_one_process(runs):
    """The adaptive weight reads ToPixel's weight, split by columns under
    TP: the norms of its gradients sum the shards over the model group."""
    one, four = _load(runs, "gan_tp")
    want = one["state"]["metric.disc_adaptive_weight"].item()
    got = four[0]["state"]["metric.disc_adaptive_weight"].item()
    assert want > 0
    assert abs(got - want) <= TP_TOL * max(abs(want), 1.0), (got, want)


def test_vit_fused_sublayers_under_tp_match_one_process(runs):
    """The fused attention sublayer under TP (rank 0 carries the residual and
    proj's bias, ls enters through f): dec(enc(x)) and every gradient."""
    one, four = _load(runs, "vit_fused_tp")
    _held(one, four, TP_TOL)
    assert any(v.startswith("S") for v in four[0]["placements"].values())


@pytest.mark.parametrize("case", ["rar_fsdp", "rar_tp", "maskgit_fsdp", "maskgit_tp"])
def test_generator_trainer_steps_match_one_process(runs, case):
    """``RARTrainer`` (with its EMA) and ``MaskGITTrainer`` (bert under
    FSDP2, U-ViT under TP) with ``shard=``."""
    one, four = _load(runs, case)
    _held(one, four, TP_TOL if case.endswith("_tp") else TOL)
    _metrics_close(one, four, ("loss", "correct_tokens", "grad_norm"))
    assert any(v.startswith("S") for v in four[0]["placements"].values())


def test_gan_accumulation_on_data_x_fsdp_matches_one_process(runs):
    """``grad_accum_steps=2`` over FSDP2's shards: two updates' parameters,
    gradients, moments and EMA."""
    one, four = _load(runs, "gan_accum")
    _held(one, four, TOL)
    _metrics_close(one, four, ("gen_loss", "rec_loss", "vq_loss"))


def test_gan_accumulation_resume_is_bit_exact(runs):
    """Resumed after its first micro-step (``acc`` and ``mini_step`` carried
    by the optimizer's ``state_dict``), the sharded run and the one-process
    run each end bit-equal to their straight run."""
    one, four = _load(runs, "gan_accum")
    for run in [one] + four:
        assert run["resume"]["unequal"] == [] and run["resume"]["tensors"] > 100


def test_rar_generate_on_a_split_rar_gives_the_unsharded_tokens(runs):
    one, four = _load(runs, "rar_generate_tp")
    want = one["state"]["tokens"]
    assert want.shape == (8, GEN_ARGS["seq_len"])
    for run in four:
        assert torch.equal(run["state"]["tokens"], want)


# ------------------------- the rules against JAX ------------------------- #

def _shapes(module, *args, **kwargs):
    return jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                          jax.random.PRNGKey(0))["params"]


def _marked(shapes, shardings):
    """Each leaf as an array that varies along its sharded dimension (its
    index there, from 1) and is 0 where the leaf is replicated."""
    def mark(leaf, sh):
        dims = [d for d, s in enumerate(sh.spec) if s is not None]
        x = np.zeros(leaf.shape, np.float32)
        if dims:
            (d,) = dims
            shape = [1] * len(leaf.shape)
            shape[d] = leaf.shape[d]
            x += np.arange(1, leaf.shape[d] + 1, dtype=np.float32).reshape(shape)
        return x
    return jax.tree.map(mark, shapes, shardings)


def _jax_dims(sd: dict, names) -> dict:
    """The torch dimension along which each converted marker varies, or
    None."""
    out = {}
    for name in names:
        t = sd[name]
        dims = [i for i in range(t.ndim) if t.shape[i] > 1 and bool((t.diff(dim=i) != 0).any())]
        assert len(dims) <= 1, (name, dims)
        out[name] = dims[0] if dims else None
    return out


def _port_dims(placements: dict) -> dict:
    return {k: pl.dim if pl.is_shard() else None for k, pl in placements.items()}


def _var_pair():
    jshapes = _shapes(JaxVAR(JaxVARConfig(**VAR_CFG)), jnp.zeros((2,), jnp.int32),
                      jnp.zeros((2, 13, 8)))
    return jshapes, VAR(VARConfig(**VAR_CFG), device="cpu"), var_state_dict_from_flax


def _tokenizer_pair(kw):
    jshapes = _shapes(JaxVQModel(JaxArgs(**kw)), jnp.zeros((2, kw["image_size"],
                                                            kw["image_size"], 3)), train=False)
    port = VQModel(ModelArgs(**kw), device="cpu")

    def convert(marked, cfg):
        sd = vqmodel_state_dict_from_flax(marked, cfg)
        sd.update(lora_state_dict_from_flax(marked, port, cfg))
        return sd

    return jshapes, port, convert


def _rar_pair():
    jshapes = _shapes(jax_build_rar(**GEN_ARGS), jnp.zeros((2, 16), jnp.int32),
                      jnp.zeros((2,), jnp.int32))
    return jshapes, build_rar(**GEN_ARGS, device="cpu"), lambda m, _: rar_state_dict_from_flax(m)


def _maskgit_pair(arch):
    jm = jax_build_maskgit(**GEN_ARGS, arch=arch)
    jshapes = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((2, 16), jnp.int32),
                                               jnp.zeros((2,), jnp.int32), rng=k),
                             jax.random.PRNGKey(0))["params"]
    return jshapes, build_maskgit(**GEN_ARGS, arch=arch, device="cpu"), \
        maskgit_state_dict_from_flax


def _rope_pair():
    kw = dict(img_size=32, patch_size=8, num_latent_tokens=4, use_rope=True,
              abs_pos_embed=False)
    jshapes = _shapes(jax_vit.LatentDecoder(model_name=TINY, **kw), jnp.zeros((2, 4, 64)))
    port = pt_vit.LatentDecoder(TINY, kw.pop("img_size"), kw.pop("patch_size"),
                                kw.pop("num_latent_tokens"), **kw)
    return jshapes, port, lambda m, _: latent_decoder_state_dict_from_flax(m)


def _cnn_pair():
    jshapes = _shapes(JaxVQModel(JaxArgs(**GAN_ARGS)), jnp.zeros((2, 32, 32, 3)), train=False)
    return jshapes, VQModel(ModelArgs(**GAN_ARGS), device="cpu"), vqmodel_state_dict_from_flax


# each family, and the number of parameters the TP rule splits at n = 2
FAMILIES = {
    "var": (_var_pair, 5 * VAR_CFG["depth"]),
    # 2 blocks each in the encoder, decoder and DINOv2 teacher: qkv, its bias
    # and proj; ToPixel's proj
    "vit_tokenizer": (lambda: _tokenizer_pair(dict(VIT_ARGS, semantic_guide="dinov2")), 19),
    # lat_lora's encoder: every kernel a LoRA base, nothing splits; the lora
    # decoder's qkv and proj split
    "lat_lora_tokenizer": (lambda: _tokenizer_pair(dict(
        VIT_ARGS, semantic_guide="none", enc_tuning_method="lat_lora",
        dec_tuning_method="lora", lora_rank=4)), 7),
    # qkv, its bias, proj, fc1, its bias and fc2 in each block (U-ViT's
    # depth + 1 blocks have no qkv bias)
    "rar": (_rar_pair, 6 * GEN_ARGS["depth"]),
    "maskgit_bert": (lambda: _maskgit_pair("bert"), 6 * GEN_ARGS["depth"]),
    "maskgit_uvit": (lambda: _maskgit_pair("uvit"), 5 * (GEN_ARGS["depth"] + 1)),
    "rope_decoder": (_rope_pair, 3 * 2 + 1),
    # the q, k and v convs' 4-D kernels stay whole; their 1-D biases are
    # column-layer biases to the rule: 3 in each of 7 attention blocks
    "cnn_tokenizer": (_cnn_pair, 3 * 7),
}


@pytest.mark.parametrize("model", ["cnn_tokenizer", "var", "rar", "maskgit_uvit"])
def test_fsdp_rule_matches_jax(model):
    """``fsdp_placements`` picks the parameter and dimension that the JAX
    ``fsdp_shard_params`` shards on a (4, 2) data x fsdp mesh."""
    jshapes, port, convert = FAMILIES[model][0]()
    mesh = jax_mesh.make_mesh(("data", "fsdp"), (4, 2))
    marked = _marked(jshapes, jax_mesh.fsdp_shard_params(jshapes, mesh, min_size=2 ** 10))
    want = _jax_dims(convert(marked, port.config), [n for n, _ in port.named_parameters()])
    got = _port_dims(fsdp_placements(port, 2, 2 ** 10))
    assert got == want
    assert sum(d is not None for d in got.values()) > 0


@pytest.mark.parametrize("model", list(FAMILIES))
def test_tp_rule_matches_jax(model):
    """``tp_placements`` picks the parameter and dimension that the JAX
    ``tp_shard_params`` shards on a (4, 2) data x model mesh, on every
    model family the rule reaches; the CNN tokenizer's q, k, v and proj_out
    kernels are 4-D convs, which it never splits (it splits the q, k and v
    biases)."""
    make, count = FAMILIES[model]
    jshapes, port, convert = make()
    mesh = jax_mesh.make_mesh(("data", "model"), (4, 2))
    marked = _marked(jshapes, jax_mesh.tp_shard_params(jshapes, mesh, axis="model"))
    want = _jax_dims(convert(marked, getattr(port, "config", None)),
                     [n for n, _ in port.named_parameters()])
    got = _port_dims(tp_placements(port, 2))
    assert got == want
    assert sum(d is not None for d in got.values()) == count


class _ModelAxis:
    """A (1, 2) data x model mesh's face to ``tp_shard_params`` as rank 0 of
    the model axis sees it: splitting makes no collective."""

    mesh_dim_names, shape = ("data", "model"), (1, 2)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("model", list(FAMILIES))
def test_tp_shard_params_splits_the_rule_set(model):
    """``tp_shard_params`` splits exactly the parameters ``tp_placements``
    names, each to half of it on the placed dimension (a packed qkv as three
    runs, the q, k and v rows of rank 0's heads), and leaves the rest."""
    _, port, _ = FAMILIES[model][0]()
    whole = {n: p.detach().clone() for n, p in port.named_parameters()}
    rule = tp_placements(port, 2)
    placements = tp_shard_params(port, _ModelAxis())
    assert placements == rule
    assert sum(pl.is_shard() for pl in rule.values()) == FAMILIES[model][1]
    for name, p in port.named_parameters():
        pl, w = placements[name], whole[name]
        if not pl.is_shard():
            assert not hasattr(p, "shard_group") and torch.equal(p, w), name
            continue
        chunks = getattr(p, "shard_chunks")
        runs = w.chunk(chunks, pl.dim)
        want = torch.cat([r.chunk(2, pl.dim)[0] for r in runs], pl.dim)
        assert torch.equal(p, want), name
        assert chunks == (3 if name.endswith(("qkv.weight", "qkv.bias")) else 1), name


def test_init_distributed_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.init_distributed("localhost:1", 2, 0, device="cuda")
    assert dist.backend_for("cpu") == "gloo"
