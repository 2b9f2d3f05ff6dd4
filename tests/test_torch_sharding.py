"""The port's sharded steps (``parallel/mesh.py``): the counterparts of
tests/test_sharding.py's four tests, on four gloo processes on the CPU
against one process on the whole batch (``tests/_torch_sharding_worker.py``
runs both at once), at that file's tiny configurations (CNN tokenizer at
32 px with PatchGAN and the adaptive weight; VAR-d2, width 64, 2 heads, on
a 6 px CNN tokenizer's codes), B = 8:

- the GAN step on a 2 x 2 data x fsdp mesh, the tokenizer and its EMA split
  by the JAX rule at min_size 2^10 (one step: the first lr of both
  schedules is 0, so it checks the gradients and moments; the parameters
  move on the next step, whose Adam update magnifies the fp32 reorderings
  of near-zero gradient entries past 1e-6);
- the same step's layout: each split parameter's local tensor holds 1/2 of
  it, the EMA is placed like the parameters, every gathered copy is freed;
- VAR on a data-only mesh of 4, and on a 2 x 2 data x model mesh under
  ``tp_shard_params`` (10 parameters split), two steps each, EMA on.

Tolerances: every tensor the steps leave (parameters, buffers, gradients,
Adam's moments, EMAs, usage, LeCam, metrics) within 1e-6 of its max abs (1e-6
absolute under a max of 1), as test_torch_data_parallel.py's TOL, and 1e-5
under tensor parallelism, whose ``proj`` and ``fc2`` sum their products in
two halves; loss and acc_mean within test_sharding.py's rtol of 1e-4. The
four processes hold the same whole tensors bit for bit.

The placement rules are held to the JAX package's: ``fsdp_shard_params``
and ``tp_shard_params`` of imagefolder_tpu/parallel/mesh.py on the
conftest's 8 virtual devices, each parameter's sharded flax dimension
carried to the port's name and torch dimension through the converter
(``utils/convert.py``), on marker arrays that vary along that dimension.
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

from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.models.var import VAR as JaxVAR
from imagefolder_tpu.models.var import VARConfig as JaxVARConfig
from imagefolder_tpu.parallel import mesh as jax_mesh
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.models.var import VAR, VARConfig
from imagefolder_tpu_torch.models.vit import ViTBackbone
from imagefolder_tpu_torch.parallel import dist
from imagefolder_tpu_torch.parallel.mesh import (fsdp_placements, tp_placements,
                                                 tp_shard_params)
from imagefolder_tpu_torch.utils.convert import (var_state_dict_from_flax,
                                                 vqmodel_state_dict_from_flax)
from tests._torch_parity import one_torch_thread  # noqa: F401

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
    return jshapes, VAR(VARConfig(**VAR_CFG), device="cpu")


def _cnn_pair():
    jshapes = _shapes(JaxVQModel(JaxArgs(**GAN_ARGS)), jnp.zeros((2, 32, 32, 3)), train=False)
    return jshapes, VQModel(ModelArgs(**GAN_ARGS), device="cpu")


@pytest.mark.parametrize("model", ["cnn_tokenizer", "var"])
def test_fsdp_rule_matches_jax(model):
    """``fsdp_placements`` picks the parameter and dimension that the JAX
    ``fsdp_shard_params`` shards on a (4, 2) data x fsdp mesh."""
    jshapes, port = _cnn_pair() if model == "cnn_tokenizer" else _var_pair()
    mesh = jax_mesh.make_mesh(("data", "fsdp"), (4, 2))
    marked = _marked(jshapes, jax_mesh.fsdp_shard_params(jshapes, mesh, min_size=2 ** 10))
    sd = (vqmodel_state_dict_from_flax(marked, port.config) if model == "cnn_tokenizer"
          else var_state_dict_from_flax(marked, port.config))
    names = [n for n, _ in port.named_parameters()]
    want = _jax_dims(sd, names)
    got = _port_dims(fsdp_placements(port, 2, 2 ** 10))
    assert got == want
    assert sum(d is not None for d in got.values()) > 0


def test_tp_rule_matches_jax():
    """``tp_placements`` picks the parameter and dimension that the JAX
    ``tp_shard_params`` shards on a (4, 2) data x model mesh."""
    jshapes, port = _var_pair()
    mesh = jax_mesh.make_mesh(("data", "model"), (4, 2))
    marked = _marked(jshapes, jax_mesh.tp_shard_params(jshapes, mesh, axis="model"))
    want = _jax_dims(var_state_dict_from_flax(marked, port.config),
                     [n for n, _ in port.named_parameters()])
    got = _port_dims(tp_placements(port, 2))
    assert got == want
    assert sum(d is not None for d in got.values()) == 5 * VAR_CFG["depth"]


def test_tp_shard_params_refuses_other_models():
    vit = ViTBackbone(img_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=2)
    with pytest.raises(NotImplementedError, match="ViTBackbone"):
        tp_shard_params(vit, None)
    with pytest.raises(NotImplementedError, match="VQModel"):
        tp_placements(VQModel(ModelArgs(**GAN_ARGS), device="cpu"), 2)


def test_init_distributed_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.init_distributed("localhost:1", 2, 0, device="cuda")
    assert dist.backend_for("cpu") == "gloo"
