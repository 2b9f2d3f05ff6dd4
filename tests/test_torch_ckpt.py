"""Port parity, checkpoints and weight files: ``imagefolder_tpu_torch/utils``
``ckpt.py``, ``safetensors.py`` and ``hub.py`` on the CPU.

- ``CheckpointManager`` keeps the newest ``max_to_keep`` steps, restores
  the latest (or a named) step, saves the best by its metric, round-trips
  aux state by step and falls back to a fresh stream on an incompatible
  loader state, as ``tests/test_integration.py`` and
  ``tests/test_train_eval.py`` drive the JAX manager; every write is a
  rename of a finished file;
- the port's safetensors codec against the ``safetensors`` package, both
  ways, over every dtype the codec names (bf16, bool and an empty tensor
  among them);
- ``hub.save_pretrained_weight`` of a port ``VQModel`` writes the keys,
  shapes and values that the JAX package's ``save_pretrained_weight``
  writes for the same parameters (both formats), ``load_pretrained_weight``
  loads either file back with strict=True, and ``save_pretrained`` writes
  its directory; a training checkpoint is unwrapped from its ``ema`` entry.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import load_file as st_load, save_file as st_save

from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.utils import hub as jax_hub
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.utils import hub, safetensors
from imagefolder_tpu_torch.utils.ckpt import CheckpointManager
from imagefolder_tpu_torch.utils.convert import vqmodel_state_dict_from_flax
from tests._torch_parity import one_torch_thread, random_params  # noqa: F401

TINY = "tiny_ckpt_vit"
TINY_PRESET = dict(embed_dim=64, depth=1, num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        yield


def test_checkpoint_manager_keeps_prunes_and_restores(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    assert ckpt.restore() == (None, 0) and ckpt.latest_step() is None
    for step in (2, 4, 6):
        ckpt.save(step, {"w": torch.full((3,), float(step)), "step": step})
    ckpt.wait()
    assert ckpt.steps() == [4, 6] and ckpt.latest_step() == 6
    state, step = ckpt.restore()
    assert step == 6 and state["step"] == 6 and torch.equal(state["w"], torch.full((3,), 6.0))
    assert ckpt.restore(4)[0]["step"] == 4
    assert not list((tmp_path / "run").rglob("*.tmp*"))  # renamed, not left half-written
    # best by a metric, lower better by default
    assert ckpt.save_best({"m": 3.0}, 3.0) and not ckpt.save_best({"m": 5.0}, 5.0)
    assert ckpt.save_best({"m": 1.0}, 1.0)
    assert torch.load(tmp_path / "run" / "best.pt")["m"] == 1.0
    up = CheckpointManager(str(tmp_path / "up"))
    assert up.save_best({"m": -1.0}, -1.0, lower_is_better=False)
    assert up.save_best({"m": 2.0}, 2.0, lower_is_better=False)
    assert torch.load(tmp_path / "up" / "best.pt")["m"] == 2.0


def test_ckpt_aux_and_incompatible_data_state(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"))
    prog = {"prog_it": 7, "last_prog_si": 5, "first_prog": False}
    ckpt.save_aux(100, {"prog": prog})
    assert ckpt.restore_aux(100) == {"prog": prog}
    assert ckpt.restore_aux(99) is None

    class Incompatible:
        def set_state(self, blob):
            raise ValueError("data state of another loader")

    class Ok:
        def set_state(self, blob):
            self.blob = blob

    assert ckpt.apply_data_state(5, Ok()) is False  # nothing saved
    ckpt.save_data_state(5, b"xyz")
    msgs = []
    assert ckpt.apply_data_state(5, Incompatible(), log=msgs.append) is False
    assert "incompatible" in msgs[0]
    ok = Ok()
    assert ckpt.apply_data_state(5, ok) is True and ok.blob == b"xyz"
    assert ckpt.restore_data_state(6) is None


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn((3, 4), generator=g),
            "bf16": torch.randn((5,), generator=g).bfloat16(),
            "f16": torch.randn((2, 2), generator=g).half(),
            "f64": torch.randn((2,), generator=g).double(),
            "i64": torch.arange(6).reshape(2, 3),
            "i32": torch.arange(4, dtype=torch.int32),
            "u8": torch.arange(7, dtype=torch.uint8),
            "bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros((0, 3))}


def test_safetensors_codec_against_package(tmp_path):
    ts = _tensors()
    safetensors.save_file(ts, tmp_path / "port.safetensors")
    got = st_load(str(tmp_path / "port.safetensors"))
    st_save(ts, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    back = safetensors.load_file(tmp_path / "pkg.safetensors")
    for name, t in ts.items():
        for other in (got[name], back[name]):
            assert other.dtype == t.dtype and other.shape == t.shape, name
            assert torch.equal(other, t), name
    assert set(got) == set(back) == set(ts)


def _tiny_models():
    margs = dict(codebook_size=32, codebook_embed_dim=8, v_patch_nums=(4,),
                 enc_type="dinov2", dec_type="dinov2", encoder_model=TINY, decoder_model=TINY,
                 semantic_guide="none", detail_guide="none", num_latent_tokens=16,
                 abs_pos_embed=True, image_size=32)
    jargs = JaxArgs(**margs)
    params = random_params(JaxVQModel(jargs), jnp.zeros((1, 32, 32, 3)), train=False)
    pargs = ModelArgs(**margs)
    model = VQModel(pargs, device="cpu")
    model.load_state_dict(vqmodel_state_dict_from_flax(params, pargs), strict=True)
    return jargs, params, pargs, model


@pytest.mark.parametrize("suffix", [".safetensors", ".pt"])
def test_save_pretrained_weight_matches_jax(tmp_path, suffix):
    jargs, params, pargs, model = _tiny_models()
    mine = hub.save_pretrained_weight(tmp_path / f"port{suffix}", model)
    theirs = jax_hub.save_pretrained_weight(tmp_path / f"jax{suffix}", params, "vqmodel", jargs)
    if suffix == ".safetensors":
        got, want = st_load_numpy(str(mine)), st_load_numpy(str(theirs))
    else:
        got, want = ({k: v.numpy() for k, v in torch.load(p).items()} for p in (mine, theirs))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # either file loads back, strict, into a fresh model
    for path in (mine, theirs):
        fresh = hub.load_pretrained_weight(path, VQModel(pargs, device="cpu"))
        for (n, a), b in zip(fresh.state_dict().items(), model.state_dict().values()):
            assert torch.equal(a, b), n


def test_save_pretrained_dir_and_training_checkpoint(tmp_path):
    _, _, pargs, model = _tiny_models()
    d = hub.save_pretrained(tmp_path / "hf", model, "vqmodel", {"image_size": 32})
    assert json.loads((d / "config.json").read_text()) == {"model_kind": "vqmodel",
                                                           "image_size": 32}
    sd = hub.load_state_dict_file(d / "model.safetensors")
    assert sorted(sd) == sorted(model.state_dict())
    # a training checkpoint: the "ema" entry wins, as upstream's readers take it
    ema = {k: v + 1 for k, v in model.state_dict().items()}
    torch.save({"model": model.state_dict(), "ema": ema, "step": 3}, tmp_path / "c.pt")
    got = hub.load_state_dict_file(tmp_path / "c.pt")
    assert all(torch.equal(got[k], ema[k]) for k in ema)
    with pytest.raises(ValueError, match="suffix"):
        hub.save_pretrained_weight(tmp_path / "w.npz", model)
