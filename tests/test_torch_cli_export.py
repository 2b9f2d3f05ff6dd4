"""Port parity, ``scripts/export_weights.py``: for each kind (a tiny
single-scale tokenizer, ``tests/_torch_cli.py``; RAR and VAR-d1 at width
64) and each output (``.safetensors``, ``.bin``, ``.pt`` and an HF
directory), the port's CLI on a port training checkpoint (the model's
weights and, for RAR, an EMA copy of other values) writes the keys,
shapes, dtypes and values that the JAX package's
``utils/hub.py::save_pretrained_weight`` / ``save_pretrained`` write for
the same parameters, and the same ``config.json``; a weight file given as
input comes out as it went in (format conversion).
"""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import jax
import jax.numpy as jnp

from imagefolder_tpu.models import build_rar as jax_build_rar
from imagefolder_tpu.train.var_train import build_vae_var as jax_build_vae_var
from imagefolder_tpu.utils import hub as jax_hub
from imagefolder_tpu_torch.models.tokenizer import ModelArgs
from imagefolder_tpu_torch.models.var import VARConfig
from imagefolder_tpu_torch.scripts import export_weights
from imagefolder_tpu_torch.utils.convert import (
    rar_state_dict_from_flax,
    var_state_dict_from_flax,
    vqmodel_state_dict_from_flax,
)
from tests._torch_cli import CFG, files, tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread, random_params  # noqa: F401

OUTPUTS = ("x.safetensors", "x.bin", "x.pt", "hf")


def _read(path) -> dict:
    if path.is_dir():
        path = path / "model.safetensors"
    if path.suffix == ".safetensors":
        return dict(load_file(str(path)))
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


@pytest.fixture(scope="module")
def kinds(files, tmp_path_factory):
    """Per kind: (JAX params, JAX params of the EMA, the port checkpoint,
    the JAX ModelArgs or None)."""
    root, jargs, params = files
    out = tmp_path_factory.mktemp("export")
    margs = ModelArgs(**{k: tuple(v) if isinstance(v, list) else v for k, v in CFG.items()})
    kinds = {}
    ema = jax.tree_util.tree_map(lambda v: np.asarray(v) * 0.5, params)
    ckpt = out / "tok_ckpt.pt"
    torch.save({"model": vqmodel_state_dict_from_flax(params, margs),
                "ema": vqmodel_state_dict_from_flax(ema, margs), "step": 3}, ckpt)
    kinds["vqmodel"] = (params, ema, ckpt, jargs)
    jr = jax_build_rar(seq_len=16, codebook_size=32, hidden=64, depth=2, heads=2,
                       num_classes=10)
    rp = random_params(jr, jnp.zeros((2, 16), jnp.int32), jnp.zeros((2,), jnp.int32), seed=5)
    rema = random_params(jr, jnp.zeros((2, 16), jnp.int32), jnp.zeros((2,), jnp.int32), seed=6)
    ckpt = out / "rar_ckpt.pt"
    torch.save({"model": rar_state_dict_from_flax(rp), "ema": rar_state_dict_from_flax(rema),
                "opt": {}, "step": 3}, ckpt)
    kinds["rar"] = (rp, rema, ckpt, None)
    _, jvar = jax_build_vae_var(jargs, depth=1, num_classes=10)
    cfg = jvar.config
    vp = random_params(jvar, jnp.asarray([0, 1]),
                       jnp.zeros((2, cfg.L - cfg.first_l, cfg.Cvae)), seed=7)
    pcfg = VARConfig(**{f: getattr(cfg, f) for f in VARConfig.__dataclass_fields__})
    ckpt = out / "var_ckpt.pt"
    torch.save({"model": var_state_dict_from_flax(vp, pcfg), "opt": {}, "ema": None,
                "rng": None}, ckpt)
    kinds["var"] = (vp, vp, ckpt, None)
    return out, kinds, root


@pytest.mark.parametrize("kind", ["vqmodel", "rar", "var"])
@pytest.mark.parametrize("use_ema", [False, True], ids=["weights", "ema"])
def test_export_matches_jax(kinds, kind, use_ema):
    out, table, root = kinds
    params, ema, ckpt, jargs = table[kind]
    want_params = ema if use_ema else params
    for name in OUTPUTS:
        hf = name == "hf"
        jpath = out / f"jax_{kind}_{use_ema}_{name}"
        ppath = out / f"port_{kind}_{use_ema}_{name}"
        if hf:
            jax_hub.save_pretrained(jpath, want_params, kind, jargs,
                                    config={"source_ckpt": str(ckpt)})
        else:
            jax_hub.save_pretrained_weight(jpath.with_name(jpath.name), want_params, kind, jargs)
        argv = ["--kind", kind, "--ckpt", str(ckpt), "--out", str(ppath)]
        argv += ["--config", str(root / "cfg.yaml")] * (kind == "vqmodel")
        argv += ["--use_ema"] * use_ema + ["--hf"] * hf
        export_weights.main(argv)
        want, got = _read(jpath), _read(ppath)
        assert sorted(got) == sorted(want), (kind, name)
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, (kind, name, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{kind} {name} {k}")
        if hf:
            assert json.loads((ppath / "config.json").read_text()) == \
                json.loads((jpath / "config.json").read_text())


def test_export_converts_a_weight_file(kinds):
    out, table, root = kinds
    src = root / "tok.pt"  # the JAX exporter's layout, as a torch file
    export_weights.main(["--kind", "vqmodel", "--config", str(root / "cfg.yaml"), "--ckpt",
                         str(src), "--out", str(out / "conv.safetensors")])
    want = {k: v.numpy() for k, v in torch.load(src, weights_only=True).items()}
    got = _read(out / "conv.safetensors")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_export_vqmodel_needs_a_config(kinds):
    out, table, _ = kinds
    with pytest.raises(SystemExit):
        export_weights.main(["--kind", "vqmodel", "--ckpt", str(table["vqmodel"][2]),
                             "--out", str(out / "no_cfg.pt")])
