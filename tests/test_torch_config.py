"""Port parity, the tokenizer config loader: ``imagefolder_tpu_torch/utils/
config.py`` against the JAX package's ``utils/config.py`` on every YAML in
``configs/``, with and without CLI overrides: every field of the three
configs (ModelArgs, TokenizerTrainConfig, RunConfig) is equal, and
``parse_overrides`` reads values as the JAX one does. Exact equality: the
two loaders do the same host arithmetic.
"""

import dataclasses
from pathlib import Path

import pytest

from imagefolder_tpu.utils import config as jax_config
from imagefolder_tpu_torch.utils import config as pt_config

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))
# every routing: a model key, a train key, a run key that derives model
# fields (delta, mixed_precision), one that scales the lr, and an unknown key
OVERRIDES = ["lr=2e-4", "global_batch_size=256", "delta=8", "mixed_precision=none",
             "remat=true", "v_patch_nums=[1,2,4]", "disc_type=patchgan", "not_a_key=1"]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_there_are_configs():
    assert len(CONFIGS) >= 10


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["yaml", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_load_tokenizer_config_matches_jax(path, overrides):
    want = jax_config.load_tokenizer_config(str(path), jax_config.parse_overrides(overrides))
    got = pt_config.load_tokenizer_config(str(path), pt_config.parse_overrides(overrides))
    for w, g in zip(want, got):
        assert type(g).__name__ == type(w).__name__
        assert _fields(g) == _fields(w), type(g).__name__


def test_parse_overrides_matches_jax():
    argv = OVERRIDES + ["alpha=0.5", "ema=false", "data_path=/x/y", "anneal_end=120"]
    assert pt_config.parse_overrides(argv) == jax_config.parse_overrides(argv)
    with pytest.raises(ValueError):
        pt_config.parse_overrides(["lr"])


def test_config_schemas_match_jax():
    """Same fields and defaults in ModelArgs and RunConfig (the trainer's
    config is held in tests/test_torch_tokenizer_train.py)."""
    from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
    from imagefolder_tpu_torch.models.tokenizer import ModelArgs as PtArgs
    for a, b in ((PtArgs, JaxArgs), (pt_config.RunConfig, jax_config.RunConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(a)] == [
            (f.name, f.default) for f in dataclasses.fields(b)]
