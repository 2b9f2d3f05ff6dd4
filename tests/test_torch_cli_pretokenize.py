"""Port parity, ``scripts/pretokenize.py`` and the JSONL reader of
``scripts/train_rar.py``: the JAX CLI's ``main`` (``sys.argv`` patched) and
the port's ``main(argv, device="cpu")`` on the same tiny tokenizer ``.pt``
(``tests/_torch_cli.py``: width 64, 64 px, 16 latents, a 32 x 8 codebook)
over the same 8 PNGs, with center + hflip and with ten-crop: the two JSONL
files row for row, class ids and tokens exact. Then ``JsonlTokens``: the
port's batches and state blobs against ``scripts.train_rar.JsonlTokens``
across seeds, two shards and an epoch boundary, and a resume from a blob.
"""

import json
import sys

import numpy as np
import pytest

from imagefolder_tpu_torch.scripts import pretokenize as pt_pretok
from imagefolder_tpu_torch.scripts import train_rar as pt_train_rar
from scripts import pretokenize as jax_pretok
from scripts import train_rar as jax_train_rar
from tests._torch_cli import files, tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["center", "ten_crop"])
def test_pretokenize_jsonl_matches_jax(files, tmp_path, monkeypatch, mode):
    root, _, _ = files
    common = ["--config", str(root / "cfg.yaml"), "--vq_ckpt", str(root / "tok.pt"),
              "--data_path", str(root / "val"), "--crop_mode", mode, "--batch_size", "6"]
    want_path, got_path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    monkeypatch.setattr(sys, "argv", ["pretokenize.py", *common, "--output", str(want_path)])
    jax_pretok.main()
    got = pt_pretok.main([*common, "--output", str(got_path)], device="cpu")
    want_rows = [json.loads(line) for line in want_path.read_text().splitlines()]
    got_rows = [json.loads(line) for line in got_path.read_text().splitlines()]
    crops = 2 if mode == "center" else 10
    assert len(got_rows) == len(want_rows) == 8 * crops == got["rows"]
    assert got["batches"] == -(-8 * crops // 6)
    for i, (g, w) in enumerate(zip(got_rows, want_rows)):
        assert g == w, f"row {i}"
    assert {r["class_id"] for r in got_rows} == {0}
    assert all(len(r["tokens"]) == 16 for r in got_rows)


def test_crops_match_jax():
    img = np.random.default_rng(0).uniform(0, 255, (40, 44, 3)).astype(np.float32)
    for mode in ("center", "ten_crop"):
        got = pt_pretok.crops_for(img, mode, 32)
        want = jax_pretok.crops_for(img, mode, 32)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _rows(n: int):
    rng = np.random.default_rng(n)
    return [{"class_id": int(rng.integers(0, 10)), "tokens": rng.integers(0, 32, 5).tolist()}
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7])
def test_jsonl_batches_and_state_match_jax(tmp_path, seed):
    path = tmp_path / "toks.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows(23)))
    got_data, want_data = pt_train_rar.JsonlTokens(path), jax_train_rar.JsonlTokens(path)
    assert len(got_data) == len(want_data) == 23
    for shard in range(2):  # 11 rows a shard: batches of 4 cross an epoch at the third
        got = got_data.batches(4, seed=seed, shard_index=shard, shard_count=2)
        want = want_data.batches(4, seed=seed, shard_index=shard, shard_count=2)
        for _ in range(7):
            (gt, gl), (wt, wl) = next(got), next(want)
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gl, wl)
            assert gt.dtype == wt.dtype and gl.dtype == wl.dtype
            assert got.get_state() == want.get_state()
        assert got.epoch >= 2
        # a fresh stream set to the blob continues as the original
        blob = got.get_state()
        resumed = got_data.batches(4, seed=seed, shard_index=shard, shard_count=2)
        resumed.set_state(blob)
        for _ in range(3):
            np.testing.assert_array_equal(next(resumed)[0], next(got)[0])


def test_jsonl_refuses_a_shard_smaller_than_a_batch(tmp_path):
    path = tmp_path / "toks.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows(7)))
    for mod in (pt_train_rar, jax_train_rar):
        with pytest.raises(ValueError, match="per-shard rows"):
            mod.JsonlTokens(path).batches(4, shard_count=2)
