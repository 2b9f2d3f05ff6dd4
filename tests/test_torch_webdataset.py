"""Port parity, webdataset shards: ``imagefolder_tpu_torch/data/webdataset.py``
and ``imagefolder_tpu_torch/scripts/convert_to_wds.py`` against the JAX
package's ``data/webdataset.py`` and ``scripts/convert_to_wds.py`` on the
CPU, over a 2-class folder of 11 PNGs of mixed sizes made from a seed:

- the shards both converters write (4 samples a shard, and with JPEG
  re-encoding) byte for byte;
- ``expand_shard_urls``, ``iter_shard`` (on a shard with cls, txt and
  json members), ``res_ratio_ok``, ``with_epoch_counts`` and the shuffle
  buffer ``_shuffled`` under the same ``np.random.Generator``;
- ``WebDatasetReader``'s batches bit-equal to the JAX reader's: val, train
  (shard order and crops from its seed, with and without a shuffle
  buffer, split by worker), resampled (cut by ``num_batches``) and the
  text mode with the res-ratio filter; ``SimpleImageDataset``'s train and
  eval loaders;
- the val stream against the port's ImageFolder val loader over the same
  folder: the same images in the same order, within one fp32 rounding
  (the reader normalises x / 255 * 2 - 1 in fp32, the loader in fp64).
"""

import io
import json
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from imagefolder_tpu.data import webdataset as jax_wds
from imagefolder_tpu_torch.data import webdataset as pt_wds
from imagefolder_tpu_torch.data.imagenet import make_dataloader
from imagefolder_tpu_torch.scripts import convert_to_wds as pt_convert
from scripts import convert_to_wds as jax_convert
from tests._torch_parity import one_torch_thread  # noqa: F401

PX = 32


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(0)
    sizes = [(40, 40), (37, 52), (70, 33), (64, 90), (48, 33)]
    for i in range(11):
        d = root / "tree" / f"class_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        h, w = sizes[i % len(sizes)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i:02d}.png")
    pt_convert.main(["--data_path", str(root / "tree"), "--output_dir", str(root / "pt"),
                     "--prefix", "s", "--samples_per_shard", "4"])
    return root


def test_shards_byte_equal_to_the_jax_script(shards, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert_to_wds.py", "--data_path",
                                      str(shards / "tree"), "--output_dir",
                                      str(tmp_path / "jax"), "--prefix", "s",
                                      "--samples_per_shard", "4"])
    jax_convert.main()
    names = sorted(p.name for p in (shards / "pt").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        ["s-000000.tar", "s-000001.tar", "s-000002.tar"]
    for n in names:
        assert (shards / "pt" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    for mod, out in ((jax_convert, tmp_path / "jq"), (pt_convert, tmp_path / "pq")):
        mod.write_shards(str(shards / "tree"), str(out), "q", 6, reencode_quality=80)
    for n in ("q-000000.tar", "q-000001.tar"):
        assert (tmp_path / "pq" / n).read_bytes() == (tmp_path / "jq" / n).read_bytes(), n
    with pytest.raises(FileExistsError):
        pt_convert.write_shards(str(shards / "tree"), str(shards / "pt"), "s", 4)


def test_helpers_match_jax(shards, tmp_path):
    for pat in ("a-{000..003}.tar", "b.tar", "x{7..12}y.tar"):
        assert pt_wds.expand_shard_urls(pat) == jax_wds.expand_shard_urls(pat)
    text = tmp_path / "text.tar"
    with tarfile.open(text, "w") as tf:
        for key, members in (("k0", {"png": (shards / "tree" / "class_0" / "00.png")
                                     .read_bytes(), "txt": "a cat".encode(),
                                     "json": json.dumps({"original_height": 300,
                                                         "original_width": 200}).encode()}),
                             ("k1", {"cls": b"3", "json": b"{}"})):
            for ext, payload in members.items():
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    for shard in (text, shards / "pt" / "s-000001.tar"):
        assert list(pt_wds.iter_shard(str(shard))) == list(jax_wds.iter_shard(str(shard)))
    for meta in ({"original_height": 300, "original_width": 200},
                 {"original_height": 100, "original_width": 90},
                 {"original_height": 900, "original_width": 300}):
        assert pt_wds.res_ratio_ok(meta) == jax_wds.res_ratio_ok(meta)
        assert pt_wds.res_ratio_ok(meta, 64, 0.2, 5.0) == jax_wds.res_ratio_ok(meta, 64, 0.2, 5.0)
    for args in ((1000, 64, 4), (1281167, 256, 8), (5, 3, 2)):
        assert pt_wds.with_epoch_counts(*args) == jax_wds.with_epoch_counts(*args)
    for buf, initial in ((5, 3), (4, 10), (1, 1)):
        got = list(pt_wds._shuffled(iter(range(23)), buf, initial, np.random.default_rng(5)))
        want = list(jax_wds._shuffled(iter(range(23)), buf, initial, np.random.default_rng(5)))
        assert got == want and sorted(got) == list(range(23))


def _batches_equal(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, what
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), what
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], f"{what} batch {i} {k}"
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} batch {i} {k}")
                assert g[k].dtype == w[k].dtype


READERS = {
    "val": (dict(train=False), dict(partial=True)),
    "train": (dict(train=True, seed=3), dict()),
    "train shuffled, worker 1 of 2": (dict(train=True, seed=4, shuffle_buffer=5,
                                           shuffle_initial=3, shard_index=1, shard_count=2),
                                      dict(partial=True)),
    "resampled": (dict(train=True, seed=5, resampled=True, shuffle_buffer=4, shuffle_initial=2,
                       shard_index=1), dict(num_batches=5)),
    "filtered": (dict(train=False, min_size=40, max_res_ratio=1.5), dict(partial=True)),
}


@pytest.mark.parametrize("kind", list(READERS))
def test_reader_batches_match_jax(shards, kind):
    kw, bkw = READERS[kind]
    pattern = str(shards / "pt" / "s-{000000..000002}.tar")
    got = pt_wds.WebDatasetReader(pattern, PX, **kw).batches(3, **bkw)
    want = jax_wds.WebDatasetReader(pattern, PX, **kw).batches(3, **bkw)
    _batches_equal(got, want, kind)


def test_text_mode_and_facade_match_jax(shards, tmp_path):
    tar = tmp_path / "t-000000.tar"
    rng = np.random.default_rng(1)
    with tarfile.open(tar, "w") as tf:
        for i, (h, w) in enumerate([(300, 280), (260, 90), (40, 40), (512, 300), (280, 300)]):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
            members = {"png": buf.getvalue(), "txt": f"caption {i}".encode(),
                       "json": json.dumps({"original_height": h, "original_width": w}).encode()}
            for ext, payload in members.items():
                info = tarfile.TarInfo(f"{i:04d}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    for kw in (dict(train=True, seed=2, res_ratio_filtering=True),
               dict(train=False, res_ratio_filtering=False)):
        got = pt_wds.WebDatasetReader(str(tar), PX, mode="text", **kw).batches(2, partial=True)
        want = jax_wds.WebDatasetReader(str(tar), PX, mode="text", **kw).batches(2, partial=True)
        _batches_equal(got, want, f"text {kw}")
    pattern = str(shards / "pt" / "s-{000000..000002}.tar")
    common = dict(num_train_examples=11, per_device_batch_size=2, global_batch_size=4,
                  num_workers_per_device=2, crop_size=PX, seed=6, worker_index=1)
    got = pt_wds.SimpleImageDataset(pattern, pattern, **common)
    want = jax_wds.SimpleImageDataset(pattern, pattern, **common)
    assert (got.num_worker_batches, got.num_batches, got.num_samples) == \
        (want.num_worker_batches, want.num_batches, want.num_samples)
    _batches_equal(got.train_dataloader(), want.train_dataloader(), "facade train")
    _batches_equal(got.eval_dataloader(), want.eval_dataloader(), "facade eval")


def test_val_stream_matches_the_image_folder_loader(shards):
    reader = pt_wds.WebDatasetReader(str(shards / "pt" / "s-{000000..000002}.tar"), PX,
                                     train=False)
    got = list(reader.batches(4, partial=True))
    want = list(make_dataloader(str(shards / "tree"), 4, PX, train=False, num_epochs=1,
                                num_workers=0, drop_remainder=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"].numpy())
        np.testing.assert_allclose(g["image"], w["image"].numpy(), rtol=0, atol=2.4e-7)
