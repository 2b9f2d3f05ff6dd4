"""Port parity, the input pipeline: ``imagefolder_tpu_torch/data`` on the
CPU against the JAX package's ``imagefolder_tpu/data`` on one folder of 12
PNGs of mixed sizes made from a seed.

- ``list_image_folder`` equal to JAX's;
- ``center_crop_arr`` bit-equal to JAX's, and ``random_crop_arr`` under
  the same ``np.random.Generator``;
- the native crop, flip and normalisation bit-equal to its numpy path and
  to the JAX package's, the endpoints exactly -1 and 1;
- the val loader's batches (``train=False``, the ragged last one kept)
  bit-equal to JAX's ``make_dataloader`` batches (both with no worker
  processes), labels included;
- the train loader: every record once an epoch, epochs shuffled apart, a
  new augmentation each visit, the process shards disjoint and equal, and
  ``device_prefetch``'s state resuming the exact batch order mid-epoch
  through ``CheckpointManager.save_data_state`` (as
  ``tests/test_integration.py`` drives the JAX loader), a state of another
  loader refused.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from imagefolder_tpu.data import imagenet as jax_data
from imagefolder_tpu.data._native import crop_flip_normalize as jax_cfn
from imagefolder_tpu_torch.data import imagenet as pt_data
from imagefolder_tpu_torch.data._native import fastops
from imagefolder_tpu_torch.utils.ckpt import CheckpointManager
from tests._torch_parity import one_torch_thread  # noqa: F401

PX = 32


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    sizes = [(40, 40), (37, 52), (70, 33), (64, 90), (32, 32), (129, 65)]
    for i in range(12):
        d = root / f"class_{i % 3}"
        d.mkdir(exist_ok=True)
        h, w = sizes[i % len(sizes)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i:02d}.png")
    return root


def _images(folder):
    return [Image.open(f).convert("RGB") for f in pt_data.list_image_folder(str(folder))[0]]


def test_list_image_folder_matches_jax(folder):
    assert pt_data.list_image_folder(str(folder)) == jax_data.list_image_folder(str(folder))


def test_crops_bit_equal_to_jax(folder):
    for i, img in enumerate(_images(folder)):
        np.testing.assert_array_equal(pt_data.center_crop_arr(img, PX),
                                      jax_data.center_crop_arr(img, PX))
        got = pt_data.random_crop_arr(img, PX, np.random.default_rng(i))
        want = jax_data.random_crop_arr(img, PX, np.random.default_rng(i))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (PX, PX, 3)


def test_fastops_bit_equal_to_numpy_and_jax():
    arr = np.random.default_rng(1).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    arr[0, 0] = (0, 255, 128)
    assert fastops.native_available()
    lib = fastops._LIB
    for oy, ox, flip in ((0, 0, False), (3, 7, True), (8, 18, False)):
        native = fastops.crop_flip_normalize(arr, oy, ox, PX, flip)
        fastops._LIB = None  # the numpy path
        try:
            plain = fastops.crop_flip_normalize(arr, oy, ox, PX, flip)
        finally:
            fastops._LIB = lib
        np.testing.assert_array_equal(native, plain)
        np.testing.assert_array_equal(native, jax_cfn(arr, oy, ox, PX, flip))
    x = fastops.crop_flip_normalize(arr, 0, 0, PX, False)
    assert x[0, 0, 0] == -1.0 and x[0, 0, 1] == 1.0 and x.dtype == np.float32


def test_val_loader_bit_equal_to_jax(folder):
    want = list(jax_data.make_dataloader(str(folder), 5, PX, train=False, num_epochs=1,
                                         drop_remainder=False, num_workers=0))
    got = list(pt_data.make_dataloader(str(folder), 5, PX, train=False, num_epochs=1,
                                       drop_remainder=False, num_workers=0))
    assert [len(b["image"]) for b in got] == [len(b["image"]) for b in want] == [5, 5, 2]
    for g, w in zip(got, want):
        assert g["image"].dtype == torch.float32 and g["label"].dtype == torch.int32
        np.testing.assert_array_equal(g["image"].numpy(), np.asarray(w["image"]))
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))


def _stream(folder, **kw):
    return pt_data.make_dataloader(str(folder), 3, PX, train=True, seed=7, num_workers=0, **kw)


def test_train_loader_epochs_and_shards(folder):
    it = iter(_stream(folder))
    batches = [next(it) for _ in range(8)]  # two epochs of 4 batches
    labels = [b["label"].numpy() for b in batches]
    assert sorted(np.concatenate(labels[:4]).tolist()) == sorted(
        np.concatenate(labels[4:]).tolist()) == sorted([i % 3 for i in range(12)])
    plans = [_stream(folder).epoch_batches(e) for e in (0, 1)]
    assert plans[0] != plans[1]  # reshuffled
    assert sorted(k[1] for b in plans[0] for k in b) == list(range(12))
    # the same record draws a new crop on its next visit
    src = _stream(folder).source
    a = pt_data._VisitDataset(src, 7)[(0, 5)]["image"]
    b = pt_data._VisitDataset(src, 7)[(1, 5)]["image"]
    assert not np.array_equal(a, b)
    shards = [_stream(folder, shard_index=i, shard_count=3) for i in range(3)]
    seen = [set(s.shard.tolist()) for s in shards]
    assert all(len(s) == 4 for s in seen) and set.union(*seen) == set(range(12))
    for s, records in zip(shards, seen):  # one batch of 3 of the shard's 4 an epoch
        (batch,) = s.epoch_batches(0)
        assert len(batch) == 3 and {k[1] for k in batch} <= records


def test_train_loader_resumes_exact_batch_order(folder, tmp_path):
    ref = [b["image"].numpy() for _, b in
           zip(range(10), pt_data.device_prefetch(iter(_stream(folder)), device="cpu"))]
    ckpt = CheckpointManager(str(tmp_path / "run"))
    it = pt_data.device_prefetch(iter(_stream(folder)), device="cpu")
    got = [next(it)["image"].numpy() for _ in range(6)]  # mid-epoch, prefetched ahead
    ckpt.save_data_state(6, it.state)
    raw = iter(_stream(folder))
    assert ckpt.apply_data_state(6, raw) is True
    it2 = pt_data.device_prefetch(raw, device="cpu")
    got += [next(it2)["image"].numpy() for _ in range(4)]
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i} diverged")
    assert ckpt.restore_data_state(5) is None
    # a state of another loader (another batch size) starts a fresh stream
    other = iter(pt_data.make_dataloader(str(folder), 4, PX, train=True, seed=7,
                                         num_workers=0))
    msgs = []
    assert ckpt.apply_data_state(6, other, log=msgs.append) is False
    assert "incompatible" in msgs[0]
