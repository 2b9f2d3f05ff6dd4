"""Webdataset-style tar-shard ingestion (counterpart of
``imagefolder_tpu/data/webdataset.py``; reference
``data/webdataset_reader.py``: SimpleImageDataset over resampled shards).

A dependency-free reader for brace-expanded shard lists
(``shards-{000000..000127}.tar``) of (jpg/png, cls|json|txt) groups with the
reference's pipeline surface:

- finite split-by-worker streams (``wds.split_by_worker``,
  webdataset_reader.py:221) via ``shard_index/shard_count``;
- infinite **resampled**-shards mode (``wds.ResampledShards``, :190):
  shards drawn with replacement forever, per-worker independent streams;
- streaming shuffle buffer (``wds.shuffle(bufsize, initial)``, :192-193);
- class-label and **text-label** sample modes (:139-169) with the json
  res-ratio pre-filter (``filter_by_res_ratio``, :34-41);
- ``with_epoch`` worker math (:198-205) via :func:`with_epoch_counts` and
  the :class:`SimpleImageDataset` facade.

Every draw comes from ``np.random.default_rng`` seeded as the JAX reader
seeds it, and the crops are ``data/imagenet.py``'s, so the stream is the JAX
reader's, train and val, resampled or not. Records use the dict schema of
``data/imagenet.py`` (numpy arrays), so trainers are source-agnostic.
"""

from __future__ import annotations

import io
import json
import math
import re
import tarfile
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
from PIL import Image

from imagefolder_tpu_torch.data.imagenet import center_crop_arr, random_crop_arr

__all__ = [
    "expand_shard_urls",
    "iter_shard",
    "res_ratio_ok",
    "with_epoch_counts",
    "WebDatasetReader",
    "SimpleImageDataset",
]

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shard_urls(pattern: str) -> List[str]:
    """'a-{000..003}.tar' -> ['a-000.tar', ..., 'a-003.tar']."""
    m = _BRACE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


_IMG_EXTS = {".jpg", ".jpeg", ".png", ".webp"}


def iter_shard(path: str) -> Iterator[dict]:
    """Group tar members by key (webdataset convention: key.ext)."""
    with tarfile.open(path) as tf:
        current_key, sample = None, {}
        for member in tf:
            if not member.isfile():
                continue
            name = Path(member.name)
            key, ext = name.stem, name.suffix.lower()
            if key != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            data = tf.extractfile(member).read()
            if ext in _IMG_EXTS:
                sample["image_bytes"] = data
            elif ext == ".cls":
                sample["label"] = int(data.decode().strip())
            elif ext == ".txt":
                sample["text"] = data.decode("utf-8")
            elif ext == ".json":
                sample["json"] = json.loads(data)
        if current_key is not None and sample:
            yield sample


def res_ratio_ok(meta: dict, min_res: int = 256, min_ratio: float = 0.5,
                 max_ratio: float = 2.0) -> bool:
    """The text-mode json pre-filter (``filter_by_res_ratio``,
    webdataset_reader.py:34-41): h/w ratio within [min_ratio, max_ratio]
    and the longer side at least ``min_res`` — judged from shard metadata
    (original_height/original_width), before decoding."""
    h, w = meta["original_height"], meta["original_width"]
    ratio = h / w
    return min_ratio <= ratio <= max_ratio and max(h, w) >= min_res


def with_epoch_counts(num_train_examples: int, global_batch_size: int,
                      num_workers_per_device: int):
    """The reference's ``with_epoch`` worker math
    (webdataset_reader.py:198-202): each worker iterates the complete
    (resampled) dataset and is cut after ``num_worker_batches`` batches, so
    the advertised epoch length rounds UP to a multiple of the worker
    count. Returns (num_worker_batches, num_batches, num_samples)."""
    num_worker_batches = math.ceil(
        num_train_examples / (global_batch_size * num_workers_per_device))
    num_batches = num_worker_batches * num_workers_per_device
    num_samples = num_batches * global_batch_size
    return num_worker_batches, num_batches, num_samples


def _shuffled(stream, bufsize: int, initial: int, rng):
    """Streaming shuffle buffer (wds.shuffle(bufsize, initial),
    webdataset_reader.py:192-193): fill to ``initial`` before the first
    yield, then sample uniformly from a ``bufsize`` reservoir."""
    buf = []
    initial = min(initial, bufsize)
    for s in stream:
        buf.append(s)
        if len(buf) < initial:
            continue
        if len(buf) >= bufsize:
            k = int(rng.integers(len(buf)))
            buf[k], buf[-1] = buf[-1], buf[k]
            yield buf.pop()
    while buf:
        k = int(rng.integers(len(buf)))
        buf[k], buf[-1] = buf[-1], buf[k]
        yield buf.pop()


class WebDatasetReader:
    """Sharded tar reader (webdataset_reader.py:100-226).

    ``resampled=False`` (eval semantics, :219-226): one finite pass over
    this worker's ``shards[shard_index::shard_count]`` slice
    (``split_by_worker``), shard order shuffled per instance seed when
    ``train``.

    ``resampled=True`` (train semantics, :188-205): an INFINITE stream —
    shards drawn with replacement from the full list (every worker sees
    the complete dataset, per-worker seed decorrelates the draws), with a
    streaming shuffle buffer. Bound it with ``batches(..., num_batches=)``
    (the ``with_epoch`` cut) or ``itertools.islice``.

    ``mode='class'`` yields {image, label}; ``mode='text'`` yields
    {image, text, __key__} with the json res-ratio pre-filter applied
    before decode when ``res_ratio_filtering`` (:154-169)."""

    def __init__(self, shard_pattern: str, image_size: int = 256, *,
                 train: bool = True, seed: int = 0, shard_index: int = 0,
                 shard_count: int = 1, min_size: int = 0,
                 max_res_ratio: Optional[float] = None,
                 mode: str = "class", resampled: bool = False,
                 shuffle_buffer: int = 0, shuffle_initial: int = 1000,
                 res_ratio_filtering: bool = False, min_res: int = 256,
                 min_ratio: float = 0.5, max_ratio: float = 2.0):
        if mode not in ("class", "text"):
            raise ValueError(f"mode must be 'class' or 'text', got {mode!r}")
        self.all_shards = expand_shard_urls(shard_pattern)
        # split_by_worker slice; resampled streams use the full list
        # ("each worker is iterating over the complete dataset", :204)
        self.shards = self.all_shards[shard_index::shard_count]
        if not (self.all_shards if resampled else self.shards):
            raise ValueError(f"no shards for {shard_pattern!r}")
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.shard_index = shard_index
        self.min_size = min_size
        self.max_res_ratio = max_res_ratio
        self.mode = mode
        self.resampled = resampled
        self.shuffle_buffer = shuffle_buffer
        self.shuffle_initial = shuffle_initial
        self.res_ratio_filtering = res_ratio_filtering
        self.min_res = min_res
        self.min_ratio = min_ratio
        self.max_ratio = max_ratio

    # ---- raw sample stream ------------------------------------------------
    def _shard_stream(self, rng):
        if self.resampled:
            n = len(self.all_shards)
            while True:  # ResampledShards: with replacement, forever
                yield self.all_shards[int(rng.integers(n))]
        else:
            order = rng.permutation(len(self.shards)) if self.train \
                else np.arange(len(self.shards))
            for si in order:
                yield self.shards[si]

    def _samples(self, rng):
        for shard in self._shard_stream(rng):
            yield from iter_shard(shard)

    # ---- decoded/filtered/augmented stream --------------------------------
    def __iter__(self):
        rng = np.random.default_rng(self.seed + 7919 * self.shard_index
                                    if self.resampled else self.seed)
        stream = self._samples(rng)
        if self.shuffle_buffer > 0:
            stream = _shuffled(stream, self.shuffle_buffer,
                               self.shuffle_initial, rng)
        for sample in stream:
            if "image_bytes" not in sample:
                continue
            if self.mode == "text" and self.res_ratio_filtering:
                meta = sample.get("json")
                try:
                    if meta is None or not res_ratio_ok(
                            meta, self.min_res, self.min_ratio,
                            self.max_ratio):
                        continue
                except KeyError:
                    continue  # warn_and_continue on malformed metadata
            try:
                img = Image.open(io.BytesIO(sample["image_bytes"]))
                img = img.convert("RGB")
            except Exception:
                continue  # warn_and_continue (webdataset_reader.py:145)
            w, h = img.size
            if min(w, h) < self.min_size:
                continue
            if self.max_res_ratio and max(w, h) / min(w, h) > self.max_res_ratio:
                continue
            if self.train:
                arr = random_crop_arr(img, self.image_size, rng)
                if rng.random() < 0.5:
                    arr = arr[:, ::-1]
            else:
                arr = center_crop_arr(img, self.image_size)
            x = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
            out = {"image": np.ascontiguousarray(x)}
            if self.mode == "text":
                out["text"] = sample.get("text", "")
                out["__key__"] = sample["__key__"]
            else:
                out["label"] = np.int32(sample.get("label", -1))
            yield out

    def batches(self, batch_size: int, *, partial: bool = False,
                num_batches: Optional[int] = None):
        """Batch the stream. ``partial=False`` drops the tail like the
        train pipeline (wds.batched(partial=False), :195); ``partial=True``
        matches eval (:224). ``num_batches`` is the ``with_epoch`` cut —
        REQUIRED to bound a resampled stream."""
        emitted = 0
        buf = []
        for s in self:
            buf.append(s)
            if len(buf) == batch_size:
                yield self._collate(buf)
                buf = []
                emitted += 1
                if num_batches is not None and emitted >= num_batches:
                    return
        if partial and buf:
            yield self._collate(buf)

    def _collate(self, buf):
        out = {"image": np.stack([s["image"] for s in buf])}
        if self.mode == "text":
            out["text"] = [s["text"] for s in buf]
            out["__key__"] = [s["__key__"] for s in buf]
        else:
            out["label"] = np.asarray([s["label"] for s in buf])
        return out


class SimpleImageDataset:
    """Reference facade (webdataset_reader.py:100-250): an infinite
    resampled+shuffled train stream cut to ``with_epoch`` batches per
    worker, and a finite split-by-worker eval stream, with the advertised
    ``num_batches``/``num_samples`` accounting on the train loader."""

    def __init__(self, train_shards_path: str, eval_shards_path: str,
                 num_train_examples: int, per_device_batch_size: int,
                 global_batch_size: int, num_workers_per_device: int = 1,
                 crop_size: int = 256, random_crop: bool = True,
                 random_flip: bool = True, seed: int = 0,
                 dataset_with_class_label: bool = True,
                 dataset_with_text_label: bool = False,
                 res_ratio_filtering: bool = False,
                 worker_index: int = 0):
        if not (dataset_with_class_label or dataset_with_text_label):
            raise NotImplementedError  # :170-171
        mode = "text" if dataset_with_text_label else "class"
        del random_crop, random_flip  # reader applies train-time aug itself
        self._per_device_batch_size = per_device_batch_size
        (self.num_worker_batches, self.num_batches,
         self.num_samples) = with_epoch_counts(
            num_train_examples, global_batch_size, num_workers_per_device)
        self._train = WebDatasetReader(
            train_shards_path, crop_size, train=True, seed=seed,
            shard_index=worker_index, mode=mode, resampled=True,
            shuffle_buffer=5000, shuffle_initial=1000,
            res_ratio_filtering=res_ratio_filtering)
        self._eval = WebDatasetReader(
            eval_shards_path, crop_size, train=False, seed=seed,
            shard_index=worker_index, shard_count=num_workers_per_device,
            mode="class")

    @property
    def train_dataset(self):
        return self._train

    def train_dataloader(self):
        """One with_epoch-bounded pass: num_worker_batches full batches."""
        return self._train.batches(self._per_device_batch_size,
                                   partial=False,
                                   num_batches=self.num_worker_batches)

    @property
    def eval_dataset(self):
        return self._eval

    def eval_dataloader(self):
        return self._eval.batches(self._per_device_batch_size, partial=True)
