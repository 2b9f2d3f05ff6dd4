"""ImageNet-folder input pipeline (counterpart of
``imagefolder_tpu/data/imagenet.py``): ImageFolder class discovery, ADM's
center and random crops (``dataset/augmentation.py``, Pillow's BOX and
BICUBIC resizes), a horizontal flip, [-1, 1] normalisation in one native
pass (``data/_native``), worker processes of ``torch.utils.data``, and a
prefetch that copies pinned batches to the card on a side stream.

The loader is the port's own; the JAX package's is grain's. Both shard the
records by process (a train loader drops the remainder so that every
process sees as many batches) and draw each visit's augmentation afresh
from the seed. A val loader (``train=False``) reads the records in order
and gives the JAX loader's batches bit for bit. A train loader shuffles
each epoch by ``np.random.default_rng((seed, epoch))``, an order of its
own: grain's cannot be reproduced. Its ``state()`` (the epoch and the
batches consumed) restores the exact batch order on resume.

Batches are {"image": float32 (B, H, W, 3), "label": int32 (B,)} CPU
tensors; ``device_prefetch`` moves them to the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import zlib
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["center_crop_arr", "random_crop_arr", "list_image_folder", "stable_record_rng",
           "ImageFolderSource", "make_dataloader", "device_prefetch", "PrefetchIterator"]

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG", ".PNG"}


def _halve_then_resize(pil_image, smaller: int):
    """ADM's resize: halve with BOX while the short side is at least twice
    ``smaller``, then BICUBIC to a short side of ``smaller``."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = smaller / min(*pil_image.size)
    return pil_image.resize(tuple(round(x * scale) for x in pil_image.size),
                            resample=Image.BICUBIC)


def center_crop_arr(pil_image, image_size: int) -> np.ndarray:
    """ADM center crop (dataset/augmentation.py:8-28)."""
    arr = np.array(_halve_then_resize(pil_image, image_size))
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy:cy + image_size, cx:cx + image_size]


def _random_crop_plan(pil_image, image_size: int, rng: np.random.Generator,
                      min_crop_frac: float = 0.8, max_crop_frac: float = 1.0):
    """ADM random crop's resize and offsets: (resized uint8 array, oy, ox),
    so that the crop runs in the native pass."""
    min_s = math.ceil(image_size / max_crop_frac)
    max_s = math.ceil(image_size / min_crop_frac)
    smaller = int(rng.integers(min_s, max_s + 1))
    arr = np.asarray(_halve_then_resize(pil_image, smaller))
    oy = int(rng.integers(arr.shape[0] - image_size + 1))
    ox = int(rng.integers(arr.shape[1] - image_size + 1))
    return arr, oy, ox


def random_crop_arr(pil_image, image_size: int, rng: np.random.Generator,
                    min_crop_frac: float = 0.8, max_crop_frac: float = 1.0) -> np.ndarray:
    """ADM random crop (dataset/augmentation.py:31-60)."""
    arr, oy, ox = _random_crop_plan(pil_image, image_size, rng, min_crop_frac, max_crop_frac)
    return arr[oy:oy + image_size, ox:ox + image_size]


def list_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """torchvision-ImageFolder-compatible scan: class dirs sorted
    lexicographically -> class ids."""
    rootp = Path(root)
    classes = sorted(d.name for d in rootp.iterdir() if d.is_dir())
    files, labels = [], []
    for ci, cname in enumerate(classes):
        for f in sorted((rootp / cname).rglob("*")):
            if f.suffix in _EXTS:
                files.append(str(f))
                labels.append(ci)
    return files, labels, classes


def stable_record_rng(key: str, idx: int) -> np.random.Generator:
    """Deterministic per-record rng for standalone ``source[idx]`` access:
    crc32 (stable across processes and resumes, unlike salted ``hash()``)
    mixed with the record index."""
    return np.random.default_rng((zlib.crc32(key.encode()) ^ idx) & 0x7FFFFFFF)


@dataclasses.dataclass
class ImageFolderSource:
    """Random access over an image folder. Through ``make_dataloader`` every
    visit draws its augmentation from a fresh rng (the reference's per-visit
    ``torch.rand``); standalone ``source[idx]`` uses ``stable_record_rng``."""

    files: Sequence[str]
    labels: Sequence[int]
    image_size: int = 256
    train: bool = True
    hflip: bool = True

    def __len__(self):
        return len(self.files)

    def getitem_with_rng(self, idx: int, rng: np.random.Generator) -> dict:
        from PIL import Image

        from imagefolder_tpu_torch.data._native import crop_flip_normalize

        # bad-image retry (reference dataset/openimage.py:24-30): a
        # neighbouring record instead of a dead worker
        for _ in range(4):
            try:
                img = Image.open(self.files[idx]).convert("RGB")
                break
            except Exception:
                idx = (idx + 1) % len(self.files)
        else:
            img = Image.new("RGB", (self.image_size, self.image_size))
        if self.train:
            arr, oy, ox = _random_crop_plan(img, self.image_size, rng)
            flip = bool(self.hflip and rng.random() < 0.5)
            x = crop_flip_normalize(arr, oy, ox, self.image_size, flip)
        else:
            arr = center_crop_arr(img, self.image_size)
            x = crop_flip_normalize(np.ascontiguousarray(arr), 0, 0, self.image_size, False)
        return {"image": x, "label": np.int32(self.labels[idx])}

    def __getitem__(self, idx: int) -> dict:
        return self.getitem_with_rng(idx, stable_record_rng(self.files[idx], idx))


class _VisitDataset(torch.utils.data.Dataset):
    """Builds the record of a visit key: a train visit (epoch, record index)
    draws from an rng seeded from (seed, epoch, index); a val visit
    (epoch, record index, sampler index) from the rng the JAX package's
    grain sampler hands that visit, Philox(key=seed + sampler index), so
    that a source that draws in val too (``data/builders.py``'s
    ``CodeSource``) gives the JAX loader's records."""

    def __init__(self, source, seed: int):
        self.source, self.seed = source, seed

    def __len__(self):
        return len(self.source)

    def __getitem__(self, key):
        if len(key) == 3:
            _, idx, visit = key
            rng = np.random.Generator(np.random.Philox(key=self.seed + visit))
        else:
            epoch, idx = key
            rng = np.random.default_rng((self.seed, epoch, idx))
        return self.source.getitem_with_rng(idx, rng)


def _collate(records: list) -> dict:
    """A batch of records: each field's arrays (or numpy scalars) stacked
    into one tensor, its strings kept as a list."""
    return {k: [r[k] for r in records] if isinstance(records[0][k], str)
            else torch.from_numpy(np.stack([np.asarray(r[k]) for r in records]))
            for k in records[0]}


class ImageFolderLoader:
    """Batches of one process's shard of ``source`` (any source with
    ``getitem_with_rng``: ``ImageFolderSource`` or one of
    ``data/builders.py``'s). Iterating gives a ``LoaderIterator`` from the
    start; ``num_epochs`` None repeats for ever."""

    def __init__(self, source: ImageFolderSource, batch_size: int, *, train: bool, seed: int,
                 num_workers: int, num_epochs: Optional[int], shard_index: int,
                 shard_count: int, drop_remainder: bool):
        n = len(source)
        if train:  # grain's ShardOptions(drop_remainder=True): equal shards
            per = n // shard_count
            lo, hi = shard_index * per, (shard_index + 1) * per
        else:
            lo, hi = shard_index * n // shard_count, (shard_index + 1) * n // shard_count
        self.shard = np.arange(lo, hi)
        self.shard_index, self.shard_count = shard_index, shard_count
        self.source, self.batch_size, self.train, self.seed = source, batch_size, train, seed
        self.num_epochs, self.drop_remainder = num_epochs, drop_remainder
        # keep every worker at a batch or more, as the JAX loader does
        self.num_workers = max(0, min(num_workers, len(self.shard) // max(batch_size, 1)))
        self.identity = {"records": n, "shard": [int(lo), int(hi)], "batch_size": batch_size,
                         "train": train, "seed": seed}

    def epoch_batches(self, epoch: int) -> List[List[tuple]]:
        """The visit keys of each batch of ``epoch`` (``_VisitDataset``): in
        val the sampler index is grain's, the k-th visit of this shard
        being k * shard_count + shard_index."""
        order = self.shard
        if self.train:
            order = order[np.random.default_rng((self.seed, epoch)).permutation(len(order))]
            keys = [(epoch, int(i)) for i in order]
        else:
            first = epoch * len(order)
            keys = [(epoch, int(i), (first + k) * self.shard_count + self.shard_index)
                    for k, i in enumerate(order)]
        stop = len(keys) - len(keys) % self.batch_size if self.drop_remainder else len(keys)
        return [keys[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self) -> "LoaderIterator":
        return LoaderIterator(self)


class LoaderIterator:
    """Batches in order, with ``get_state()`` (bytes: the epoch and the
    batches consumed in it) and ``set_state()``, which continues the exact
    batch stream from there."""

    def __init__(self, loader: ImageFolderLoader, epoch: int = 0, batch: int = 0):
        self.loader = loader
        self._start(epoch, batch)

    def _start(self, epoch: int, batch: int):
        self.epoch, self.batch = epoch, batch
        lo = self.loader
        if lo.num_epochs is not None and epoch >= lo.num_epochs:
            self._it = iter(())
            return
        plan = lo.epoch_batches(epoch)[batch:]
        dl = torch.utils.data.DataLoader(
            _VisitDataset(lo.source, lo.seed), batch_sampler=plan, collate_fn=_collate,
            num_workers=lo.num_workers, persistent_workers=False)
        self._it = iter(dl)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            try:
                b = next(self._it)
            except StopIteration:
                lo = self.loader
                if (lo.num_epochs is not None and self.epoch + 1 >= lo.num_epochs) \
                        or not lo.epoch_batches(self.epoch + 1):
                    raise
                self._start(self.epoch + 1, 0)
                continue
            self.batch += 1
            return b

    def get_state(self) -> bytes:
        return json.dumps({**self.loader.identity, "epoch": self.epoch,
                           "batch": self.batch}).encode()

    def set_state(self, state: bytes):
        d = json.loads(bytes(state))
        if {k: d.get(k) for k in self.loader.identity} != self.loader.identity:
            raise ValueError(f"data state of another loader: {d} vs {self.loader.identity}")
        self._start(d["epoch"], d["batch"])


def make_dataloader(root: str, batch_size: int, image_size: int = 256, *, train: bool = True,
                    seed: int = 0, num_workers: int = 8, num_epochs: Optional[int] = None,
                    shard_index: int = 0, shard_count: int = 1,
                    drop_remainder: bool = True) -> ImageFolderLoader:
    """A loader over an ImageFolder tree (reference DataLoader +
    DistributedSampler, xqgan_train.py:232-247): shuffled per epoch when
    ``train``, sharded by process, per-visit augmentation."""
    files, labels, _ = list_image_folder(root)
    source = ImageFolderSource(files, labels, image_size, train)
    return ImageFolderLoader(source, batch_size, train=train, seed=seed,
                             num_workers=num_workers, num_epochs=num_epochs,
                             shard_index=shard_index, shard_count=shard_count,
                             drop_remainder=drop_remainder)


class PrefetchIterator:
    """Keeps ``size`` batches in flight on ``device`` (reference
    CUDA-stream prefetcher, datasets/prefetcher.py:64-119): on the card each
    batch is pinned and copied on a side stream, and the consumer's stream
    waits for that copy before it reads the batch; on the CPU the batches
    pass through.

    ``state`` is the wrapped iterator's state as of the last batch
    consumed, not the prefetched-ahead one, so a resumed run continues the
    unbroken batch stream (the reference's
    ``DistInfiniteBatchSampler.start_ep/start_it``,
    utils/data_sampler.py:67-103)."""

    def __init__(self, it: Iterator, size: int = 2, device: torch.device | str = "cuda"):
        import collections

        self._it = iter(it)
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._queue = collections.deque()
        self._state = self._snapshot()
        for _ in range(size):
            self._pull()

    def _snapshot(self):
        get = getattr(self._it, "get_state", None)
        return get() if get is not None else None

    def _pull(self):
        try:
            batch = next(self._it)
        except StopIteration:
            return
        event = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                batch = {k: v.pin_memory().to(self._device, non_blocking=True)
                         for k, v in batch.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        self._queue.append((batch, event, self._snapshot()))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if not self._queue:
            raise StopIteration
        batch, event, state = self._queue.popleft()
        if event is not None:
            torch.cuda.current_stream(self._device).wait_event(event)
            for v in batch.values():  # the side stream's memory is read on this one
                v.record_stream(torch.cuda.current_stream(self._device))
        if state is not None:
            self._state = state
        self._pull()
        return batch

    @property
    def state(self):
        """The wrapped iterator's state, resuming after the last consumed
        batch (None where the iterator has none)."""
        return self._state


def device_prefetch(it: Iterator, size: int = 2,
                    device: torch.device | str = "cuda") -> PrefetchIterator:
    return PrefetchIterator(it, size, device)
