"""Dataset registry beyond ImageNet folders (counterpart of
``imagefolder_tpu/data/builders.py``; reference ``dataset/build.py:8-40``):
coco (flat folder), openimage (image_paths.json), pexels (ImageFolder),
imagenet_code (pretokenized npy codes), and the t2i jsonl family
(``dataset/t2i.py``).

Every source builds dict records with ``getitem_with_rng(idx, rng)``, as
``data/imagenet.py``'s ``ImageFolderSource`` does, so ``make_loader`` gives
the same sharded, shuffled, worker-parallel pipeline for all of them. Every
draw comes from the ``np.random.Generator`` handed in, so a record is the
JAX package's under the same generator.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image

from imagefolder_tpu_torch.data.imagenet import (
    ImageFolderLoader,
    ImageFolderSource,
    _random_crop_plan,
    center_crop_arr,
    list_image_folder,
    stable_record_rng,
)

__all__ = [
    "SingleFolderSource", "JsonPathsSource", "CodeSource",
    "Text2ImgImageSource", "Text2ImgSource", "build_dataset", "make_loader",
]


def _load_image_record(path: str, image_size: int, train: bool, idx: int,
                       hflip: bool = True, rng=None):
    """Shared decode -> ADM crop -> flip -> [-1,1] pipeline (same math as
    ImageFolderSource). ``rng`` is the loader's per-visit draw when
    loading through ``make_loader`` (per-epoch redraw); standalone access
    falls back to a stable crc32 per-record seed."""
    from imagefolder_tpu_torch.data._native import crop_flip_normalize

    img = Image.open(path).convert("RGB")
    if rng is None:
        rng = stable_record_rng(path, idx)
    if train:
        arr, oy, ox = _random_crop_plan(img, image_size, rng)
        flip = bool(hflip and rng.random() < 0.5)
        return crop_flip_normalize(arr, oy, ox, image_size, flip)
    arr = center_crop_arr(img, image_size)
    return crop_flip_normalize(np.ascontiguousarray(arr), 0, 0,
                               image_size, False)


@dataclasses.dataclass
class SingleFolderSource:
    """Flat folder of images, constant label 0 (reference coco builder,
    ``dataset/coco.py:8-27``)."""

    directory: str
    image_size: int = 256
    train: bool = True

    def __post_init__(self):
        d = self.directory
        self.files = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if os.path.isfile(os.path.join(d, f)))

    def __len__(self):
        return len(self.files)

    def getitem_with_rng(self, idx: int, rng):
        x = _load_image_record(self.files[idx], self.image_size, self.train,
                               idx, rng=rng)
        return {"image": x, "label": np.int32(0)}

    def __getitem__(self, idx: int):
        return self.getitem_with_rng(idx, None)


@dataclasses.dataclass
class JsonPathsSource:
    """``image_paths.json`` manifest relative to the data root, label 0,
    bad-image retry (reference openimage builder,
    ``dataset/openimage.py:11-45``)."""

    data_path: str
    image_size: int = 256
    train: bool = True
    retries: int = 20

    def __post_init__(self):
        manifest = Path(self.data_path) / "image_paths.json"
        if not manifest.exists():
            raise FileNotFoundError(
                f"{manifest} not found — generate the manifest first "
                "(reference: tools/openimage_json.py)")
        self.paths = json.loads(manifest.read_text())

    def __len__(self):
        return len(self.paths)

    def getitem_with_rng(self, idx: int, rng):
        # reference retries random indices 20x on decode errors
        # (openimage.py:24-30); deterministic neighbour-walk here
        for attempt in range(self.retries):
            try:
                path = os.path.join(self.data_path, self.paths[idx])
                x = _load_image_record(path, self.image_size, self.train, idx,
                                       rng=rng)
                return {"image": x, "label": np.int32(0)}
            except Exception:
                idx = (idx + 1) % len(self.paths)
        raise RuntimeError("Too many bad data.")

    def __getitem__(self, idx: int):
        return self.getitem_with_rng(idx, None)


@dataclasses.dataclass
class CodeSource:
    """Pretokenized npy codes + labels (reference imagenet_code builder,
    ``dataset/imagenet.py:8-51``): optional ten_crop_105 aug dirs mixed in
    at p=0.5, per-sample crop pick when the feature dir is a flip/ten-crop
    dump (features stored (1|2|10, ...))."""

    feature_dir: str
    label_dir: str
    num_records: Optional[int] = None

    def __post_init__(self):
        self.flip = "flip" in self.feature_dir
        aug_f = self.feature_dir.replace("ten_crop/", "ten_crop_105/")
        aug_l = self.label_dir.replace("ten_crop/", "ten_crop_105/")
        self.aug = (aug_f, aug_l) if (
            aug_f != self.feature_dir and os.path.exists(aug_f)
            and os.path.exists(aug_l)) else None
        if self.num_records is None:
            self.num_records = len([
                f for f in os.listdir(self.feature_dir) if f.endswith(".npy")])

    def __len__(self):
        return self.num_records

    def getitem_with_rng(self, idx: int, rng):
        if rng is None:  # standalone access: stable per-record seed
            rng = stable_record_rng(self.feature_dir, idx)
        fdir, ldir = self.feature_dir, self.label_dir
        if self.aug is not None and rng.random() < 0.5:
            fdir, ldir = self.aug
        feats = np.load(os.path.join(fdir, f"{idx}.npy"))
        if self.flip:
            feats = feats[:, rng.integers(feats.shape[1])]
        labels = np.load(os.path.join(ldir, f"{idx}.npy"))
        return {"tokens": feats, "label": labels}

    def __getitem__(self, idx: int):
        return self.getitem_with_rng(idx, None)


def _collect_jsonl_rows(lst_dir: str, suffix: str = ".jsonl"):
    rows = []
    for name in sorted(os.listdir(lst_dir)):
        if not name.endswith(suffix):
            continue
        fp = os.path.join(lst_dir, name)
        code_dir = name.split(".")[0]
        with open(fp) as f:
            for line_idx, line in enumerate(f):
                rows.append((json.loads(line)["image_path"], code_dir,
                             line_idx))
    return rows


@dataclasses.dataclass
class Text2ImgImageSource:
    """t2i_image: jsonl manifests -> (image, code_dir, line_idx)
    (reference ``dataset/t2i.py:10-48`` Text2ImgDatasetImg)."""

    lst_dir: str
    face_lst_dir: Optional[str] = None
    image_size: int = 256
    train: bool = True

    def __post_init__(self):
        self.rows = _collect_jsonl_rows(self.lst_dir)
        if self.face_lst_dir is not None:
            self.rows += _collect_jsonl_rows(self.face_lst_dir,
                                             suffix="_face.jsonl")

    def __len__(self):
        return len(self.rows)

    def getitem_with_rng(self, idx: int, rng):
        path, code_dir, line_idx = self.rows[idx]
        x = _load_image_record(path, self.image_size, self.train, idx, rng=rng)
        return {"image": x, "code_dir": code_dir,
                "code_name": np.int32(line_idx)}

    def __getitem__(self, idx: int):
        return self.getitem_with_rng(idx, None)


@dataclasses.dataclass
class Text2ImgSource:
    """t2i: image + padded T5 text features + causal attn mask + valid flag
    (reference ``dataset/t2i.py:51-133`` Text2ImgDataset). Bad/too-small
    images and missing feature files yield the zero dummy record with
    valid=0, exactly as upstream."""

    data_path: str
    t5_feat_path: str
    short_t5_feat_path: Optional[str] = None
    image_size: int = 256
    downsample_size: int = 16
    train: bool = True
    t5_feature_max_len: int = 120
    t5_feature_dim: int = 2048

    def __post_init__(self):
        self.rows = _collect_jsonl_rows(self.data_path)
        self.code_len = (self.image_size // self.downsample_size) ** 2
        self.max_seq_length = self.t5_feature_max_len + self.code_len

    def __len__(self):
        return len(self.rows)

    def _dummy(self):
        s = self.max_seq_length
        return {
            "image": np.zeros((self.image_size, self.image_size, 3),
                              np.float32),
            "t5_feat": np.zeros((self.t5_feature_max_len,
                                 self.t5_feature_dim), np.float32),
            "attn_mask": np.tril(np.ones((s, s), bool)),
            "valid": np.int32(0),
        }

    def getitem_with_rng(self, idx: int, rng):
        path, code_dir, code_name = self.rows[idx]
        try:
            img = Image.open(path).convert("RGB")
        except Exception:
            return self._dummy()
        if min(img.size) < self.image_size:
            return self._dummy()
        if rng is None:
            rng = stable_record_rng(path, idx)
        from imagefolder_tpu_torch.data._native import crop_flip_normalize

        if self.train:
            arr, oy, ox = _random_crop_plan(img, self.image_size, rng)
            x = crop_flip_normalize(arr, oy, ox, self.image_size,
                                    bool(rng.random() < 0.5))
        else:
            arr = center_crop_arr(img, self.image_size)
            x = crop_flip_normalize(np.ascontiguousarray(arr), 0, 0,
                                    self.image_size, False)

        t5_file = os.path.join(self.t5_feat_path, code_dir,
                               f"{code_name}.npy")
        # 30% short-caption feature swap (t2i.py:111-112)
        if self.short_t5_feat_path is not None and rng.random() < 0.3:
            t5_file = t5_file.replace(
                os.path.basename(os.path.normpath(self.t5_feat_path)),
                os.path.basename(os.path.normpath(self.short_t5_feat_path)))
        if not os.path.isfile(t5_file):
            return self._dummy()
        try:
            t5_feat = np.load(t5_file)[0]  # (len, dim)
        except Exception:
            return self._dummy()
        T, S = self.t5_feature_max_len, self.max_seq_length
        feat_len = min(T, t5_feat.shape[0])
        pad = np.zeros((T, self.t5_feature_dim), np.float32)
        pad[-feat_len:] = t5_feat[:feat_len]
        emb_mask = np.zeros((T,), np.float32)
        emb_mask[-feat_len:] = 1
        # left-padded text: causal mask with padded-text columns removed,
        # diagonal forced on (t2i.py:114-121)
        attn = np.tril(np.ones((S, S), np.float32))
        attn[:, :T] *= emb_mask[None, :]
        eye = np.eye(S, dtype=np.float32)
        attn = attn * (1 - eye) + eye
        return {"image": x, "t5_feat": pad, "attn_mask": attn.astype(bool),
                "valid": np.int32(1)}

    def __getitem__(self, idx: int):
        return self.getitem_with_rng(idx, None)


def build_dataset(name: str, **kwargs):
    """Source registry (reference ``dataset/build.py:8-40``)."""
    if name == "imagenet":
        files, labels, _ = list_image_folder(kwargs.pop("data_path"))
        return ImageFolderSource(files, labels, **kwargs)
    if name == "imagenet_code":
        code_path = kwargs.pop("code_path")
        image_size = kwargs.pop("image_size", 256)
        return CodeSource(f"{code_path}/imagenet{image_size}_codes",
                          f"{code_path}/imagenet{image_size}_labels",
                          **kwargs)
    if name == "coco":
        return SingleFolderSource(kwargs.pop("data_path"), **kwargs)
    if name == "openimage":
        return JsonPathsSource(kwargs.pop("data_path"), **kwargs)
    if name == "pexels":  # class-folder tree, like imagenet (pexels.py:3-4)
        files, labels, _ = list_image_folder(kwargs.pop("data_path"))
        return ImageFolderSource(files, labels, **kwargs)
    if name == "t2i_image":
        return Text2ImgImageSource(**kwargs)
    if name == "t2i":
        return Text2ImgSource(**kwargs)
    raise ValueError(f"dataset {name} is not supported")


def make_loader(source, batch_size: int, *, train: bool = True, seed: int = 0,
                num_workers: int = 8, num_epochs: Optional[int] = None,
                shard_index: int = 0, shard_count: int = 1,
                drop_remainder: bool = True) -> ImageFolderLoader:
    """The port's loader (``data/imagenet.py``'s ``ImageFolderLoader``: a
    ``torch.utils.data`` pipeline, sharded by process, shuffled per epoch
    in its own order when ``train``, a per-visit augmentation rng, exact
    resume through its iterator's state) over any registry source. A
    record's arrays are stacked into tensors and its strings into lists;
    a val loader (``train=False``) gives the JAX ``make_loader``'s batches
    in the same order."""
    return ImageFolderLoader(source, batch_size, train=train, seed=seed,
                             num_workers=num_workers, num_epochs=num_epochs,
                             shard_index=shard_index, shard_count=shard_count,
                             drop_remainder=drop_remainder)
