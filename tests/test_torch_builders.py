"""Port parity, the dataset registry: ``imagefolder_tpu_torch/data/builders.py``
against ``imagefolder_tpu/data/builders.py`` on the CPU, over small trees
made from a seed:

- coco (``SingleFolderSource``: a flat folder), openimage
  (``JsonPathsSource``: ``image_paths.json``, a bad file walked past),
  imagenet_code (``CodeSource``: npy codes and labels, the ten_crop_105
  mix-in and the flip/ten-crop pick), t2i_image (``Text2ImgImageSource``:
  jsonl manifests, the ``_face`` list) and t2i (``Text2ImgSource``: the
  left-padded T5 features, the causal mask with the padded columns removed,
  the 30% short-caption swap, and the zero dummy record for a missing
  feature file, a bad image and an image too small): every record
  bit-equal to the JAX source's under the same ``np.random.Generator``
  (``getitem_with_rng``), train and val, and through ``__getitem__``'s
  stable per-record seed; ``build_dataset`` by name;
- ``make_loader``: val batches (``train=False``, the ragged last batch
  kept) bit-equal to the JAX ``make_loader``'s (grain, no worker
  processes), strings included; a train loader visits every record once an
  epoch and resumes its exact batch stream from its iterator's state.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from imagefolder_tpu.data import builders as jax_b
from imagefolder_tpu_torch.data import builders as pt_b
from tests._torch_parity import one_torch_thread  # noqa: F401

PX = 32
T5_LEN, T5_DIM = 6, 4


def _png(path, rng, h, w):
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("builders")
    rng = np.random.default_rng(0)
    sizes = [(40, 40), (37, 52), (70, 33), (64, 90), (33, 48)]
    coco = root / "coco"
    coco.mkdir()
    for i in range(7):
        _png(coco / f"{i:03d}.png", rng, *sizes[i % len(sizes)])
    # openimage: relative paths, one of them not an image
    oi = root / "openimage"
    (oi / "a").mkdir(parents=True)
    paths = []
    for i in range(5):
        _png(oi / "a" / f"{i}.png", rng, *sizes[i])
        paths.append(f"a/{i}.png")
    (oi / "a" / "bad.png").write_bytes(b"not an image")
    paths.insert(2, "a/bad.png")
    (oi / "image_paths.json").write_text(json.dumps(paths))
    # imagenet_code: flip dumps (2, ...) in a ten_crop dir with its 105 mix-in
    codes = root / "codes" / "ten_crop"
    aug = root / "codes" / "ten_crop_105"
    for d in ("flip_codes", "flip_labels"):
        (codes / d).mkdir(parents=True)
        (aug / d).mkdir(parents=True)
    for i in range(6):
        for base, off in ((codes, 0), (aug, 1000)):
            np.save(base / "flip_codes" / f"{i}.npy",
                    rng.integers(0, 512, (1, 2, 16)) + off)
            np.save(base / "flip_labels" / f"{i}.npy", np.array([i % 3]))
    plain = root / "plain" / "imagenet32_codes"
    plain_l = root / "plain" / "imagenet32_labels"
    plain.mkdir(parents=True)
    plain_l.mkdir(parents=True)
    for i in range(4):
        np.save(plain / f"{i}.npy", rng.integers(0, 512, (1, 16)))
        np.save(plain_l / f"{i}.npy", np.array([i]))
    # t2i: manifests, images (one bad, one too small), T5 features, short ones
    t2i, lst, face = root / "t2i", root / "t2i" / "lst", root / "t2i" / "face"
    for d in (lst, face, t2i / "img"):
        d.mkdir(parents=True)
    rows = {"part0": [], "part1": []}
    for i in range(6):
        p = t2i / "img" / f"{i}.png"
        if i == 3:
            p.write_bytes(b"broken")
        else:
            _png(p, rng, *((20, 20) if i == 4 else sizes[i % len(sizes)]))
        rows["part0" if i < 4 else "part1"].append({"image_path": str(p)})
    for name, rs in rows.items():
        (lst / f"{name}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rs))
    # the readable rows only, for the t2i_image loader (it has no dummy record)
    (t2i / "lst_ok").mkdir()
    (t2i / "lst_ok" / "part0.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for i, r in enumerate(rows["part0"] + rows["part1"])
                if i != 3))
    (face / "x_face.jsonl").write_text(json.dumps({"image_path": str(t2i / "img" / "0.png")})
                                       + "\n")
    (face / "ignored.jsonl").write_text(json.dumps({"image_path": "nowhere.png"}) + "\n")
    for feat_dir, scale in (("t5", 1.0), ("t5_short", -1.0)):
        for part, n in (("part0", 4), ("part1", 1)):  # part1's second row has none
            (t2i / feat_dir / part).mkdir(parents=True)
            for line in range(n):
                length = 3 + 2 * line  # some shorter and one longer than T5_LEN
                np.save(t2i / feat_dir / part / f"{line}.npy",
                        scale * rng.normal(size=(1, length, T5_DIM)).astype(np.float32))
    return root


def _sources(root, train: bool, t2i_image_lst: str = "lst"):
    """(name, JAX source, port source) for every source kind."""
    t2i = root / "t2i"
    t2i_kw = dict(data_path=str(t2i / "lst"), t5_feat_path=str(t2i / "t5"),
                  short_t5_feat_path=str(t2i / "t5_short"), image_size=PX, downsample_size=8,
                  train=train, t5_feature_max_len=T5_LEN, t5_feature_dim=T5_DIM)
    specs = [
        ("coco", "SingleFolderSource", (str(root / "coco"),), dict(image_size=PX, train=train)),
        ("openimage", "JsonPathsSource", (str(root / "openimage"),),
         dict(image_size=PX, train=train)),
        ("imagenet_code flip", "CodeSource",
         (str(root / "codes" / "ten_crop" / "flip_codes"),
          str(root / "codes" / "ten_crop" / "flip_labels")), {}),
        ("t2i_image", "Text2ImgImageSource", (str(t2i / t2i_image_lst),),
         dict(face_lst_dir=str(t2i / "face"), image_size=PX, train=train)),
        ("t2i", "Text2ImgSource", (), t2i_kw),
    ]
    return [(name, getattr(jax_b, cls)(*a, **kw), getattr(pt_b, cls)(*a, **kw))
            for name, cls, a, kw in specs]


def _assert_records_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, str):
            assert g == w, f"{what} {k}"
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _same_record(get_port, get_jax, what: str):
    """Both records equal, or both calls raising the same exception type
    (t2i_image, like upstream, has no dummy for an image it cannot read)."""
    try:
        want = get_jax()
    except Exception as e:  # noqa: BLE001 - the JAX source's own failure
        with pytest.raises(type(e)):
            get_port()
        return False
    _assert_records_equal(get_port(), want, what)
    return True


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_records_match_jax_under_the_same_generator(trees, train):
    for name, jsrc, psrc in _sources(trees, train):
        assert len(psrc) == len(jsrc) > 0, name
        built = 0
        for idx in range(len(jsrc)):
            for seed in (0, 11):
                built += _same_record(
                    lambda: psrc.getitem_with_rng(idx, np.random.default_rng(seed)),
                    lambda: jsrc.getitem_with_rng(idx, np.random.default_rng(seed)),
                    f"{name}[{idx}] seed {seed}")
            _same_record(lambda: psrc[idx], lambda: jsrc[idx], f"{name}[{idx}] stable seed")
        assert built >= 2 * (len(jsrc) - 1), name


def test_t2i_records_cover_the_dummy_and_the_swap(trees):
    """The t2i source's branches are reached: dummy records (bad image, too
    small, missing features) and real ones, and the short-caption swap
    taken under some seed and not under another."""
    _, jsrc, psrc = _sources(trees, True)[-1]
    valid = [int(psrc[i]["valid"]) for i in range(len(psrc))]
    assert valid == [1, 1, 1, 0, 0, 0]
    swapped = {psrc.getitem_with_rng(1, np.random.default_rng(s))["t5_feat"][-1, 0]
               for s in range(12)}
    assert len(swapped) == 2  # the long caption's and the short one's (negated)
    rec = psrc.getitem_with_rng(0, np.random.default_rng(0))
    s = T5_LEN + (PX // 8) ** 2
    assert rec["attn_mask"].shape == (s, s) and rec["attn_mask"].dtype == bool
    assert rec["attn_mask"][:, :T5_LEN - 3].sum() == T5_LEN - 3  # padded text: diagonal only


def test_build_dataset_by_name(trees):
    cases = [("coco", dict(data_path=str(trees / "coco"), image_size=PX)),
             ("openimage", dict(data_path=str(trees / "openimage"), image_size=PX)),
             ("imagenet_code", dict(code_path=str(trees / "plain"), image_size=32)),
             ("pexels", dict(data_path=str(trees / "t2i"), image_size=PX)),
             ("t2i_image", dict(lst_dir=str(trees / "t2i" / "lst"), image_size=PX))]
    for name, kw in cases:
        j, p = jax_b.build_dataset(name, **dict(kw)), pt_b.build_dataset(name, **dict(kw))
        assert type(p).__name__ == type(j).__name__ and len(p) == len(j), name
        for idx in range(len(j)):
            _same_record(lambda: p.getitem_with_rng(idx, np.random.default_rng(idx)),
                         lambda: j.getitem_with_rng(idx, np.random.default_rng(idx)),
                         f"{name}[{idx}]")
    for mod in (jax_b, pt_b):
        with pytest.raises(ValueError, match="not supported"):
            mod.build_dataset("cifar")


def _as_numpy(batch: dict) -> dict:
    return {k: v if isinstance(v, list) else np.asarray(v) for k, v in batch.items()}


def test_val_batches_match_jax(trees):
    for name, jsrc, psrc in _sources(trees, False, t2i_image_lst="lst_ok"):
        want = list(jax_b.make_loader(jsrc, 4, train=False, num_epochs=1, num_workers=0,
                                      drop_remainder=False))
        got = list(pt_b.make_loader(psrc, 4, train=False, num_epochs=1, num_workers=0,
                                    drop_remainder=False))
        assert len(got) == len(want) == -(-len(jsrc) // 4), name
        for i, (g, w) in enumerate(zip(got, want)):
            w = {k: [str(s) for s in v] if np.asarray(v).dtype.kind in "UO" else v
                 for k, v in w.items()}
            _assert_records_equal(_as_numpy(g), w, f"{name} batch {i}")
            assert all(isinstance(v, (list, torch.Tensor)) for v in g.values())


def test_train_loader_covers_every_record_and_resumes(trees):
    src = pt_b.SingleFolderSource(str(trees / "coco"), image_size=PX, train=True)
    loader = pt_b.make_loader(src, 2, train=True, seed=3, num_workers=0, drop_remainder=False)
    it = iter(loader)
    epoch0 = [next(it) for _ in range(4)]
    assert sum(len(b["label"]) for b in epoch0) == len(src) == 7
    first = next(it)  # epoch 1, batch 0
    state = it.get_state()
    rest = [next(it) for _ in range(3)]
    resumed = iter(loader)
    resumed.set_state(state)
    for want in rest:
        np.testing.assert_array_equal(next(resumed)["image"].numpy(), want["image"].numpy())
    assert not torch.equal(first["image"], epoch0[0]["image"])
