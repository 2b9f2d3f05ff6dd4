"""Port parity, ``scripts/e2e_pipeline.py``'s helpers: the port's
``imagefolder_tpu_torch/scripts/e2e_pipeline.py`` against the JAX script on
the CPU: the procedural class-structured dataset (``make_dataset``: every
PNG byte for byte), the YAML writer, the sample grid and the
nearest-pool-neighbour grade on an npz made from that dataset and from
noise; and ``latest_ckpt`` on the port CLIs' checkpoint layout
(``ckpts/step_<step>.pt``). The nine stages themselves take minutes on this
CPU (each a CLI in a process of its own), so they run on the card in
``chip_smoke.py``.
"""

import numpy as np
import pytest
from PIL import Image

from imagefolder_tpu_torch.scripts import e2e_pipeline as pt_e2e
from scripts import e2e_pipeline as jax_e2e
from tests._torch_parity import one_torch_thread  # noqa: F401

CLASSES, PER_CLASS, PX = 3, 4, 32


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    pt_e2e.make_dataset(root / "pt", CLASSES, PER_CLASS, PX, seed=1)
    jax_e2e.make_dataset(root / "jax", CLASSES, PER_CLASS, PX, seed=1)
    return root


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*.png"))


def test_make_dataset_byte_equal(pools):
    names = _files(pools / "pt")
    assert names == _files(pools / "jax") and len(names) == CLASSES * PER_CLASS
    for n in names:
        assert (pools / "pt" / n).read_bytes() == (pools / "jax" / n).read_bytes(), n


def test_write_yaml_equal(tmp_path):
    kv = dict(cloud_save_path=tmp_path / "tok", v_patch_nums=[1, 2, 4], product_quant=2,
              enc_type="cnn", lr=8e-4, ema="true", data_path=tmp_path / "ds")
    pt_e2e.write_yaml(tmp_path / "pt.yaml", **kv)
    jax_e2e.write_yaml(tmp_path / "jax.yaml", **kv)
    assert (tmp_path / "pt.yaml").read_text() == (tmp_path / "jax.yaml").read_text()


@pytest.mark.parametrize("cols", [8, 5])
def test_grade_and_grid_equal(pools, tmp_path, cols):
    """Samples drawn from the pool (some with the requested class, some
    not) and from noise: the grade's every field and the grid's PNG."""
    rng = np.random.default_rng(cols)
    pool = [np.asarray(Image.open(pools / "pt" / n)) for n in _files(pools / "pt")]
    n = 7
    arr = np.stack([pool[int(rng.integers(len(pool)))] if i % 3 else
                    rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8) for i in range(n)])
    npz = tmp_path / "s.npz"
    np.savez(npz, arr_0=arr)
    got = pt_e2e.grade_samples(npz, pools / "pt", CLASSES, n)
    want = jax_e2e.grade_samples(npz, pools / "jax", CLASSES, n)
    assert got == want
    assert 0.0 <= got["class_fidelity"] <= 1.0 and len(got["per_class_fidelity"]) == CLASSES
    pt_e2e.save_grid(npz, tmp_path / "pt.png", cols)
    jax_e2e.save_grid(npz, tmp_path / "jax.png", cols)
    assert (tmp_path / "pt.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_latest_ckpt_picks_the_highest_step(tmp_path):
    (tmp_path / "ckpts").mkdir()
    for step in (2, 10, 9):
        (tmp_path / "ckpts" / f"step_{step:08d}.pt").write_bytes(b"")
    assert pt_e2e.latest_ckpt(tmp_path) == tmp_path / "ckpts" / "step_00000010.pt"
