"""What the tests of the port's evaluation CLIs share
(``test_torch_cli_eval.py``, ``test_torch_cli_fid.py``,
``test_torch_validation.py``): one tiny tokenizer (width 64, depth 1, 2
heads; 64 px, 16 latents, a 32 x 8 codebook) whose JAX parameters
(numpy-drawn) are exported with ``export_vqmodel`` to a ``.pt`` with its
YAML, a folder of 8 PNGs, two npz batches of 16 images, and a fabricated
Inception ``.pth`` (``fabricated_inception_sd``: random weights, so every
FID in these tests checks plumbing, not a number to report).

Both packages' Inception resizes its input to 75 px in these tests, not 299
(the smallest side the network takes; Mixed_6e's map is then 3 x 3): the
protocol is the same and the compute a sixteenth, which keeps these files
inside their time budget on one CPU thread. ``test_torch_eval.py`` holds
the 299 px network itself against the JAX package's.

At 8 or 16 images the covariances have rank 7 or 15, and scipy's ``sqrtm``
of a 2048-wide product takes tens of seconds on a CPU. So every Frechet distance
in those tests, the JAX package's and the port's alike, goes through one
exact low-rank evaluation (``lowrank_frechet``: the nonzero eigenvalues of
sigma1 sigma2 are those of R^T sigma2 R with sigma1 = R R^T);
``test_torch_eval.py`` holds the port's ``frechet_distance`` itself against
the JAX package's. ``captured`` records the features each side hands to
``compute_statistics``.
"""

import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

import imagefolder_tpu.data.imagenet as jax_data
import imagefolder_tpu.eval.fid as jax_fid
import imagefolder_tpu.eval.validation as jax_val
from imagefolder_tpu.models import vit as jax_vit
from imagefolder_tpu.models.tokenizer import ModelArgs as JaxArgs
from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu.utils.convert_torch import export_vqmodel
import imagefolder_tpu_torch.eval.fid as pt_fid
import imagefolder_tpu_torch.eval.validation as pt_val
from imagefolder_tpu_torch.eval.inception import InceptionV3 as PtInception
from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.scripts import eval_reconstruction as pt_eval
from tests._torch_parity import random_params

TINY = "tiny_eval_vit"
TINY_PRESET = dict(embed_dim=64, depth=1, num_heads=2)
PX = 64
CFG = dict(codebook_size=32, codebook_embed_dim=8, v_patch_nums=[4], enc_type="dinov2",
           dec_type="dinov2", encoder_model=TINY, decoder_model=TINY, semantic_guide="none",
           detail_guide="none", num_latent_tokens=16, abs_pos_embed=True, image_size=PX)
PERTURB = ["0.5", "0.5", "4"]
INCEPTION_PX = 75


def lowrank_frechet(mu1, sigma1, mu2, sigma2, eps=1e-6):
    w, u = np.linalg.eigh(sigma1)
    keep = w > w.max() * 1e-10
    r = u[:, keep] * np.sqrt(w[keep])
    tr = np.sqrt(np.clip(np.linalg.eigvalsh(r.T @ sigma2 @ r), 0, None)).sum()
    diff = np.asarray(mu1) - np.asarray(mu2)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_PRESETS, TINY, TINY_PRESET)
        mp.setitem(pt_vit.VIT_PRESETS, TINY, TINY_PRESET)
        for mod in (jax_fid, pt_fid, jax_val, pt_val):
            mp.setattr(mod, "frechet_distance", lowrank_frechet)
        mp.setattr(PtInception, "input_size", INCEPTION_PX)
        resize = jax.image.resize

        def small(x, shape, method, *a, **k):  # only the JAX Inception's 299 x 299
            if tuple(shape[1:3]) == (299, 299):
                shape = (shape[0], INCEPTION_PX, INCEPTION_PX, shape[3])
            return resize(x, shape, method, *a, **k)

        mp.setattr(jax.image, "resize", small)
        # both CLIs' val loaders without worker processes
        for mod in (jax_data, pt_eval):
            make = mod.make_dataloader
            mp.setattr(mod, "make_dataloader",
                       lambda *a, _make=make, **k: _make(*a, **{**k, "num_workers": 0}))
        yield


@pytest.fixture
def captured(monkeypatch):
    """The features each package's ``compute_statistics`` receives."""
    feats = {"jax": [], "port": []}
    for tag, mod in (("jax", jax_fid), ("port", pt_fid)):
        def record(x, _orig=mod.compute_statistics, _tag=tag):
            feats[_tag].append(np.asarray(x))
            return _orig(x)
        monkeypatch.setattr(mod, "compute_statistics", record)
        val = jax_val if tag == "jax" else pt_val
        monkeypatch.setattr(val, "compute_statistics", record)
    return feats


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    jargs = JaxArgs(**{**CFG, "v_patch_nums": (4,)})
    params = random_params(JaxVQModel(jargs), jnp.zeros((1, PX, PX, 3)), train=False, seed=3)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                export_vqmodel(params, jargs).items()}, root / "tok.pt")
    (root / "cfg.yaml").write_text(yaml.safe_dump(CFG))
    rng = np.random.default_rng(0)
    val = root / "val" / "c0"
    val.mkdir(parents=True)
    for i in range(8):
        h, w = rng.integers(PX, 2 * PX + 10, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(val / f"{i}.png")
    torch.save(fabricated_inception_sd(), root / "inc.pth")
    for name, seed in (("ref", 1), ("sample", 2)):
        np.savez(root / f"{name}.npz", arr_0=waves(16, 32, seed))
    return root, jargs, params


def waves(n: int, px: int, seed: int) -> np.ndarray:
    """n uint8 (px, px, 3) images of diagonal waves, each of its own
    frequency and per-channel phase: images whose features differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:px, :px] / px
    freq = rng.uniform(0.5, 4, (n, 1, 1, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3))
    return (127.5 + 127.5 * np.sin(2 * np.pi * freq * (xx + 2 * yy)[None, :, :, None] + phase)
            ).astype(np.uint8)


def fabricated_inception_sd() -> dict:
    """A pytorch-fid-layout state dict over the port's own keys and shapes
    (no JAX trace), drawn from ``default_rng(0)``: kernels N(0, 2 / fan_in)
    (He's, so that activations stay of order 1 and the features of two
    images differ by more than fp32 rounding of their norms, which the
    evaluator's k-NN distances subtract), BN scales and variances U(0.5,
    1.5), the rest N(0, 0.1^2), ``fc`` scaled by 0.02 (logits of order
    1)."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in PtInception(device="cpu").state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("conv.weight") or k == "fc.weight":
            x = rng.normal(0, np.sqrt(2.0 / v[0].numel()), v.shape)
        elif k.endswith(("bn.weight", "running_var")):
            x = rng.uniform(0.5, 1.5, v.shape)
        else:
            x = rng.normal(0, 0.1, v.shape)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    sd["fc.weight"] = sd["fc.weight"] * 0.02
    sd["fc.bias"] = sd["fc.bias"] * 0.02
    return sd


def printed(text: str, key: str) -> float:
    return float(re.search(rf"^{key}: ([-\d.eE+]+)$", text, re.M).group(1))


def close_feats(got, want, tol=1e-3):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


