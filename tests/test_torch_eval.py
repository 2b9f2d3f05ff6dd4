"""Port parity, the evaluation layer: ``imagefolder_tpu_torch/eval`` on the
CPU against the JAX package's ``imagefolder_tpu/eval``.

- ``fid``: ``compute_statistics``, ``frechet_distance`` (also through its
  eps fallback), ``inception_score`` and ``precision_recall`` on the same
  features (64-wide, so that scipy's sqrtm stays cheap), to 1e-6 relative;
- ``psnr`` and ``ssim`` on the same NHWC batches, to 1e-5;
- ``InceptionV3``: the JAX package's ``fabricate_inception_state_dict(0)``
  written to a ``.pth`` loads with strict=True (``load_inception``), and
  its ``pool3``, ``spatial`` and ``softmax`` match the JAX ``InceptionV3``
  under ``convert_inception_checkpoint`` of the same dict within 1e-4 of
  their max, at 256 and 512 px inputs (B = 2; the JAX resize is
  antialiased bilinear, which from 512 px is not ``F.interpolate``'s plain
  bilinear); the port in fp32 with oneDNN off (TF32-like weight products
  on some CPUs otherwise);
- ``_gather_rows`` across a 2-process gloo group on the CPU
  (``tests/_torch_dist_worker.py``): ragged row counts, concatenated in
  process order.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagefolder_tpu.eval import fid as jax_fid
from imagefolder_tpu.eval.inception import (
    InceptionV3 as JaxInception,
    convert_inception_checkpoint,
    fabricate_inception_state_dict,
)
from imagefolder_tpu.eval.psnr_ssim import psnr as jax_psnr, ssim as jax_ssim
from imagefolder_tpu_torch.eval import fid as pt_fid
from imagefolder_tpu_torch.eval.inception import load_inception
from imagefolder_tpu_torch.eval.psnr_ssim import psnr, ssim
from tests._torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def test_fid_math_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 64)).astype(np.float32)
    b = (rng.normal(size=(150, 64)) * 1.1 + 0.2).astype(np.float32)
    sa, sb = pt_fid.compute_statistics(a), pt_fid.compute_statistics(b)
    ja, jb = jax_fid.compute_statistics(a), jax_fid.compute_statistics(b)
    np.testing.assert_array_equal(sa.sigma, ja.sigma)
    assert _rel(sa.frechet_distance(sb), ja.frechet_distance(jb)) <= 1e-6
    # a singular product sends both through the eps fallback
    few = pt_fid.compute_statistics(a[:5]), jax_fid.compute_statistics(a[:5])
    assert _rel(few[0].frechet_distance(sb), few[1].frechet_distance(jb)) <= 1e-6
    p = rng.dirichlet(np.ones(10), size=120).astype(np.float32)
    assert _rel(pt_fid.inception_score(p, 50), jax_fid.inception_score(p, 50)) <= 1e-6
    assert pt_fid.precision_recall(a[:60], b[:60]) == jax_fid.precision_recall(a[:60], b[:60])


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for fn, jfn in ((psnr, jax_psnr), (ssim, jax_ssim)):
        got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert float(psnr(torch.from_numpy(a), torch.from_numpy(a))[0]) == 120.0  # mse floor


@pytest.fixture(scope="module")
def fabricated(tmp_path_factory):
    sd = fabricate_inception_state_dict(0)
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return sd, path


@pytest.mark.parametrize("px", [256, 512])
def test_inception_matches_jax(fabricated, px):
    sd, path = fabricated
    model = load_inception(str(path), device="cpu")
    x = np.random.default_rng(px).uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxInception().apply(v, x))(
        convert_inception_checkpoint(sd), jnp.asarray(x))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = model(torch.from_numpy(x))
    assert got["pool3"].shape == (2, 2048) and got["spatial"].shape == (2, 7 * 17 * 17)
    for k in ("pool3", "spatial", "softmax"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gather_rows_ragged_across_two_processes():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               f"localhost:{port}", "2", str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "gather ok" in out, out
