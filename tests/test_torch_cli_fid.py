"""Port parity, ``scripts/evaluate_fid.py``: the JAX CLI's ``main`` against
the port's ``main(device="cpu")`` on the CPU, on two npz batches of 16
images and the fabricated Inception of ``tests/_torch_cli.py`` (whose notes
say why every Frechet distance here is the exact low-rank one): IS, FID and
sFID to 1e-3 relative, precision and recall equal; and the port's CLI
refusing to run with neither weights nor ``--random_inception``.
"""

import sys

import pytest
import torch

from imagefolder_tpu_torch.scripts import evaluate_fid as pt_evalfid
from scripts import evaluate_fid as jax_evalfid
from tests._torch_cli import files, printed, tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread  # noqa: F401


def test_evaluate_fid_matches_jax(files, capsys, monkeypatch):
    root, _, _ = files
    args = [str(root / "ref.npz"), str(root / "sample.npz"), "--inception_ckpt",
            str(root / "inc.pth"), "--batch_size", "8"]
    monkeypatch.setattr(sys, "argv", ["evaluate_fid.py", *args])
    with torch.backends.mkldnn.flags(enabled=False):
        jax_evalfid.main()
        out = capsys.readouterr().out
        got = pt_evalfid.main(args, device="cpu")
    want = {k: printed(out, name) for k, name in (
        ("inception_score", "Inception Score"), ("fid", "FID"), ("sfid", "sFID"),
        ("precision", "Precision"), ("recall", "Recall"))}
    for k in ("inception_score", "fid", "sfid"):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    with pytest.raises(SystemExit):  # no weights and no --random_inception
        pt_evalfid.main(args[:2], device="cpu")
