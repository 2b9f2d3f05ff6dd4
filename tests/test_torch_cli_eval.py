"""Port parity, ``scripts/eval_reconstruction.py``: the JAX CLI's ``main``
against the port's ``main(device="cpu")`` on the CPU, on the tiny
tokenizer's exported ``.pt``, its YAML, the folder of 8 PNGs and the
fabricated Inception of ``tests/_torch_cli.py`` (whose notes say why every
Frechet distance here is the exact low-rank one), plain and with
``--perturb 0.5 0.5 4`` (the JAX CLI's uniforms, drawn from its keys,
injected into the port's ``draw_perturbation``): the printed PSNR and SSIM
to 1e-4, the pool3 features of both image sets within 1e-3 of their max,
the rFID / pFID to 1e-3 relative.
"""

import sys

import numpy as np
import pytest
import torch

import jax

from imagefolder_tpu_torch.scripts import eval_reconstruction as pt_eval
from scripts import eval_reconstruction as jax_eval
from tests._torch_cli import (  # noqa: F401
    CFG,
    PERTURB,
    captured,
    close_feats,
    files,
    printed,
    tiny_preset,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("perturb", [False, True], ids=["plain", "perturb"])
def test_eval_reconstruction_matches_jax(files, captured, capsys, monkeypatch, perturb):
    root, jargs, _ = files
    args = ["--config", str(root / "cfg.yaml"), "--vq_ckpt", str(root / "tok.pt"),
            "--val_data", str(root / "val"), "--batch_size", "4",
            "--inception_ckpt", str(root / "inc.pth")]
    if perturb:
        args += ["--perturb", *PERTURB]
        # the JAX CLI's uniforms: per batch key, k = split(key); per branch
        # fold_in(k, i), split into the keep-or-replace and the pick draws
        draws, key = [], jax.random.PRNGKey(0)
        n = 4 * CFG["num_latent_tokens"]
        for _ in range(2):
            key, k = jax.random.split(key)
            kp, ki = jax.random.split(jax.random.fold_in(k, 0))
            draws.append(tuple(torch.from_numpy(np.asarray(jax.random.uniform(s, (n,))))
                               for s in (kp, ki)))
        monkeypatch.setattr(pt_eval, "draw_perturbation",
                            lambda n_, gen, dev: draws.pop(0))
    monkeypatch.setattr(sys, "argv", ["eval_reconstruction.py", *args])
    with torch.backends.mkldnn.flags(enabled=False):
        jax_eval.main()
        want_out = capsys.readouterr().out
        got = pt_eval.main(args, device="cpu")
    got_out = capsys.readouterr().out
    tag = "pFID" if perturb else "rFID"
    assert printed(got_out, "images") == printed(want_out, "images") == 8
    for key in ("PSNR", "SSIM"):
        assert abs(printed(got_out, key) - printed(want_out, key)) <= 1e-4, key
    assert abs(got["psnr"] - printed(want_out, "PSNR")) <= 1e-4
    jr, jf = captured["jax"]
    close_feats(got["feats_real"], jr)
    close_feats(got["feats_fake"], jf)
    want = printed(want_out, tag)
    assert abs(got[tag.lower()] - want) <= 1e-3 * abs(want) + 1e-4
    if perturb:
        assert not draws  # one draw per batch consumed
