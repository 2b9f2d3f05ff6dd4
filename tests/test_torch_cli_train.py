"""The port's tokenizer training CLI (``imagefolder_tpu_torch/scripts/
train_tokenizer.py``) on the CPU: ``configs/RobustTok.yaml`` cut to a tiny
preset (width 768 for the CLIP detail teacher, depth 1; 32 px, 4 latents, a
32 x 8 codebook, top-k 8; DinoDisc at depth 1, which no YAML key sets, so
the test sets it on the loaded config), over a folder of 8 train and 4 val
PNGs at a global batch of 4: 2 steps an epoch, 2 epochs, the
discriminator on from epoch 1, a checkpoint, a recon grid and the PSNR
validation every 2 steps (tensorboard off).

- each step's epoch, alpha, delta_ratio, fade_blur and disc_start equal the
  JAX CLI's formulas (``scripts/train_tokenizer.py``: ``get_random_ratio``,
  the fade at :163-168, disc_start = disc_epoch_start * steps_per_epoch);
- the checkpoints at steps 2 and 4, the best checkpoint, the recon grids
  and the validation PSNRs are written;
- exact resume: a run stopped after its step-2 checkpoint and resumed with
  ``--resume`` in a fresh trainer ends bit-equal to the straight run at
  step 4: every parameter, both optimizers' state, the EMA and the last
  step's metrics. The JAX CLI is not run: its draws come from
  ``jax.random.fold_in`` and the port's from a torch generator, and the
  step itself is held by ``test_torch_robusttok.py``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from imagefolder_tpu_torch.models import vit as pt_vit
from imagefolder_tpu_torch.scripts import train_tokenizer as tt
from imagefolder_tpu_torch.train.tokenizer_train import TokenizerTrainer
from imagefolder_tpu_torch.utils.logging import Tracker
from scripts.train_tokenizer import get_random_ratio as jax_ratio
from tests._torch_parity import one_torch_thread  # noqa: F401

TINY = "tiny_cli_vit"
CLIP = "vit_base_patch16_clip_224.openai"
OVERRIDES = ["encoder_model=" + TINY, "decoder_model=" + TINY, "image_size=32",
             "num_latent_tokens=4", "codebook_size=32", "codebook_embed_dim=8",
             "mixed_precision=none", "aug_prob=0.0", "delta=8", "global_batch_size=4",
             "epochs=2", "disc_epoch_start=1", "ckpt_every=2", "vis_every=2", "log_every=1",
             "anneal_start=0", "anneal_end=2", "aug_fade_steps=1"]


class Stop(Exception):
    pass


@pytest.fixture(scope="module", autouse=True)
def tiny(monkeypatch_module):
    monkeypatch_module.setitem(pt_vit.VIT_PRESETS, TINY, dict(embed_dim=768, depth=1,
                                                             num_heads=12))
    monkeypatch_module.setitem(pt_vit.VIT_PRESETS, CLIP, dict(
        embed_dim=768, depth=1, num_heads=12, init_values=None, pre_norm=True))
    load = tt.load_tokenizer_config

    def load_tiny(*a, **k):
        margs, tcfg, run = load(*a, **k)
        tcfg.dino_depth = 1
        return margs, tcfg, run

    monkeypatch_module.setattr(tt, "load_tokenizer_config", load_tiny)
    make = tt.make_dataloader  # loaders without worker processes
    monkeypatch_module.setattr(tt, "make_dataloader",
                               lambda *a, **k: make(*a, **{**k, "num_workers": 0}))
    # tensorboard's writer imports TensorFlow where it is installed (~10 s)
    monkeypatch_module.setattr(tt, "Tracker", lambda **k: Tracker(**{**k, "use_tb": False}))


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 4)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            h, w = rng.integers(36, 60, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return root


def _argv(data, out, *extra):
    return ["--config", "configs/RobustTok.yaml", "--val_batch_size", "2", *extra, f"data_path={data / 'train'}", f"val_data_path={data / 'val'}",
            f"cloud_save_path={out}", *OVERRIDES]


@pytest.fixture(scope="module")
def straight(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    return out, tt.main(_argv(data, out), device="cpu")


def test_schedule_matches_jax_formulas(straight):
    _, r = straight
    assert r["step"] == 4 and [h["step"] for h in r["history"]] == [0, 1, 2, 3]
    spe, disc_start, fade_steps = 2, 2, 1
    for h in r["history"]:
        step, epoch = h["step"], h["step"] // spe
        ratio = jax_ratio(0, 2, 0.5, epoch)  # RobustTok.yaml's end_ratio 0.5
        fade = 0 if step < disc_start else min(1.0, (step - disc_start) / (fade_steps + 1))
        assert h == dict(step=step, epoch=epoch, alpha=1.0 * ratio, beta=0.1,
                         delta_ratio=ratio, fade_blur=round(1 - fade, 3),
                         disc_start=disc_start)
    assert [h["alpha"] for h in r["history"]] == [1.0, 1.0, 0.75, 0.75]
    assert [h["fade_blur"] for h in r["history"]] == [1, 1, 1.0, 0.5]


def test_writes_checkpoints_grids_and_validation(straight):
    out, r = straight
    assert r["ckpt"].steps() == [2, 4] and (out / "best.pt").exists()
    assert sorted(p.name for p in (out / "vis").iterdir()) == ["recon_0000002.png",
                                                               "recon_0000004.png"]
    grid = np.asarray(Image.open(out / "vis" / "recon_0000004.png"))
    assert grid.shape == (2 * 32, 4 * 32, 3)  # one scale row and the originals, 4 images
    assert [(s, n) for s, n, _ in r["val"]] == [(2, "val_psnr"), (4, "val_psnr")]
    assert all(np.isfinite(v) for _, _, v in r["val"])
    assert r["metrics"]["disc_weight"] > 0  # the discriminator is on in epoch 1
    state = torch.load(out / "ckpts" / "step_00000004.pt", weights_only=False)
    assert state["step"] == 4 and sorted(state["ema"]) == sorted(state["model"])
    assert (out / "log.txt").read_text().count("val PSNR") == 2


def test_resume_is_bit_equal_to_the_straight_run(straight, data, tmp_path, monkeypatch):
    _, want = straight
    step = TokenizerTrainer.train_step

    def stop_at_2(self, *a, **k):
        if self.step == 2:
            raise Stop
        return step(self, *a, **k)

    monkeypatch.setattr(TokenizerTrainer, "train_step", stop_at_2)
    with pytest.raises(Stop):
        tt.main(_argv(data, tmp_path), device="cpu")
    monkeypatch.setattr(TokenizerTrainer, "train_step", step)
    got = tt.main(_argv(data, tmp_path, "--resume"), device="cpu")
    assert got["step"] == 4 and [h["step"] for h in got["history"]] == [2, 3]
    a, b = want["trainer"], got["trainer"]
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for (name, p), q in zip(a.disc.state_dict().items(), b.disc.state_dict().values()):
        assert torch.equal(p, q), name
    for x, y in zip(a.ema_params, b.ema_params):
        assert torch.equal(x, y)
    for oa, ob in ((a.gen_opt, b.gen_opt), (a.disc_opt, b.disc_opt)):
        sa, sb = oa.opt.state_dict()["state"], ob.opt.state_dict()["state"]
        assert sorted(sa) == sorted(sb) and oa.count == ob.count
        for k in sa:
            for n in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[k][n], sb[k][n]), (k, n)
    for k, v in want["metrics"].items():
        assert torch.equal(v, got["metrics"][k]), k
