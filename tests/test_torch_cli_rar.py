"""The port's RAR and MaskGIT CLIs on the CPU at a tiny size (the tiny
tokenizer of ``tests/_torch_cli.py``: 16 tokens of a 32-code book; RAR and
MaskGIT of width 64, 2 blocks, 2 heads, 10 classes), from a JSONL that the
port's ``pretokenize`` wrote:

- ``train_rar`` (RAR) for 4 steps at batch 4 with a checkpoint and the
  stream's state at step 2, a preview at 4: a run stopped after step 2
  and rerun (it resumes from the checkpoint) leaves every tensor of the
  trainer bit-equal to the straight run's;
- ``train_rar --model maskgit`` for 2 steps with a preview: its checkpoints
  and grid;
- ``sample_rar`` on the RAR checkpoint (EMA) and on the MaskGIT one: the
  class-balanced labels (the last batch padded with class 0), and the npz
  against the JAX package's ``decode_tokens`` of the same tokens
  (``127.5 x + 128`` clipped and cast: equal, or 1 apart where the two
  frameworks' fp32 decodes round to either side of an integer).
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu_torch.models import rar as pt_rar_mod
from imagefolder_tpu_torch.scripts import pretokenize, sample_rar, train_rar
from imagefolder_tpu_torch.train.rar_train import RARTrainer
from imagefolder_tpu_torch.utils import logging as pt_logging
from tests._torch_cli import CFG, files, tiny_preset  # noqa: F401
from tests._torch_parity import one_torch_thread  # noqa: F401

SHAPE = ["--hidden", "64", "--depth", "2", "--heads", "2", "--num_classes", "10"]
GEN = [*SHAPE, "--codebook_size", "32"]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def tok_run(files, tmp_path_factory):
    """The JSONL of the 8 PNGs, center + flip (16 rows), and the tokenizer's
    flags: its YAML with fp32 activations (``mixed_precision: none``), so
    that the decodes compare at fp32 rounding."""
    root, jargs, params = files
    out = tmp_path_factory.mktemp("rar_cli")
    (out / "cfg32.yaml").write_text(yaml.safe_dump({**CFG, "mixed_precision": "none"}))
    tok = ["--config", str(out / "cfg32.yaml"), "--vq_ckpt", str(root / "tok.pt")]
    pretokenize.main([*tok, "--data_path", str(root / "val"), "--output",
                      str(out / "toks.jsonl")], device="cpu")
    return out, tok, jargs, params


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trackers without tensorboard (its writer imports TensorFlow here)."""
    tracker = pt_logging.Tracker
    monkeypatch.setattr(pt_logging, "Tracker",
                        lambda **k: tracker(**{**k, "use_tb": False}))


def _rar_argv(out, tok, name, *extra):
    return ["--jsonl", str(out / "toks.jsonl"), *tok, *GEN, "--batch_size", "4",
            "--total_steps", "4", "--ckpt_every", "2", "--log_every", "2",
            "--generate_every", "4", "--output", str(out / name), *extra]


def _trainer_tensors(tr: RARTrainer) -> dict:
    out = {f"model.{k}": v for k, v in tr.rar.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in tr.ema_state_dict().items()})
    for i, st in tr.opt.opt.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    return out


def test_train_rar_resumes_exactly(tok_run, monkeypatch):
    out, tok, _, _ = tok_run
    straight = train_rar.main(_rar_argv(out, tok, "straight"), device="cpu")
    assert straight["ckpt"].steps() == [2, 4] and straight["step"] == 4
    assert [p.name for p in straight["previews"]] == ["00000004_s-generated.png"]
    assert all(np.isfinite(float(v)) for v in straight["metrics"].values())
    orig = RARTrainer.train_step

    def stop_at_2(tr, *a, **k):
        if tr.step == 2:
            raise _Stop
        return orig(tr, *a, **k)

    monkeypatch.setattr(RARTrainer, "train_step", stop_at_2)
    with pytest.raises(_Stop):
        train_rar.main(_rar_argv(out, tok, "resumed"), device="cpu")
    monkeypatch.setattr(RARTrainer, "train_step", orig)
    resumed = train_rar.main(_rar_argv(out, tok, "resumed"), device="cpu")
    assert resumed["trainer"].step == straight["trainer"].step == 4
    a, b = _trainer_tensors(straight["trainer"]), _trainer_tensors(resumed["trainer"])
    assert set(a) == set(b)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]
    for k, v in straight["metrics"].items():
        assert torch.equal(v, resumed["metrics"][k]), k


def _jax_uint8(jargs, params, tokens: np.ndarray) -> np.ndarray:
    model = JaxVQModel(jargs)
    dec = jax.jit(lambda p, t: model.apply({"params": p}, t, method=JaxVQModel.decode_tokens))
    imgs = dec(params, jnp.asarray(tokens, jnp.int32))
    return np.asarray(jnp.clip(127.5 * imgs + 128.0, 0, 255)).astype(np.uint8)


@pytest.mark.parametrize("model", ["rar", "maskgit"])
def test_sample_rar_labels_and_decode_match_jax(tok_run, monkeypatch, model):
    out, tok, jargs, params = tok_run
    run = out / "straight"
    if model == "maskgit":
        run = out / "maskgit"
        r = train_rar.main(["--jsonl", str(out / "toks.jsonl"), *tok, *GEN, "--model",
                            "maskgit", "--batch_size", "4", "--total_steps", "2",
                            "--ckpt_every", "1", "--log_every", "1", "--generate_every", "2",
                            "--output", str(run)], device="cpu")
        assert r["ckpt"].steps() == [1, 2]
        assert [p.name for p in r["previews"]] == ["00000002_s-generated.png"]
    elif not (run / "ckpts").exists():
        train_rar.main(_rar_argv(out, tok, "straight"), device="cpu")
    labels = []
    orig = pt_rar_mod.rar_generate

    def record(m, c, *a, **k):
        labels.append(c.clone())
        return orig(m, c, *a, **k)

    monkeypatch.setattr(pt_rar_mod, "rar_generate", record)
    ckpt = sorted((run / "ckpts").iterdir())[-1]
    got = sample_rar.main([*tok, "--rar_ckpt", str(ckpt), *SHAPE, "--model", model,
                           "--num_samples", "12", "--batch_size", "8",
                           "--output", str(out / f"{model}.npz")], device="cpu")
    arr = np.load(out / f"{model}.npz")["arr_0"]
    assert arr.shape == (12, 64, 64, 3) and arr.dtype == np.uint8
    np.testing.assert_array_equal(arr, got["samples"])
    if model == "rar":
        want = np.concatenate([np.arange(10), [0, 1], np.zeros(4, np.int64)])
        np.testing.assert_array_equal(torch.cat(labels).numpy(), want)
    toks = torch.cat(got["tokens"]).numpy()
    assert toks.shape == (12, 16) and toks.min() >= 0 and toks.max() < 32
    diff = np.abs(arr.astype(np.int16) - _jax_uint8(jargs, params, toks).astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99, (diff.max(), (diff == 0).mean())


def test_train_rar_tokenizes_on_the_fly(tok_run, files, monkeypatch):
    """Without --jsonl, the tokenizer encodes the ImageFolder batches
    (train_utils.py:676-686): the sequence length and codebook come from
    the tokenizer's config, and each batch's tokens are its codes."""
    import imagefolder_tpu_torch.data.imagenet as pt_data

    out, tok, _, _ = tok_run
    root = files[0]
    make = pt_data.make_dataloader
    monkeypatch.setattr(pt_data, "make_dataloader",
                        lambda *a, **k: make(*a, **{**k, "num_workers": 0}))
    seen = []
    orig = RARTrainer.train_step

    def record(tr, tokens, labels, *a, **k):
        seen.append((tokens.clone(), labels.clone()))
        return orig(tr, tokens, labels, *a, **k)

    monkeypatch.setattr(RARTrainer, "train_step", record)
    r = train_rar.main([*tok, "--data_path", str(root / "val"), *SHAPE, "--batch_size", "4",
                        "--total_steps", "2", "--ckpt_every", "2", "--log_every", "1",
                        "--output", str(out / "online")], device="cpu")
    assert r["seq_len"] == 16 and r["trainer"].rar.config.codebook_size == 32
    assert len(seen) == 2 and all(t.shape == (4, 16) for t, _ in seen)
    assert all(int(t.max()) < 32 and int(t.min()) >= 0 for t, _ in seen)
