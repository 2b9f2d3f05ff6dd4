"""Port parity, the tokenizer's validation metrics
(``eval/validation.py``): ``tokenizer_val_rfid`` and ``tokenizer_val_psnr``
on the CPU against the JAX package's, on the tiny tokenizer and the
fabricated Inception of ``tests/_torch_cli.py`` (whose notes say why every
Frechet distance here is the exact low-rank one), on the same ragged
batches (3, 1) of 64 px images in [-1, 1]: the pool3 features of the
uint8-clamped images within 1e-3 of their max; the reconstructions' uint8
images equal but for one level at under 0.1% of the pixels (fp32 values on
either side of a rounding point) and their features within 1e-2; the rFID
to 1e-3 relative (and the cached ground truth giving the same); the PSNR to
1e-4.
"""

import numpy as np
import torch

import jax

from imagefolder_tpu.models.tokenizer import VQModel as JaxVQModel
from imagefolder_tpu_torch.eval.inception import load_inception, uint8_feature_fn
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.utils.hub import load_state_dict_file
from imagefolder_tpu_torch.utils.viz import to_uint8
from scripts import evaluate_fid as jax_evalfid
from tests._torch_cli import (  # noqa: F401
    CFG,
    PX,
    captured,
    close_feats,
    files,
    jax_val,
    pt_val,
    tiny_preset,
)
from tests._torch_parity import one_torch_thread  # noqa: F401


def test_tokenizer_val_rfid_and_psnr_match_jax(files, captured):
    root, jargs, params = files
    model = VQModel(ModelArgs(**{**CFG, "v_patch_nums": (4,)}), device="cpu")
    model.load_state_dict(load_state_dict_file(root / "tok.pt"), strict=True)
    imgs = np.random.default_rng(5).uniform(-1, 1, (4, PX, PX, 3)).astype(np.float32)
    batches = [{"image": imgs[:3]}, {"image": imgs[3:]}]

    jm = JaxVQModel(jargs)
    jrec = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                         method=JaxVQModel.img_to_reconstructed_img))
    jfeat = jax_evalfid.load_inception(str(root / "inc.pth"))

    def prec(m, x):
        with torch.no_grad():
            return m.img_to_reconstructed_img(torch.from_numpy(x))

    pfeat = uint8_feature_fn(load_inception(str(root / "inc.pth"), device="cpu"), "cpu")
    cache = {}
    with torch.backends.mkldnn.flags(enabled=False):
        want = jax_val.tokenizer_val_rfid(jrec, params, batches, jfeat, 3)
        got = pt_val.tokenizer_val_rfid(prec, model, batches, pfeat, 3, gt_cache=cache)
        again = pt_val.tokenizer_val_rfid(prec, model, batches, pfeat, 3, gt_cache=cache)
    assert abs(got - want) <= 1e-3 * abs(want) and again == got
    (j_gt, j_rec), (p_gt, p_rec, p_rec2) = captured["jax"], captured["port"]
    assert p_gt.shape == p_rec.shape == (4, 2048) and np.array_equal(p_rec2, p_rec)
    close_feats(p_gt, j_gt)
    # the reconstructions agree to fp32 rounding, and the uint8 clamp moves
    # a pixel by one level where they straddle a rounding point: a few such
    # pixels move the features by more than the images' own 1e-3
    padded = pt_val.pad_to_batch(imgs[3:], 3)[0]  # the JAX function as compiled for 3
    rec = [to_uint8(np.concatenate([np.asarray(jrec(params, imgs[:3])),
                                    np.asarray(jrec(params, padded))[:1]])),
           to_uint8(prec(model, imgs).numpy())]
    moved = rec[0] != rec[1]
    assert moved.mean() <= 1e-3 and np.abs(rec[0].astype(int) - rec[1]).max() <= 1
    close_feats(p_rec, j_rec, 1e-2)
    want = jax_val.tokenizer_val_psnr(jrec, params, batches, 3)
    got = pt_val.tokenizer_val_psnr(prec, model, batches, 3)
    assert abs(got - want) <= 1e-4
