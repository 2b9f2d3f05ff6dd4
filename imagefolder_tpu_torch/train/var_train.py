"""VAR class-conditional CFG sampling (counterpart of
``imagefolder_tpu/train/var_train.py::var_sample``; reference
``models/var.py:145-233``, ``inference.py``). The trainer is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.models.var import VAR
from imagefolder_tpu_torch.ops.sampling import gumbel, gumbel_softmax, sample_with_top_k_top_p

__all__ = ["var_sample"]


@torch.inference_mode()
def var_sample(var: VAR, vae: VQModel, label_B: torch.Tensor,
               generator: Optional[torch.Generator] = None, *, cfg_scale: float = 1.5,
               top_k: int = 0, top_p: float = 0.0, joint_sample: bool = False,
               more_smooth: bool = False) -> torch.Tensor:
    """10-stage KV-cached CFG decode -> images in [0, 1], NHWC fp32.

    Runs on the device of ``label_B`` and the models; ``generator`` (on that
    device) drives every draw. Per stage: logits of the conditional and the
    unconditional half are mixed with t = cfg_scale * si / (S - 1), and each
    PQ branch gets its codes by one of three rules:
    - default: a top-k/top-p filtered draw per branch;
    - ``joint_sample`` with P = 2 (var.py:196-209): one draw from the outer
      product of the two branches' filtered distributions. That product
      factorises, so the draw is made as one independent draw per branch
      rather than over the (V*V)-entry table the JAX package builds
      (7.6 GiB of fp32 probabilities per image at V = 4096 and 121 tokens).
      The JAX package adds 1e-20 to every entry before its log, a floor this
      skips;
    - ``more_smooth`` (var.py:196-225): gumbel-softmax code mixtures with
      tau = max(0.27 * (1 - 0.95 * ratio), 0.005) on logits scaled by
      (1 + ratio), embedded through the codebook.
    """
    cfg = var.config
    pns = cfg.patch_nums
    s = len(pns)
    p = cfg.product_quant
    b = label_B.shape[0]
    c_br = cfg.Cvae // p
    v = cfg.vocab_size // p

    ntm, cond = var.begin_tokens(label_B)
    caches = var.init_caches(2 * b)
    f_hat = torch.zeros((b, pns[-1], pns[-1], cfg.Cvae), device=label_B.device)
    cur_l = 0
    for si, pn in enumerate(pns):
        logits = var.decode_stage(ntm, cond, caches)
        cur_l += pn * pn
        ratio = si / max(s - 1, 1)
        t = cfg_scale * ratio
        logits = (1 + t) * logits[:b] - t * logits[b:]
        branch = [logits[..., i * v:(i + 1) * v] for i in range(p)]
        if more_smooth:
            tau = max(0.27 * (1.0 - ratio * 0.95), 0.005)
            hs = [vae.soft_embed_branch(i, gumbel_softmax(lg * (1.0 + ratio), generator, tau))
                  for i, lg in enumerate(branch)]
        else:
            if joint_sample and p == 2:
                # the joint p1 (x) p2 drawn as one draw from each factor
                probs = [sample_with_top_k_top_p(lg, generator, top_k, top_p, return_p=True)
                         for lg in branch]
                idx = [(torch.log(pr) + gumbel(pr.shape, generator, pr.device)).argmax(dim=-1)
                       for pr in probs]
            else:
                idx = [sample_with_top_k_top_p(lg, generator, top_k, top_p) for lg in branch]
            hs = [vae.embed_branch(i, ix, si) for i, ix in enumerate(idx)]
        h_all = torch.cat([h.reshape(b, pn, pn, c_br) for h in hs], dim=-1)
        f_hat, next_map = vae.get_next_autoregressive_input(si, s, f_hat, h_all)
        if si != s - 1:
            ntm = var.next_stage_input(next_map, cur_l, pns[si + 1])
    return vae.fhat_to_img(f_hat) * 0.5 + 0.5
