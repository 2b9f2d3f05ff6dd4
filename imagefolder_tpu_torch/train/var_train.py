"""VAR teacher-forcing training and class-conditional CFG sampling
(counterpart of ``imagefolder_tpu/train/var_train.py``; reference
``trainer.py``, ``train.py``, ``models/var.py:145-233``, ``inference.py``).

Train step: the frozen tokenizer encodes the images to per-branch,
per-scale codes (``img_to_idxBl``, under ``torch.no_grad``) -> the
teacher-forcing input -> VAR's training forward (class dropout, token
dropout, drop path) -> per-PQ-branch cross entropy (trainer.py:122-147) ->
backward (the attention's through the BNHD backward kernel on the card) ->
clipped AdamW on the lr/wd schedule, and the EMA copy when asked for.
``VARTrainer.state_dict()`` holds what a resumed run needs (the CLI's
checkpoints, ``utils/ckpt.py``). In a multi-process run
(``parallel/dist.py``) the gradients are averaged over the processes before
the clip, the training masks are drawn for the global batch and sliced to
this process's rows, and the metrics are the global batch's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.models.tokenizer import VQModel
from imagefolder_tpu_torch.models.var import VAR
from imagefolder_tpu_torch.ops.sampling import gumbel, gumbel_softmax, sample_with_top_k_top_p
from imagefolder_tpu_torch.parallel.dist import (global_batch_rows, global_metrics, own_rows,
                                                 process_count)
from imagefolder_tpu_torch.train.optim import (
    adamw_with_freezing,
    ema_update,
    lr_wd_annealing,
    var_flax_paths,
)

__all__ = ["VARTrainConfig", "ProgressiveController", "VARTrainer", "var_sample"]


def _own_masks(masks: dict, b: int) -> dict:
    """``VAR.draw_masks``' masks for the global batch cut to this process's
    ``b`` rows (``parallel/dist.py``); token dropout's rate is one draw
    for the whole batch."""
    out = dict(masks)
    for k in ("class_drop", "token_keep"):
        if k in out:
            out[k] = own_rows(out[k], b)
    out["drop_path"] = [None if m is None else tuple(own_rows(t, b) for t in m)
                        for m in masks["drop_path"]]
    return out


@dataclasses.dataclass
class VARTrainConfig:
    """Mirror of the JAX package's VARTrainConfig: same fields, same
    defaults (reference utils/arg_util.py: AdamW(0.9, 0.95), lin0 schedule,
    grad clip 2)."""

    lr: float = 1e-4
    weight_decay: float = 0.05
    # cosine-anneal wd to this over the run (utils/lr_control.py:47-48);
    # 0 keeps it constant
    weight_decay_end: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 2.0
    sched: str = "lin0"
    warmup_steps: int = 1000
    total_steps: int = 100_000
    final_lr_ratio: float = 0.1
    label_smooth: float = 0.0
    p_drop_factor: float = 0.0
    ema: bool = False


class ProgressiveController:
    """Progressive-training schedule and per-stage warmup state (reference
    train.py:317-325, trainer.py:105-118): a copy of the JAX package's class,
    which is plain Python."""

    def __init__(self, num_stages: int, pg: float = 0.0, pg0: int = 4,
                 prog_wp_it: float = 20.0):
        self.num_stages = num_stages
        self.pg = pg
        # pg0=4 assumes the 10-scale pyramid: clamp it on a shorter one
        self.pg0 = max(0, min(pg0, num_stages - 1))
        self.prog_wp_it = max(prog_wp_it, 1.0)
        self.prog_it = 0
        self.last_prog_si = -1
        self.first_prog = True

    def stage(self, g_it: int, wp_it: float, max_it: int) -> int:
        """Scheduled raw stage for global iteration g_it (train.py:317-325)."""
        if self.pg <= 0:
            return -1
        if g_it <= wp_it:
            return self.pg0
        if g_it >= max_it * self.pg:
            return self.num_stages - 1
        delta = self.num_stages - 1 - self.pg0
        progress = min(max((g_it - wp_it) / (max_it * self.pg - wp_it), 0), 1)
        return self.pg0 + round(progress * delta)

    def step(self, prog_si: int):
        """Per-iteration bookkeeping (trainer.py:109-118) ->
        (effective prog_si, prog_wp)."""
        if self.last_prog_si != prog_si:
            if self.last_prog_si != -1:
                self.first_prog = False
            self.last_prog_si = prog_si
            self.prog_it = 0
        self.prog_it += 1
        prog_wp = max(min(self.prog_it / self.prog_wp_it, 1.0), 0.01)
        if self.first_prog:
            prog_wp = 1.0  # the main warmup covers the first stage
        if prog_si == self.num_stages - 1:
            prog_si = -1  # the last stage is full training
        return prog_si, prog_wp

    def state_dict(self):
        return {"prog_it": self.prog_it, "last_prog_si": self.last_prog_si,
                "first_prog": self.first_prog}

    def load_state_dict(self, d):
        self.prog_it = d["prog_it"]
        self.last_prog_si = d["last_prog_si"]
        self.first_prog = d["first_prog"]


class VARTrainer:
    """Trains ``var`` on the codes of the frozen tokenizer ``vae``.

    ``vae`` is frozen here (``requires_grad_(False)``, ``eval()``); the
    optimizer covers VAR's parameters only, with the JAX package's decay
    labels. ``generator`` drives every training draw (on the models'
    device; the device's default generator when None). With ``tcfg.ema``,
    ``ema_var`` is a frozen copy of ``var`` updated after every step.

    ``shard`` (``parallel/mesh.py``: e.g. ``lambda m: fsdp_shard_params(m,
    mesh)`` or ``tp_shard_params``) splits ``var``'s parameters, and the EMA
    copy's the same way, before the optimizer is built; ``placements`` is
    what it returns for ``var``. The frozen tokenizer stays whole on every
    process."""

    def __init__(self, vae: VQModel, var: VAR, tcfg: VARTrainConfig, *,
                 generator: Optional[torch.Generator] = None,
                 shard: Optional[Callable[[VAR], dict]] = None):
        self.vae = vae.requires_grad_(False).eval()
        self.var, self.tcfg, self.generator = var, tcfg, generator
        self.ema_var = copy.deepcopy(var).requires_grad_(False) if tcfg.ema else None
        self.placements = None
        if shard is not None:
            self.placements = shard(var)
            if self.ema_var is not None:
                shard(self.ema_var)
        sched = lr_wd_annealing(tcfg.sched, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps,
                                tcfg.final_lr_ratio)
        self.opt = adamw_with_freezing(
            var, sched, weight_decay=tcfg.weight_decay, b1=tcfg.beta1, b2=tcfg.beta2,
            grad_clip=tcfg.grad_clip, weight_decay_end=(tcfg.weight_decay_end or None),
            total_steps=tcfg.total_steps, paths=var_flax_paths(var))
        pns = var.config.patch_nums
        self.L = sum(p * p for p in pns)
        self.last_l = pns[-1] ** 2

    def _codes(self, imgs: torch.Tensor, prog_si: int = -1):
        """The tokenizer's per-branch codes and the teacher-forcing input."""
        with torch.no_grad():
            idx_P = self.vae.img_to_idxBl(imgs)
            if prog_si >= 0:
                idx_P = [branch[:prog_si + 1] for branch in idx_P]
            gt_BL = [torch.cat(branch, dim=1) for branch in idx_P]
            return gt_BL, self.vae.idxBl_to_var_input(idx_P, prog_si)

    def _ce_and_acc(self, logits_BLV: torch.Tensor, gt_BL_list: Sequence[torch.Tensor],
                    label_smooth: float = 0.0, prog_si: int = -1, prog_wp: float = 1.0):
        """Per-PQ-branch CE (trainer.py:131-144) and mean/tail token accuracy.

        prog_si >= 0: the loss weight covers the first ed positions (still
        normalised by the full L), the newest stage's span scaled by prog_wp
        (trainer.py:137-143); the tail accuracy is -1 (trainer.py:157-158)."""
        p = self.var.config.product_quant
        v = logits_BLV.shape[-1] // p
        loss = 0.0
        accs, tails = [], []
        for i, gt in enumerate(gt_BL_list):
            lg = logits_BLV[..., i * v:(i + 1) * v]
            logp = F.log_softmax(lg, dim=-1)
            nll = -logp.gather(-1, gt[..., None])[..., 0]
            if label_smooth > 0:
                nll = (1 - label_smooth) * nll - label_smooth * logp.mean(dim=-1)
            loss = loss + nll  # (B, L or ed)
            correct = (lg.argmax(dim=-1) == gt).float()
            accs.append(correct.mean() * 100.0)
            tails.append(correct[:, -self.last_l:].mean() * 100.0 if prog_si < 0
                         else torch.full((), -1.0, device=lg.device))
        loss = loss / p
        if prog_si >= 0:
            bg, ed = self.var.config.begin_ends[prog_si]
            lw = torch.full((ed,), 1.0 / self.L, device=loss.device)
            lw[bg:] *= min(max(float(prog_wp), 0.0), 1.0)
            loss = (loss * lw).sum(dim=-1).mean()
        else:
            loss = (loss * (1.0 / self.L)).sum(dim=-1).mean()
        return loss, sum(accs) / p, sum(tails) / p

    def loss_and_backward(self, imgs: torch.Tensor, labels: torch.Tensor, *,
                          prog_si: int = -1, prog_wp: float = 1.0,
                          masks: Optional[dict] = None):
        """Forward and backward of one batch: leaves the gradients in VAR's
        ``.grad`` and returns (loss, acc_mean, acc_tail) as 0-d tensors.
        ``masks``: VAR's training masks (``VAR.draw_masks``), a test hook."""
        gt_BL, x_in = self._codes(imgs, prog_si)
        self.var.train()
        if masks is None and process_count() > 1:
            masks = _own_masks(self.var.draw_masks(
                global_batch_rows(imgs.shape[0])[1], prog_si, self.tcfg.p_drop_factor,
                self.generator), imgs.shape[0])
        logits = self.var(labels, x_in, prog_si, train=True,
                          p_drop_factor=self.tcfg.p_drop_factor, generator=self.generator,
                          masks=masks)
        loss, acc, tail = self._ce_and_acc(logits, gt_BL, self.tcfg.label_smooth, prog_si,
                                           prog_wp)
        loss.backward()
        return loss.detach(), acc, tail

    def train_step(self, imgs: torch.Tensor, labels: torch.Tensor, *, prog_si: int = -1,
                   prog_wp: float = 1.0, masks: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on (B, H, W, 3) images in [-1, 1] and (B,)
        labels -> {loss, acc_mean, acc_tail, grad_norm}, 0-d tensors on the
        device (no host sync). ``prog_si``/``prog_wp``: progressive training
        (trainer.py:103-147), the sequence truncated to the stages <= prog_si
        and the newest stage's loss ramped in by prog_wp."""
        self.opt.zero_grad()
        loss, acc, tail = self.loss_and_backward(imgs, labels, prog_si=prog_si,
                                                 prog_wp=prog_wp, masks=masks)
        gnorm = self.opt.step()
        if self.ema_var is not None:
            ema_update(list(self.ema_var.parameters()), list(self.var.parameters()))
        return {**global_metrics({"loss": loss, "acc_mean": acc, "acc_tail": tail}),
                "grad_norm": gnorm}

    def state_dict(self) -> dict:
        """What a resumed run needs to continue bit for bit: VAR's
        parameters, the optimizer with its schedule counts, the EMA copy
        (with ``tcfg.ema``) and the training generator's state."""
        return {"model": self.var.state_dict(), "opt": self.opt.state_dict(),
                "ema": None if self.ema_var is None else self.ema_var.state_dict(),
                "rng": None if self.generator is None else self.generator.get_state()}

    def load_state_dict(self, state: dict):
        """Restore ``state_dict()``'s state (tensors from any device)."""
        self.var.load_state_dict(state["model"])
        st = dict(state["opt"])
        if st["acc"] is not None:
            st["acc"] = [a.to(self.var.pos_1LC.device) for a in st["acc"]]
        self.opt.load_state_dict(st)
        if self.ema_var is not None:
            self.ema_var.load_state_dict(state["ema"])
        if self.generator is not None and state["rng"] is not None:
            self.generator.set_state(state["rng"].cpu())

    @torch.no_grad()
    def eval_step(self, imgs: torch.Tensor, labels: torch.Tensor,
                  var: Optional[VAR] = None) -> Dict[str, torch.Tensor]:
        """Validation step (trainer.py:58-101) of ``var`` (the trained model
        unless given, e.g. ``ema_var``): CE and token accuracy, mean and
        tail, with no label smoothing, averaged over the PQ branches, as (B,)
        per-sample vectors so that ``eval.validation.var_eval_ep`` can drop
        the padded rows of a ragged batch."""
        var = self.var if var is None else var
        gt_BL, x_in = self._codes(imgs)
        var.eval()
        logits = var(labels, x_in)
        p = var.config.product_quant
        v = logits.shape[-1] // p
        out: Dict[str, torch.Tensor] = {}
        for i, gt in enumerate(gt_BL):
            lg = logits[..., i * v:(i + 1) * v].float()
            nll = -F.log_softmax(lg, dim=-1).gather(-1, gt[..., None])[..., 0]
            correct = (lg.argmax(dim=-1) == gt).float()
            for key, val in (("L_mean", nll.mean(-1)), ("L_tail", nll[:, -self.last_l:].mean(-1)),
                             ("acc_mean", correct.mean(-1) * 100.0),
                             ("acc_tail", correct[:, -self.last_l:].mean(-1) * 100.0)):
                out[key] = out[key] + val if key in out else val
        return {k: val / p for k, val in out.items()}


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
