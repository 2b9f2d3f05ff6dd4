"""The generator trainers: RAR's (counterpart of
``imagefolder_tpu/train/rar_train.py``; reference ``utils/train_utils.py:641``
and ``scripts/train_rar.py``) and MaskGIT's masked-modelling step (the JAX
package's ``scripts/train_rar.py:338-352``, which has no trainer class).

``RARTrainer.train_step``: condition dropout, per-sample orders (random
with probability ``random_ratio``, annealed by ``get_rar_random_ratio``),
the training forward, ``ar_loss`` and the backward, one AdamW step with
optax's global-norm clip (``adamw_with_freezing``: no decay on the JAX
package's no-decay labels) on a warmup-cosine schedule with an end lr, and
the EMA of the parameters at open-muse's decay.

``MaskGITTrainer.train_step``: the arccos masking of the tokens, the forward
with the condition dropped at 0.1, ``mlm_loss`` and the backward, one step
of ``optax.adamw`` (weight decay 0.03 on every parameter, b2 0.999, no
clip) on ``warmup_cosine_decay_schedule(0, 2e-4, total // 20, total)``.

Every random draw comes from the ``generator`` passed to a step, or, where
a test replays another trainer's draws, from the arguments that name it.
In a multi-process run (``parallel/dist.py``) each draw is made for the
global batch and sliced to this process's rows, the gradients are averaged
over the processes before the clip, MaskGIT's loss weights are summed over
the global batch, and the metrics are the global batch's. Under a mesh
(``parallel/mesh.py``) both trainers take ``shard=``, which splits the model
(FSDP2 or tensor parallelism) before the optimizer and RAR's EMA are made.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from imagefolder_tpu_torch.models.maskgit import MaskGIT, mask_input_tokens, mlm_loss
from imagefolder_tpu_torch.models.rar import RAR, ar_loss
from imagefolder_tpu_torch.parallel.dist import global_batch_rows, global_metrics, own_rows
from imagefolder_tpu_torch.train.optim import (ScheduledAdamW, adamw_with_freezing,
                                               ema_decay_schedule, ema_update,
                                               warmup_cosine_decay_schedule)
from imagefolder_tpu_torch.utils.convert import rar_key_map

__all__ = ["get_rar_random_ratio", "RARTrainConfig", "RARTrainer", "MaskGITTrainer"]


def get_rar_random_ratio(start: int, end: int, cur_step: int) -> float:
    """Randomness annealing 1 -> 0 (reference train_utils.py:630-638)."""
    if cur_step < start:
        return 1.0
    if cur_step > end:
        return 0.0
    return 1.0 - (cur_step - start) / max(end - start, 1)


@dataclasses.dataclass
class RARTrainConfig:
    """Mirror of the JAX package's RARTrainConfig: same fields, same defaults."""

    lr: float = 4e-4
    end_lr: float = 1e-5
    weight_decay: float = 0.03
    beta1: float = 0.9
    beta2: float = 0.96
    grad_clip: float = 1.0
    warmup_steps: int = 62_500
    total_steps: int = 250_000
    class_label_dropout: float = 0.1
    # open-muse EMAModel schedule (RAR/modules/ema_model.py:18-109; the RAR
    # recipe instantiates EMAModel(decay=0.999), utils/train_utils.py:144)
    ema_decay: float = 0.999
    ema_min_decay: float = 0.0
    ema_update_after_step: int = 0
    ema_update_every: int = 1
    ema_warmup: bool = False  # power-law warmup instead of (1+s)/(10+s)
    ema_inv_gamma: float = 1.0
    ema_power: float = 2.0 / 3.0
    random_ratio_anneal_start: int = 0
    random_ratio_anneal_end: int = 125_000


class RARTrainer:
    """Trains ``rar`` in place: its parameters, the optimizer (``opt``), the
    EMA copies (``ema``, one per parameter, on its device) and ``step``, the
    number of updates done.

    ``shard`` (``parallel/mesh.py``: e.g. ``lambda m: fsdp_shard_params(m,
    mesh)`` or ``tp_shard_params``) splits ``rar``'s parameters before the
    optimizer and the EMA copies are made, so that each copy is split like
    its parameter; ``placements`` is what it returns."""

    def __init__(self, rar: RAR, tcfg: RARTrainConfig, *,
                 shard: Optional[Callable[[RAR], dict]] = None):
        self.rar, self.tcfg = rar, tcfg
        self.placements = None if shard is None else shard(rar)
        sched = warmup_cosine_decay_schedule(0.0, tcfg.lr, tcfg.warmup_steps,
                                             tcfg.total_steps, end_value=tcfg.end_lr)
        paths = {name: path for name, (path, _) in rar_key_map(rar.config.depth).items()}
        self.opt = adamw_with_freezing(rar, sched, weight_decay=tcfg.weight_decay,
                                       b1=tcfg.beta1, b2=tcfg.beta2, grad_clip=tcfg.grad_clip,
                                       paths=paths)
        self.ema = [p.detach().clone() for p in rar.parameters()]
        self.step = 0

    def train_step(self, tokens: torch.Tensor, labels: torch.Tensor, random_ratio: float,
                   generator: Optional[torch.Generator] = None, *,
                   drop: Optional[torch.Tensor] = None,
                   orders: Optional[torch.Tensor] = None) -> dict:
        """One update on tokens (B, L) and class ids labels (B,). The
        condition drop (B,) bool and the orders (B, L) are drawn from
        ``generator`` in that order (``RAR.preprocess_condition``,
        ``RAR.sample_orders``) unless given. Returns 0-d tensors on the
        model's device: ``loss``, ``correct_tokens`` and ``grad_norm`` (the
        global norm before the clip)."""
        rar, tc = self.rar, self.tcfg
        b = tokens.shape[0]
        rows = global_batch_rows(b)[1]
        if rows != b and drop is None and tc.class_label_dropout > 0 and generator is not None:
            drop = own_rows(torch.rand((rows,), generator=generator, device=tokens.device)
                            < tc.class_label_dropout, b)
        cond = rar.preprocess_condition(labels, generator, tc.class_label_dropout, drop)
        if orders is None:
            orders = own_rows(rar.sample_orders(rows, random_ratio, generator), b)
        logits, shuffled = rar(tokens, cond, orders=orders)
        loss, acc = ar_loss(logits, shuffled)
        self.opt.zero_grad()
        loss.backward()
        gnorm = self.opt.step()
        # EMAModel.step(): the counter increments before get_decay, so the
        # decay after `step` completed updates is taken at step + 1; a step
        # that update_every skips keeps the shadow parameters
        if self.step % tc.ema_update_every == 0:
            decay = ema_decay_schedule(
                self.step + 1, decay=tc.ema_decay, min_decay=tc.ema_min_decay,
                update_after_step=tc.ema_update_after_step, use_ema_warmup=tc.ema_warmup,
                inv_gamma=tc.ema_inv_gamma, power=tc.ema_power)
            ema_update(self.ema, [p.detach() for p in rar.parameters()], decay)
        self.step += 1
        return dict(**global_metrics(dict(loss=loss.detach(), correct_tokens=acc.detach())),
                    grad_norm=gnorm)

    def ema_state_dict(self) -> dict:
        """The EMA copy as a ``RAR`` state dict (the model's buffers with the
        EMA parameters): the weights the zoo's RAR checkpoints hold."""
        sd = self.rar.state_dict()
        for (name, _), e in zip(self.rar.named_parameters(), self.ema):
            sd[name] = e.clone()
        return sd

    def state_dict(self) -> dict:
        return {"model": self.rar.state_dict(), "opt": self.opt.state_dict(),
                "ema": self.ema_state_dict(), "step": self.step}

    def load_state_dict(self, state: dict):
        """Restore ``state_dict()``'s state (tensors from any device)."""
        self.rar.load_state_dict(state["model"])
        st = dict(state["opt"])
        if st["acc"] is not None:
            st["acc"] = [a.to(self.ema[0].device) for a in st["acc"]]
        self.opt.load_state_dict(st)
        for (name, _), e in zip(self.rar.named_parameters(), self.ema):
            e.copy_(state["ema"][name])
        self.step = state["step"]


# the JAX package's MaskGIT step (scripts/train_rar.py:338-352) fixes these:
# optax.adamw's peak lr and weight decay, and the condition-drop rate
MASKGIT_LR = 2e-4
MASKGIT_WEIGHT_DECAY = 0.03
MASKGIT_COND_DROP = 0.1


class MaskGITTrainer:
    """Trains ``model`` in place over a run of ``total_steps``; ``opt``
    holds the optimizer and its step count: ``optax.adamw`` (b1 0.9, b2
    0.999, eps 1e-8) with weight decay on every parameter, lr
    ``warmup_cosine_decay_schedule(0, MASKGIT_LR, total_steps // 20,
    total_steps)``. ``shard`` splits the model's parameters before the
    optimizer is made, as in ``RARTrainer``."""

    def __init__(self, model: MaskGIT, total_steps: int, *,
                 shard: Optional[Callable[[MaskGIT], dict]] = None):
        self.model = model
        self.placements = None if shard is None else shard(model)
        sched = warmup_cosine_decay_schedule(0.0, MASKGIT_LR, total_steps // 20, total_steps)
        self.opt = ScheduledAdamW(model.named_parameters(), sched, no_decay=lambda _: False,
                                  weight_decay=MASKGIT_WEIGHT_DECAY)

    def train_step(self, tokens: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, scores: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> dict:
        """One update on tokens (B, L) and class ids labels (B,). The masking
        draws (``mask_input_tokens``' t (B,) and scores (B, L)) and the
        condition drop (B,) come from ``generator`` in that order unless
        given. Returns 0-d tensors on the model's device: ``loss``,
        ``correct_tokens`` (on the masked positions) and ``grad_norm``."""
        model = self.model
        b, l = tokens.shape
        rows = global_batch_rows(b)[1]
        if rows != b:  # the draws of one process on the global batch, in its order
            dev = tokens.device
            if t is None:
                t = own_rows(torch.rand((rows,), generator=generator, device=dev), b)
            if scores is None:
                scores = own_rows(torch.rand((rows, l), generator=generator, device=dev), b)
            if drop is None and generator is not None:
                drop = own_rows(torch.rand((rows,), generator=generator, device=dev)
                                < MASKGIT_COND_DROP, b)
        masked, masks = mask_input_tokens(tokens, model.config.mask_token_id, generator,
                                          t=t, scores=scores)
        logits = model(masked, labels, cond_drop_prob=MASKGIT_COND_DROP, generator=generator,
                       drop=drop)
        loss, acc = mlm_loss(logits, tokens, masks)
        self.opt.zero_grad()
        loss.backward()
        gnorm = self.opt.step()
        return dict(**global_metrics(dict(loss=loss.detach(), correct_tokens=acc.detach())),
                    grad_norm=gnorm)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
