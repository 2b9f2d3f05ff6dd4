"""The optimizers of the VAR and tokenizer trainers (counterpart of
``imagefolder_tpu/train/optim.py``; reference ``utils/lr_control.py``,
``utils/amp_sc.py``, ``utils/ema.py``, ``xqgan_train.py:338-373``).

- ``lr_wd_annealing``, ``wd_cosine_anneal`` and ``cosine_with_warmup``: the
  schedules, as plain functions of the step (host floats, no device work);
- ``no_decay_predicate``: the JAX package's weight-decay labels, read off
  its flax parameter paths; ``var_flax_paths`` and ``module_flax_paths``
  (``VQModel``, ``DinoDisc``) give each port parameter its flax path;
  ``tokenizer_frozen_predicate`` and ``disc_frozen_predicate`` the frozen
  labels (the trainers turn ``requires_grad`` off there);
- ``adamw_with_freezing``: ``torch.optim.AdamW`` over a decay and a no-decay
  group, with the schedules and optax's global-norm clip;
- ``ema_update``.

optax's chain is clip_by_global_norm -> scale_by_adam -> (+ wd * p) ->
scale_by_learning_rate(lr(count)), count from 0. AdamW's decoupled decay
p (1 - lr wd) followed by p - lr adam is the same update. Freezing is
PyTorch's: a parameter with ``requires_grad`` False never enters the
optimizer. The per-group lr/wd scales and gradient accumulation are not
ported.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from imagefolder_tpu_torch.models.var import VAR
from imagefolder_tpu_torch.utils.convert import flax_path, var_key_map

__all__ = ["lr_wd_annealing", "wd_cosine_anneal", "cosine_with_warmup", "no_decay_predicate",
           "var_flax_paths", "module_flax_paths",
           "tokenizer_frozen_predicate", "disc_frozen_predicate", "adamw_with_freezing",
           "ScheduledAdamW", "ema_update"]


def cosine_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                       min_lr: float = 5e-5) -> Callable[[int], float]:
    """timm create_scheduler('cosine') parity (xqgan_train.py:344-366):
    base_lr * step / warmup from step 0 (so the first lr is 0), then cosine
    to min_lr."""
    warmup_steps = max(warmup_steps, 1)

    def sched(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * prog))

    return sched


def lr_wd_annealing(sched_type: str, peak_lr: float, wp_steps: float, max_steps: int,
                    final_lr_ratio: float = 0.0, wp0: float = 0.005) -> Callable[[int], float]:
    """Reference lr_wd_annealing schedule family (utils/lr_control.py:10-68):
    lr(step), a linear warmup wp0 + (1 - wp0) * step / wp, then the
    ``sched_type`` leg over the remaining steps."""
    wp = max(round(wp_steps), 1.0)

    def sched(step: int) -> float:
        g = float(step)
        if g < wp:
            return peak_lr * (wp0 + (1 - wp0) * g / wp)
        pasd = min(max((g - wp) / max(max_steps - 1 - wp, 1), 0.0), 1.0)
        f = final_lr_ratio
        if sched_type == "cos":
            rest = f + (1 - f) * (0.5 + 0.5 * math.cos(math.pi * pasd))
        elif sched_type in ("lin", "lin0"):
            t = 0.15 if sched_type == "lin" else 0.05
            rest = 1.0 if pasd < t else f + (1 - f) * (1 - pasd) / (1 - t)
        elif sched_type == "lin00":
            rest = f + (1 - f) * (1 - pasd)
        elif sched_type.startswith("lin"):
            # generic linT: to the midpoint over the first T, then linear to
            # final (lr_control.py:31-36)
            t = float(sched_type[3:])
            mid = (1 + f + (1 - f) * (1 - t)) / 2
            rest = 1 + (mid - 1) * pasd / t if pasd < t else f + (mid - f) * (1 - pasd) / (1 - t)
        elif sched_type == "exp":
            w = min(max((pasd - 0.15) / (1 - 0.15), 0.0), 1.0)
            rest = math.exp(math.log(max(f, 1e-5)) * w)
        else:  # constant
            rest = 1.0
        return peak_lr * rest

    return sched


def wd_cosine_anneal(wd: float, wd_end: float, max_steps: int) -> Callable[[int], float]:
    """Reference cosine weight-decay anneal (utils/lr_control.py:47-48) over
    the whole run, warmup included."""

    def sched(step: int) -> float:
        pasd = step / max(max_steps - 1, 1)
        return wd_end + (wd - wd_end) * (0.5 + 0.5 * math.cos(math.pi * pasd))

    return sched


def no_decay_predicate(path: str) -> bool:
    """The JAX package's no-decay labels on a flax path ("a/b/leaf"):
    biases, norms, embeddings, codebooks, tokens and scales. They follow the
    JAX package, not upstream's filter_params, which also exempts every 1-D
    parameter: VAR's ``q_bias`` and ``v_bias`` are decayed here."""
    leaf = path.rsplit("/", 1)[-1]
    return (
        leaf in {"bias", "scale", "codebook", "cls_token", "pos_embed",
                 "latent_tokens", "latent_pos_embed", "mask_token", "lvl_embed",
                 "ls1", "ls2", "pos_start", "pos_1LC", "class_emb", "empty_emb",
                 "scale_mul"}
        or "norm" in path.rsplit("/", 2)[-2:][0].lower()
    )


def tokenizer_frozen_predicate(cfg) -> Callable[[str], bool]:
    """Which tokenizer parameters (by flax path) get no updates: the frozen
    teachers always, the encoder/decoder trunks under 'frozen'/'lora'
    tuning (dinov2.py:54-79: lora trains only adapters, the final norm and
    what lies outside the trunk)."""

    def frozen(path: str) -> bool:
        if path.startswith(("semantic_model/", "detail_model/")):
            return True
        for part, method in (("encoder/", cfg.enc_tuning_method),
                             ("decoder/", cfg.dec_tuning_method)):
            if path.startswith(part):
                if method == "frozen":
                    return True
                if method in ("lora", "lat_lora"):
                    return not ("lora_a" in path or "lora_b" in path
                                or re.search(r"/model/norm/", path) is not None
                                or not path.startswith(part + "model/"))
        return False

    return frozen


def disc_frozen_predicate(path: str) -> bool:
    """DinoDisc's trunk is frozen (discriminator_dino.py:316-317)."""
    return path.startswith("dino/")


def module_flax_paths(module: nn.Module) -> Dict[str, str]:
    """Each parameter name of a ``VQModel`` or ``DinoDisc`` -> its flax path
    (the rules that ``utils/convert.py``'s converters follow)."""
    return {name: flax_path(name) for name, _ in module.named_parameters()}


def var_flax_paths(var: VAR) -> Dict[str, str]:
    """Each VAR parameter's name -> its flax path, through the key map that
    ``utils/convert.py::var_state_dict_from_flax`` loads with."""
    return {name: path for name, (path, _) in var_key_map(var.config).items()}


class ScheduledAdamW:
    """``torch.optim.AdamW`` over named parameters split by ``no_decay``,
    with lr (and wd) set from their schedules at every step and the
    gradients clipped to one global norm first.

    ``step()`` returns the global norm of the gradients before the clip, a
    0-d tensor on their device, and makes no host sync: the clip factor stays
    on the device, and the schedules are host floats of the step count."""

    def __init__(self, named_params: Iterable, lr_schedule: Callable[[int], float], *,
                 no_decay: Callable[[str], bool], weight_decay: float = 0.0,
                 wd_schedule: Optional[Callable[[int], float]] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: float = 0.0):
        decay, plain = [], []
        for name, p in named_params:
            if p.requires_grad:
                (plain if no_decay(name) else decay).append(p)
        self.params = decay + plain
        self.lr_schedule, self.grad_clip = lr_schedule, grad_clip
        self.wd_schedule = wd_schedule or (lambda step: weight_decay)
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": plain, "weight_decay": 0.0}],
            lr=lr_schedule(0), betas=(b1, b2), eps=eps)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        # summed in fp64: PyTorch's fp32 norm on the CPU drifts by 1e-4 to
        # 1e-3 relative over a tensor of millions of entries (VAR-d16's head)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float64) for g in grads])).float()
        if self.grad_clip > 0:
            # optax clip_by_global_norm: g * max / |g| only where |g| >= max,
            # with no epsilon (clip_grad_norm_ divides by |g| + 1e-6)
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        decay, plain = self.opt.param_groups
        decay["lr"] = plain["lr"] = self.lr_schedule(self.count)
        decay["weight_decay"] = self.wd_schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.count = state["count"]


def adamw_with_freezing(model: nn.Module, lr_schedule: Callable[[int], float], *,
                        weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                        grad_clip: float = 0.0, eps: float = 1e-8,
                        weight_decay_end: Optional[float] = None,
                        total_steps: Optional[int] = None,
                        paths: Optional[Dict[str, str]] = None) -> ScheduledAdamW:
    """AdamW over ``model``'s trainable parameters, as the JAX package's
    ``adamw_with_freezing`` builds it: no decay where ``no_decay_predicate``
    says so of the parameter's flax path (``paths[name]``; the name itself
    when no map is given), wd annealed by cosine to ``weight_decay_end``
    over ``total_steps`` when that differs from ``weight_decay``, and one
    global-norm clip over every trainable gradient when ``grad_clip > 0``."""
    paths = paths or {}
    anneal = weight_decay_end is not None and weight_decay_end != weight_decay
    if anneal and not total_steps:
        raise ValueError("weight_decay_end requires total_steps")
    return ScheduledAdamW(
        model.named_parameters(), lr_schedule,
        no_decay=lambda name: no_decay_predicate(paths.get(name, name)),
        weight_decay=weight_decay,
        wd_schedule=wd_cosine_anneal(weight_decay, weight_decay_end, total_steps)
        if anneal else None,
        b1=b1, b2=b2, eps=eps, grad_clip=grad_clip)


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: List[torch.Tensor],
               decay: float = 0.9999):
    """Reference update_ema (utils/ema.py:5-14), in place: e = e * decay +
    p * (1 - decay)."""
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
