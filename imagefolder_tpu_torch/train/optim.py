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
  group and, with ``groups``, the JAX package's per-group lr and wd scales
  (reference lr_control.py:55-60), with the schedules, optax's global-norm
  clip and ``optax.MultiSteps``' gradient accumulation;
- ``warmup_cosine_decay_schedule``: optax's, for the RAR and MaskGIT
  trainers;
- ``ema_update`` and ``ema_decay_schedule`` (open-muse's EMA decay).

optax's chain is clip_by_global_norm -> scale_by_adam -> (+ wd * p) ->
scale_by_learning_rate(lr(count)), count from 0. AdamW's decoupled decay
p (1 - lr wd) followed by p - lr adam is the same update, with a group's
lr scaled by its lr_sc and its wd by its wd_sc. Freezing is PyTorch's: a
parameter with ``requires_grad`` False never enters the optimizer (the JAX
labels put ``frozen`` before every group).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from imagefolder_tpu_torch.models.var import VAR
from imagefolder_tpu_torch.parallel.dist import all_reduce_mean_
from imagefolder_tpu_torch.utils.convert import flax_path, var_key_map

__all__ = ["lr_wd_annealing", "wd_cosine_anneal", "cosine_with_warmup",
           "warmup_cosine_decay_schedule", "no_decay_predicate", "var_flax_paths",
           "module_flax_paths", "tokenizer_frozen_predicate", "disc_frozen_predicate",
           "adamw_with_freezing", "ScheduledAdamW", "ema_update", "ema_decay_schedule"]


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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: from step 0 (so the first lr is
    ``init_value``) linear to ``peak_value`` over ``warmup_steps``, then a
    cosine to ``end_value`` at ``decay_steps`` (counted from step 0, warmup
    included), flat after it."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def sched(step: int) -> float:
        if step < warmup_steps:  # never at warmup_steps <= 0
            return init_value + (peak_value - init_value) * step / warmup_steps
        if cos_steps <= 0:
            return peak_value
        count = min(step - warmup_steps, cos_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / cos_steps))
                             + alpha)

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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (FSDP2's parameters and gradients);
    any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_groups(p: torch.Tensor, g: torch.Tensor) -> tuple:
    """The process groups over which ``g``, the gradient of ``p``, is split:
    an FSDP2 gradient's sharded mesh dimensions, a tensor-parallel shard's
    ``shard_group`` (``parallel/mesh.py``), none for a whole tensor."""
    if isinstance(g, DTensor):
        return tuple(g.device_mesh.get_group(i) for i, pl in enumerate(g.placements)
                     if pl.is_shard())
    group = getattr(p, "shard_group", None)
    return () if group is None else (group,)


def _global_norm(grads: List[torch.Tensor], groups: List[tuple]) -> torch.Tensor:
    """The global norm of ``grads``: a whole tensor's norm counted once, and
    the square norms of the shards of split tensors summed over their
    ``groups`` (``_shard_groups``), each group's total counted once."""
    # summed in fp64: PyTorch's fp32 norm on the CPU drifts by 1e-4 to 1e-3
    # relative over a tensor of millions of entries (VAR-d16's head)
    norms, split = [], {}
    for g, gr in zip(grads, groups):
        n = torch.linalg.vector_norm(_local(g), dtype=torch.float64)
        if gr:
            split[gr] = split[gr] + n.square() if gr in split else n.square()
        else:
            norms.append(n)
    for gr, sq in split.items():
        for group in gr:
            dist.all_reduce(sq, group=group)
        norms.append(sq.sqrt())
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class ScheduledAdamW:
    """``torch.optim.AdamW`` over named parameters split by ``no_decay``,
    with lr (and wd) set from their schedules at every update and the
    gradients clipped to one global norm first.

    ``groups``, {name: (predicate(parameter name), lr_sc, wd_sc)}: a
    parameter goes to the first group whose predicate holds (in insertion
    order, before the decay / no-decay split), and that group's lr is the
    schedule's times lr_sc and its wd the schedule's (constant or annealed)
    times wd_sc.

    With ``accum_steps`` k > 1 it is ``optax.MultiSteps``: each ``step()``
    folds this micro-step's gradients into their running mean (acc + (g -
    acc) / (n + 1), the n-th since the last update, kept in ``acc``), and
    only every k-th clips that mean and updates; the others leave the
    parameters bit-unchanged. ``count`` (the schedules' step) counts
    updates, ``mini_step`` the micro-steps since the last one.

    In a multi-process run (``parallel/dist.py``) the gradients are averaged
    over the data group before the norm and the clip, so that every process
    clips the same norm and takes the same step; with accumulation the
    running mean is averaged once, at the update, and a micro-step between
    updates returns the norm of this process's own gradients. Under a mesh
    (``parallel/mesh.py``) the parameters may be split: FSDP2's (DTensors)
    come with gradients it has already reduced over the mesh and are not
    averaged again, a tensor-parallel shard's gradient is averaged over the
    data group like a whole tensor's, and the norm sums each split tensor's
    shards over its groups (``_global_norm``); AdamW steps each shard. With
    accumulation ``acc`` holds each gradient's local shard (an FSDP2
    gradient's ``to_local()``): FSDP2 has reduced each micro-step's
    gradient, so their running mean is the mean of the reduced ones and
    becomes a DTensor gradient of the same placement at the update, not
    averaged again; the micro-step's norm counts FSDP2's gradients
    reduced and the others as this process has them.

    ``step()`` returns the global norm of this micro-step's gradients before
    the clip, a 0-d tensor on their device, and makes no host sync: the clip
    factor stays on the device, and the schedules are host floats of the
    update count."""

    def __init__(self, named_params: Iterable, lr_schedule: Callable[[int], float], *,
                 no_decay: Callable[[str], bool], weight_decay: float = 0.0,
                 wd_schedule: Optional[Callable[[int], float]] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: float = 0.0,
                 accum_steps: int = 1, groups: Optional[Dict[str, tuple]] = None):
        groups = dict(groups or {})
        # (lr scale, wd scale) of each label: the two default groups first
        self.scales = {"default": (1.0, 1.0), "nodecay": (1.0, 0.0),
                       **{g: (lr_sc, wd_sc) for g, (_, lr_sc, wd_sc) in groups.items()}}
        if len(self.scales) != 2 + len(groups):
            raise ValueError(f"group names {list(groups)} clash with default or nodecay")
        buckets = {label: [] for label in self.scales}
        for name, p in named_params:
            if p.requires_grad:
                label = next((g for g, (pred, _, _) in groups.items() if pred(name)), None)
                buckets[label or ("nodecay" if no_decay(name) else "default")].append(p)
        self.params = [p for ps in buckets.values() for p in ps]
        self.lr_schedule, self.grad_clip = lr_schedule, grad_clip
        self.wd_schedule = wd_schedule or (lambda step: weight_decay)
        # one AdamW group a label; a label holding both FSDP2's DTensors and
        # whole tensors is two (the multi-tensor kernels take one kind a list)
        self.group_labels, groups = [], []
        for label, ps in buckets.items():
            kinds = {isinstance(p, DTensor) for p in ps}
            for part in ([ps] if len(kinds) < 2 else
                         [[p for p in ps if isinstance(p, DTensor) == k] for k in (False, True)]):
                self.group_labels.append(label)
                groups.append({"params": part, "weight_decay": weight_decay * self.scales[label][1],
                               "lr": lr_schedule(0) * self.scales[label][0]})
        self.opt = torch.optim.AdamW(groups, lr=lr_schedule(0), betas=(b1, b2), eps=eps)
        self.accum_steps = accum_steps
        self.acc: Optional[List[torch.Tensor]] = None
        self.count = self.mini_step = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def _reduce(self, grads: List[torch.Tensor]) -> None:
        """Average over the data group what FSDP2 has not reduced."""
        all_reduce_mean_([g for g in grads if not isinstance(g, DTensor)])

    def step(self) -> torch.Tensor:
        with_grad = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in with_grad]
        if self.accum_steps == 1:
            self._reduce(grads)
        norm = _global_norm(grads, [_shard_groups(p, p.grad) for p in with_grad])
        if self.accum_steps > 1:
            # optax gives a parameter without a gradient a zero one
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
            local = [_local(g) for g in grads]  # an FSDP2 gradient's shard on this rank
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in local]
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(local, self.acc), float(n + 1)))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return norm
            for p, g, a in zip(self.params, grads, self.acc):
                p.grad = torch.empty_like(g)  # a DTensor like FSDP2's, or a whole tensor
                _local(p.grad).copy_(a)
            torch._foreach_zero_(self.acc)
            grads = [p.grad for p in self.params]
            self._reduce(grads)
        if self.grad_clip > 0:
            # optax clip_by_global_norm: g * max / |g| only where |g| >= max,
            # with no epsilon (clip_grad_norm_ divides by |g| + 1e-6)
            clip_norm = norm if self.accum_steps == 1 else _global_norm(
                grads, [_shard_groups(p, p.grad) for p in self.params])
            factor = torch.where(clip_norm < self.grad_clip, torch.ones_like(clip_norm),
                                 self.grad_clip / clip_norm)
            torch._foreach_mul_([_local(g) for g in grads], factor)
        lr, wd = self.lr_schedule(self.count), self.wd_schedule(self.count)
        for group, label in zip(self.opt.param_groups, self.group_labels):
            lr_sc, wd_sc = self.scales[label]
            group["lr"], group["weight_decay"] = lr * lr_sc, wd * wd_sc
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.count = state["count"]
        self.mini_step, self.acc = state["mini_step"], state["acc"]


def adamw_with_freezing(model: nn.Module, lr_schedule: Callable[[int], float], *,
                        weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                        grad_clip: float = 0.0, eps: float = 1e-8,
                        weight_decay_end: Optional[float] = None,
                        total_steps: Optional[int] = None,
                        paths: Optional[Dict[str, str]] = None,
                        grad_accum_steps: int = 1,
                        groups: Optional[Dict[str, tuple]] = None) -> ScheduledAdamW:
    """AdamW over ``model``'s trainable parameters, as the JAX package's
    ``adamw_with_freezing`` builds it: no decay where ``no_decay_predicate``
    says so of the parameter's flax path (``paths[name]``; the name itself
    when no map is given), wd annealed by cosine to ``weight_decay_end``
    over ``total_steps`` when that differs from ``weight_decay``, one
    global-norm clip over every trainable gradient when ``grad_clip > 0``,
    and with ``grad_accum_steps`` > 1 an update every that many micro-steps
    on their mean gradient (``optax.MultiSteps``). ``groups``, {name:
    (predicate(flax path), lr_sc, wd_sc)}, scales the lr and wd of the
    parameters its predicates pick (``ScheduledAdamW``)."""
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
        b1=b1, b2=b2, eps=eps, grad_clip=grad_clip, accum_steps=grad_accum_steps,
        groups={g: (lambda name, pred=pred: pred(paths.get(name, name)), lr_sc, wd_sc)
                for g, (pred, lr_sc, wd_sc) in (groups or {}).items()})


def ema_decay_schedule(optimization_step: int, *, decay: float = 0.9999,
                       min_decay: float = 0.0, update_after_step: int = 0,
                       use_ema_warmup: bool = False, inv_gamma: float = 1.0,
                       power: float = 2.0 / 3.0) -> float:
    """open-muse EMAModel.get_decay (RAR/modules/ema_model.py:95-109), the
    JAX package's ``ema_decay_schedule``. ``optimization_step`` counts the
    updates including this one (a trainer with ``step`` updates done passes
    ``step + 1``). With s = step - update_after_step - 1: 0 while s <= 0
    (the EMA copies the parameters); else (1 + s) / (10 + s), or with
    warmup 1 - (1 + s / inv_gamma)^-power, clipped to [min_decay, decay]."""
    s = max(0, optimization_step - update_after_step - 1)
    if s <= 0:
        return 0.0
    cur = 1.0 - (1.0 + s / inv_gamma) ** (-power) if use_ema_warmup else (1.0 + s) / (10.0 + s)
    return min(max(cur, min_decay), decay)


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], params: List[torch.Tensor],
               decay: float = 0.9999):
    """Reference update_ema (utils/ema.py:5-14), in place: e = e * decay +
    p * (1 - decay); shard by shard where the two are split alike."""
    ema_params, params = [_local(e) for e in ema_params], [_local(p) for p in params]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
