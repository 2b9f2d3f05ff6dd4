"""Tokenizer (XQ-GAN) training (counterpart of
``imagefolder_tpu/train/tokenizer_train.py``; reference loop
``xqgan_train.py:439-475`` and ``vq_loss.py:161-261``).

One ``train_step`` is the generator update and then the discriminator
update, as in the JAX package's jitted step:
- generator: the tokenizer's training forward (quantizer dropout, vq and
  commit losses, RobustTok's latent perturbation, the semantic and detail
  teachers' InfoNCE), L2 reconstruction, LPIPS, the discriminator on the
  reconstruction (DinoDisc after DiffAug; PatchGAN and StyleGAN on it as it
  is), the hinge generator loss, the adaptive disc weight from the
  gradients of nll and g_adv at the decoder's last layer, one backward into
  the tokenizer's parameters only (the reference's frozen-disc generator
  pass; the JAX package cuts the path with ``stop_gradient``), and the
  clipped AdamW and the EMA copy;
- discriminator: the detached reconstructions and the real images through
  the discriminator with its state updated (DinoDisc's spectral-norm u,
  PatchGAN's running statistics; the real call starts from what the fake
  call saved), hinge loss plus LeCam against the updated EMAs, and its own
  clipped AdamW;
- bookkeeping: the codebook-usage EMA and the per-scale usage percentages.
With ``grad_accum_steps`` k > 1 each call is a micro-step: both optimizers
update every k-th call, on the mean gradient (``optax.MultiSteps``), while
the step count, the LeCam and usage EMAs, the discriminator's state and the
parameter EMA move at every call.
On the card every ViT attention runs kernel #1 forward and kernel #2
backward (``attention_qkv``), and every multi-scale codebook lookup kernel
#9.

In a multi-process run (``parallel/dist.py``: one process per card, each
with an equal shard of the global batch) every process holds the same
state and takes the same step: the gradients of both optimizers and the
adaptive weight's last-layer gradients are averaged over the processes,
each batch statistic (the hit counts, the LeCam means, the quantizers'
active shares and LFQ's batch entropy, the guides' InfoNCE, the
discriminators' batch norms) is taken over the global batch, the metrics
are the global batch's, and every random draw is made for the global batch
from the shared generator and sliced to this process's rows, so that the
run takes the steps one process would take on the whole batch.

State lives in the modules, the optimizers and a few attributes (the LeCam
EMAs as 0-d tensors, the usage EMA, the host step counts); nothing in a
step synchronises with the host. ``get_random_ratio`` is RobustTok's
annealing of alpha and the top-k budget over epochs (the CLI's).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from imagefolder_tpu_torch.losses.diffaug import diff_aug, draw_aug
from imagefolder_tpu_torch.losses.discriminators import (
    DinoDisc,
    PatchGANDiscriminator,
    StyleGANDiscriminator,
    draw_crop,
)
from imagefolder_tpu_torch.losses.gan import (
    D_LOSSES,
    G_LOSSES,
    LeCamState,
    adaptive_disc_weight,
    adopt_weight,
    lecam_reg,
    lecam_update,
)
from imagefolder_tpu_torch.losses.lpips import LPIPS
from imagefolder_tpu_torch.models.tokenizer import ModelArgs, VQModel
from imagefolder_tpu_torch.ops.perturb import draw_perturbation
from imagefolder_tpu_torch.ops.quantize import update_usage_ema, usage_percent
from imagefolder_tpu_torch.parallel.dist import (all_reduce_mean_, global_batch_rows,
                                                 global_metrics, global_sum, own_rows,
                                                 process_count)
from imagefolder_tpu_torch.train.optim import (
    adamw_with_freezing,
    cosine_with_warmup,
    disc_frozen_predicate,
    ema_update,
    module_flax_paths,
    tokenizer_frozen_predicate,
)

__all__ = ["TokenizerTrainConfig", "TokenizerTrainer", "get_random_ratio"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TokenizerTrainConfig:
    """Mirror of the JAX package's TokenizerTrainConfig: same fields, same
    defaults (reference xqgan_train.py argparse defaults)."""

    lr: float = 1e-4
    disc_lr: float = 1e-4
    global_batch_size: int = 128
    epochs: int = 40
    steps_per_epoch: int = 1000
    lr_scheduler: str = "cosine"  # 'none' | 'cosine'
    min_lr: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 5e-2
    disc_weight_decay: float = 5e-2
    max_grad_norm: float = 1.0

    rec_weight: float = 1.0
    rec_loss: str = "l2"
    perceptual_weight: float = 1.0
    codebook_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 0
    disc_type: str = "dinodisc"
    disc_loss: str = "hinge"
    gen_loss: str = "hinge"
    disc_adaptive_weight: bool = False
    lecam_loss_weight: Optional[float] = None
    aug_prob: float = 1.0
    aug_cutout: float = 0.2
    ema: bool = True
    ema_decay: float = 0.9999
    image_size: int = 256
    dino_depth: int = 12
    grad_accum_steps: int = 1
    # compute dtype of the loss stack (LPIPS VGG convs, DinoDisc trunk)
    loss_dtype: str = "float32"


def get_random_ratio(anneal_start: int, anneal_end: int, end_ratio: float,
                     epoch: int) -> float:
    """RobustTok's annealing ratio (xqgan_train.py:62-68, the JAX package's
    ``scripts/train_tokenizer.py``): 1 before ``anneal_start`` (or with no
    window), then linear from 1 down by ``end_ratio`` over the window, and
    ``end_ratio`` after ``anneal_end``. The training loop passes
    alpha * ratio as ``alpha`` and the ratio as ``delta_ratio``."""
    if epoch < anneal_start or anneal_end <= anneal_start:
        return 1.0
    if epoch > anneal_end:
        return end_ratio
    return 1.0 - (epoch - anneal_start) / (anneal_end - anneal_start) * end_ratio


def _make_disc(tcfg: TokenizerTrainConfig, loss_dtype: torch.dtype,
               generator: Optional[torch.Generator]) -> nn.Module:
    """``disc_type``'s discriminator (the JAX trainer's dispatch), drawn
    from ``generator``; PatchGAN and StyleGAN run in fp32 whatever the loss
    stack's dtype, as the JAX modules do."""
    if tcfg.disc_type == "dinodisc":
        return DinoDisc(tcfg.dino_depth, dtype=loss_dtype, generator=generator)
    if tcfg.disc_type == "patchgan":
        return PatchGANDiscriminator(generator=generator)
    if tcfg.disc_type == "stylegan":
        return StyleGANDiscriminator(tcfg.image_size, generator=generator)
    raise ValueError(f"unknown disc_type {tcfg.disc_type!r}")


@contextlib.contextmanager
def _frozen(params):
    """``params`` with ``requires_grad`` off for the block."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _freeze(module: nn.Module, paths: Dict[str, str], frozen) -> None:
    for name, p in module.named_parameters():
        if frozen(paths[name]):
            p.requires_grad_(False)


class TokenizerTrainer:
    """Owns the ``VQModel``, the frozen ``LPIPS`` and the discriminator
    (``disc_type``: DinoDisc, PatchGAN or StyleGAN), both optimizers, the EMA
    copy of the tokenizer's parameters, the LeCam EMAs, the (P, S, V)
    codebook-usage EMA, ``record_hit`` and ``step``.

    ``generator`` (a CPU generator) draws every parameter, so that each
    device gets the same weights, and seeds the training draws, which come
    from a generator on ``device`` (the card unless the caller asks for the
    CPU). Frozen parameters (the semantic and detail teachers, the VGG,
    DinoDisc's trunk, and a Phi that no scale applies) have
    ``requires_grad`` False and stay out of the optimizers.

    ``shard`` (``parallel/mesh.py``: e.g. ``lambda m: fsdp_shard_params(m,
    mesh)`` or ``tp_shard_params``) splits the tokenizer's parameters before
    its optimizer and EMA copy are made (the EMA takes the same placement);
    ``placements`` is what it returns. The LPIPS net, the discriminator, their optimizer, the LeCam
    and usage EMAs and ``record_hit`` stay whole on every process."""

    def __init__(self, model_cfg: ModelArgs, tcfg: TokenizerTrainConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda",
                 shard: Optional[Callable[[VQModel], dict]] = None):
        self.model_cfg, self.tcfg = model_cfg, tcfg
        self.device = torch.device(device)
        loss_dtype = _DTYPES[tcfg.loss_dtype]
        self.model = VQModel(model_cfg, generator=generator, device=device)
        self.lpips = LPIPS(loss_dtype, generator=generator).to(device)
        self.disc = _make_disc(tcfg, loss_dtype, generator).to(device)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(int(torch.randint(2 ** 62, (), generator=generator)))

        g_paths = module_flax_paths(self.model)
        _freeze(self.model, g_paths, tokenizer_frozen_predicate(model_cfg))
        for qz in self.model.quantizers:  # a Phi that no scale applies has no gradient
            for i, phi in enumerate(getattr(qz, "quant_resi", None) or ()):
                if i not in qz.phis_used():
                    phi.requires_grad_(False)
        _freeze(self.disc, module_flax_paths(self.disc), disc_frozen_predicate)
        # the adaptive weight's anchor, the decoder's last-layer weight as the
        # latest forward used it: read as that forward ends (before FSDP2's
        # post-forward hook, so the gathered copy and not the sharded
        # parameter); the identity head has none and raises there. The hook
        # holds this dict, not the trainer (no model -> trainer reference)
        self._used = used = {}
        if tcfg.disc_adaptive_weight and tcfg.disc_weight:
            self.model.register_forward_hook(
                lambda m, args, out: used.__setitem__("w_last", m.last_layer), prepend=True)
        self.placements = None if shard is None else shard(self.model)

        total = tcfg.epochs * tcfg.steps_per_epoch
        if tcfg.lr_scheduler == "cosine":
            g_sched = cosine_with_warmup(tcfg.lr, tcfg.steps_per_epoch, total, tcfg.min_lr)
            self.d_sched = cosine_with_warmup(
                tcfg.disc_lr, int(0.02 * tcfg.epochs) * tcfg.steps_per_epoch,
                max(total - tcfg.disc_start, 1), tcfg.min_lr)
        else:
            g_sched, self.d_sched = (lambda s: tcfg.lr), (lambda s: tcfg.disc_lr)
        self.gen_opt = adamw_with_freezing(
            self.model, g_sched, weight_decay=tcfg.weight_decay, b1=tcfg.beta1,
            b2=tcfg.beta2, grad_clip=tcfg.max_grad_norm, paths=g_paths,
            grad_accum_steps=tcfg.grad_accum_steps)
        self.disc_opt = self._make_disc_opt()
        self.d_loss = D_LOSSES[tcfg.disc_loss]
        self.g_loss = G_LOSSES[tcfg.gen_loss]

        self.ema_params = None
        self.sync_ema()
        self.lecam = LeCamState.init(self.device)
        p, s, v = model_cfg.product_quant, len(model_cfg.v_patch_nums), model_cfg.codebook_size
        self.usage_ema = torch.zeros((p, s, v), device=self.device)
        self.record_hit = 0
        self.step = 0

    def _make_disc_opt(self):
        return adamw_with_freezing(
            self.disc, self.d_sched, weight_decay=self.tcfg.disc_weight_decay,
            b1=self.tcfg.beta1, b2=self.tcfg.beta2, grad_clip=self.tcfg.max_grad_norm,
            paths=module_flax_paths(self.disc), grad_accum_steps=self.tcfg.grad_accum_steps)

    def reinit_disc_heads(self, generator: Optional[torch.Generator] = None):
        """Periodic discriminator re-initialisation (reference DinoDisc.reinit,
        discriminator_dino.py:219-234; xqgan_train.py:436): parameters drawn
        afresh from ``generator`` (a CPU generator) as at construction,
        DinoDisc keeping its frozen ``dino`` trunk and any other
        discriminator re-initialised whole, and a fresh disc optimizer (no
        moments, the schedule from step 0). The discriminator's state
        (spectral-norm u and sigma, BatchNorm running statistics) is kept, as
        the JAX trainer keeps ``disc_vars``."""
        fresh = _make_disc(self.tcfg, _DTYPES[self.tcfg.loss_dtype], generator)
        fresh_params = dict(fresh.named_parameters())
        with torch.no_grad():
            for name, p in self.disc.named_parameters():
                if not (isinstance(self.disc, DinoDisc) and name.startswith("dino.")):
                    p.copy_(fresh_params[name])
        self.disc_opt = self._make_disc_opt()

    def sync_ema(self):
        """Set the EMA copy to the current parameters (as at initialisation;
        call it after loading weights)."""
        if self.tcfg.ema:
            self.ema_params = [p.detach().clone() for p in self.model.parameters()]

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA copy as a ``VQModel`` state dict (the model's buffers
        with the EMA parameters), as upstream checkpoints keep it under
        "ema"; None without an EMA."""
        if self.ema_params is None:
            return None
        sd = self.model.state_dict()
        for (name, _), e in zip(self.model.named_parameters(), self.ema_params):
            sd[name] = e
        return sd

    def state_dict(self) -> dict:
        """Everything a resumed run needs to continue bit for bit: the
        model, its EMA copy, the discriminator with its state (spectral u
        and sigma, running statistics), both optimizers with their
        schedules' counts and accumulators, the LeCam and codebook-usage
        EMAs, ``record_hit``, ``step`` and the device generator's state."""
        return {"model": self.model.state_dict(), "ema": self.ema_state_dict(),
                "disc": self.disc.state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "lecam": tuple(self.lecam),
                "usage_ema": self.usage_ema, "record_hit": self.record_hit,
                "step": self.step, "rng": self.rng.get_state()}

    def load_state_dict(self, state: dict):
        """Restore ``state_dict()``'s state (tensors from any device)."""
        dev = self.device
        self.model.load_state_dict(state["model"], strict=True)
        self.disc.load_state_dict(state["disc"], strict=True)
        if self.tcfg.ema:
            ema = state["ema"]
            self.ema_params = [ema[name].detach().to(dev).clone()
                               for name, _ in self.model.named_parameters()]
        for opt, key in ((self.gen_opt, "gen_opt"), (self.disc_opt, "disc_opt")):
            st = dict(state[key])
            if st["acc"] is not None:
                st["acc"] = [a.to(dev) for a in st["acc"]]
            opt.load_state_dict(st)
        self.lecam = LeCamState(*(t.to(dev) for t in state["lecam"]))
        self.usage_ema = state["usage_ema"].to(dev)
        self.record_hit, self.step = state["record_hit"], state["step"]
        self.rng.set_state(state["rng"].cpu())

    def _aug(self, x: torch.Tensor, fade_blur: float, draws: Optional[dict]) -> torch.Tensor:
        """DiffAug before DinoDisc; the other discriminators see the images
        as they are (the JAX trainer's ``_aug``)."""
        if not isinstance(self.disc, DinoDisc):
            return x
        return diff_aug(x, self.rng, self.tcfg.aug_prob, self.tcfg.aug_cutout, fade_blur,
                        draws=draws)

    def _disc_apply(self, x: torch.Tensor, crop, update_stats: bool) -> torch.Tensor:
        """The discriminator in training mode (the JAX trainer's
        ``_disc_apply``: batch statistics in both passes), keeping its new
        state only with ``update_stats``."""
        if isinstance(self.disc, DinoDisc):
            return self.disc(x, crop, update_stats=update_stats)
        if isinstance(self.disc, PatchGANDiscriminator):
            return self.disc(x, train=True, update_stats=update_stats)
        return self.disc(x)  # StyleGAN keeps no state

    def _global_draws(self, imgs: torch.Tensor, draws: dict, use_disc: bool) -> dict:
        """In a multi-process run, each draw of the step that ``draws`` does
        not give, made from ``rng`` for the global batch in the order one
        process makes them (the crop, the quantizer dropout, the
        perturbation's uniforms, the three DiffAug calls) and sliced to
        this process's rows; ``draws`` as it is in a world of one."""
        if process_count() == 1:
            return draws
        tcfg, mcfg, rng, dev = self.tcfg, self.model_cfg, self.rng, imgs.device
        b = imgs.shape[0]
        r0, rows = global_batch_rows(b)
        if isinstance(self.disc, DinoDisc) and "crop" not in draws:
            draws["crop"] = draw_crop(imgs.shape[1], rng, dev)
        sn = len(mcfg.v_patch_nums)
        if sn > 1 and "dropout_n" not in draws:
            draws["dropout_n"] = own_rows(
                torch.randint(mcfg.start_drop, sn + 1, (rows,), generator=rng, device=dev), b)
        if mcfg.product_quant == 1 and mcfg.perturb_delta_max > 0 and "perturb" not in draws:
            t = mcfg.v_patch_nums[-1] ** 2  # tokens a sample
            draws["perturb"] = tuple(u[r0 * t:(r0 + b) * t]
                                     for u in draw_perturbation(rows * t, rng, dev))
        if use_disc and isinstance(self.disc, DinoDisc) and tcfg.aug_prob >= 1e-6:
            for k in ("aug_g", "aug_f", "aug_r"):
                if k not in draws:
                    d = draw_aug(rows, rng, dev)
                    draws[k] = {n: v if n == "gates" else tuple(own_rows(u, b) for u in v)
                                for n, v in d.items()}
        return draws

    def train_step(self, imgs: torch.Tensor, *, epoch: int = 0, fade_blur: float = 0.0,
                   alpha: float = 0.0, beta: float = 0.0, delta_ratio: float = 1.0,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One generator and one discriminator update (or, with gradient
        accumulation, one micro-step of each) on (B, H, W, 3) images in
        [-1, 1] on the trainer's device. ``alpha``, ``beta`` and
        ``delta_ratio`` are RobustTok's perturbation settings for this step
        (``get_random_ratio``; used when ``perturb_delta_max`` > 0). Returns
        the JAX package's metrics (0-d tensors, and the (P, S)
        ``codebook_usage_per_scale``) plus ``grad_norm`` and
        ``disc_grad_norm``, the global norms of this call's gradients of the
        two optimizers' parameters before any clip; nothing is read back to
        the host.

        ``draws`` (a test hook) replaces the step's random draws:
        ``dropout_n`` (B,), the perturbation's two uniforms (``perturb``, as
        ``ops.perturb.draw_perturbation`` makes them), the DiffAug uniforms
        of the generator pass, the fake and the real images (``aug_g``,
        ``aug_f``, ``aug_r``, each as ``diffaug.draw_aug`` makes them) and
        DinoDisc's crop-or-resize (``crop``, as ``discriminators.draw_crop``)."""
        tcfg, mcfg = self.tcfg, self.model_cfg
        dev = imgs.device
        use_lpips, use_disc = bool(tcfg.perceptual_weight), bool(tcfg.disc_weight)
        draws = self._global_draws(imgs, dict(draws or {}), use_disc)
        disc_w = adopt_weight(tcfg.disc_weight, self.step + 1, tcfg.disc_start)
        crop = None
        if isinstance(self.disc, DinoDisc):
            crop = draws["crop"] if "crop" in draws else draw_crop(imgs.shape[1], self.rng, dev)
        zero = torch.zeros((), device=dev)

        # ---------------- generator ---------------- #
        # the disc frozen (the reference's frozen-disc generator pass): the
        # backward reaches the tokenizer's parameters only, as under FSDP2
        # the gathered ones that the forward used
        with _frozen(self.disc_opt.params):
            out = self.model(imgs, train=True, epoch=epoch, alpha=alpha, beta=beta,
                             delta_ratio=delta_ratio, generator=self.rng,
                             dropout_n=draws.get("dropout_n"), perturb=draws.get("perturb"))
            dec = out.dec.float()
            rec = ((imgs - dec).square() if tcfg.rec_loss == "l2" else (imgs - dec).abs()).mean()
            perc = self.lpips(imgs, dec).mean() if use_lpips else zero
            g_adv = zero
            if use_disc:
                logits_fake = self._disc_apply(self._aug(dec, fade_blur, draws.get("aug_g")), crop,
                                               update_stats=False)
                g_adv = self.g_loss(logits_fake)
            nll = tcfg.rec_weight * rec + tcfg.perceptual_weight * perc
            d_weight = torch.ones((), device=dev)
            if tcfg.disc_adaptive_weight and use_disc:
                # the decoder's last layer (reference get_last_layer), as
                # this forward used it; the identity head has none and
                # raises, as in the JAX trainer
                w_last = self._used["w_last"]
                g_nll, = torch.autograd.grad(nll, w_last, retain_graph=True)
                g_g, = torch.autograd.grad(g_adv, w_last, retain_graph=True)
                all_reduce_mean_([g_nll, g_g])  # the global batch's gradients
                # under tensor parallelism the linear head's weight is split
                # by columns: the norms sum its shards over the model group
                d_weight = adaptive_disc_weight(g_nll, g_g,
                                                group=getattr(w_last, "shard_group", None))
            loss = (nll + d_weight * disc_w * g_adv
                    + tcfg.codebook_weight * (out.vq_loss + out.commit_loss + out.entropy_loss)
                    + out.sem_loss + out.detail_loss + out.dependency_loss)
            self.gen_opt.zero_grad()
            loss.backward()
        grad_norm = self.gen_opt.step()
        if self.ema_params is not None:
            ema_update(self.ema_params, list(self.model.parameters()), tcfg.ema_decay)
        metrics = dict(rec_loss=rec, perceptual_loss=perc, gen_adv_loss=g_adv,
                       vq_loss=out.vq_loss, commit_loss=out.commit_loss,
                       entropy_loss=out.entropy_loss, sem_loss=out.sem_loss,
                       detail_loss=out.detail_loss, dependency_loss=out.dependency_loss,
                       disc_adaptive_weight=d_weight, gen_loss=loss)
        metrics = {k: v.detach() for k, v in metrics.items()}

        # ---------------- discriminator ---------------- #
        if use_disc:
            dec_sg = out.dec.detach().float()
            fake = self._aug(dec_sg, fade_blur, draws.get("aug_f"))
            real = self._aug(imgs, fade_blur, draws.get("aug_r"))
            logits_fake = self._disc_apply(fake, crop, update_stats=True)
            logits_real = self._disc_apply(real, crop, update_stats=True)
            base = self.d_loss(logits_real, logits_fake)
            if tcfg.lecam_loss_weight:
                # the EMA is updated first, then regularised against
                # (vq_loss.py:239-241), with no gradient through it
                new_lecam = LeCamState(*(t.detach() for t in lecam_update(
                    self.lecam, logits_real, logits_fake)))
                reg = lecam_reg(logits_real, logits_fake, new_lecam)
                d_loss = disc_w * (reg * tcfg.lecam_loss_weight + base)
            else:
                new_lecam = self.lecam
                d_loss = disc_w * base
            self.disc_opt.zero_grad()
            d_loss.backward()
            disc_grad_norm = self.disc_opt.step()
            self.lecam = new_lecam
            metrics.update(disc_loss=d_loss.detach(), logits_real=logits_real.detach().mean(),
                           logits_fake=logits_fake.detach().mean())
        else:
            metrics.update(disc_loss=zero, logits_real=zero, logits_fake=zero)
        metrics = global_metrics(metrics)  # the global batch's means
        metrics["grad_norm"] = grad_norm
        if use_disc:
            metrics["disc_grad_norm"] = disc_grad_norm

        # ---------------- bookkeeping ---------------- #
        self.usage_ema, self.record_hit = update_usage_ema(
            self.usage_ema, global_sum(out.hits_PSV), self.record_hit)
        rows = global_batch_rows(imgs.shape[0])[1]
        usage_ps = usage_percent(self.usage_ema, float(rows * mcfg.num_latent_tokens),
                                 mcfg.codebook_size)
        metrics.update(codebook_usage=usage_ps.mean(), codebook_usage_per_scale=usage_ps,
                       disc_weight=torch.full((), float(disc_w), device=dev))
        self.step += 1
        return metrics
