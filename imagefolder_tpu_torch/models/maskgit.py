"""MaskGIT: masked token generator (counterpart of
``imagefolder_tpu/models/maskgit.py``, reference ``RAR/maskgit.py``).

A bidirectional transformer over [condition, image tokens] with a mask
token: the arccos masking schedule for training (``mask_input_tokens``,
``mlm_loss``) and iterative confidence-based parallel decoding with
constant, linear or power-cosine classifier-free guidance for sampling
(``maskgit_generate``). It shares RAR's token-space convention: image
tokens [0, V), the mask token V, classes shifted by V + 1, the
none-condition V + 1 + classes.

Two trunks (``MaskGITConfig.arch``):
- ``bert``: the ImageBert trunk, ``depth`` pre-LN blocks with LayerNorm eps
  1e-12 and a qkv bias (the JAX package's plain stack in place of
  upstream's HF ``BertModel``);
- ``uvit``: UViTBert (``RAR/maskgit.py:209-287``), depth / 2 in-blocks, a
  mid block and depth / 2 out-blocks, each out-block first fusing its
  mirrored in-block's output through ``skip_linear`` on concat(x, skip);
  eps 1e-5, no qkv bias.

Numerics follow the JAX package op for op: each block's LayerNorms run in
fp32 and cast to the activation dtype; qkv, proj, fc1, fc2 and skip_linear
compute in the activation dtype from fp32 parameters; GELU is exact; the
residual stream is in the activation dtype; the final LayerNorm and
``lm_head`` run in fp32 on the image positions. Attention goes through the
port's ``dot_product_attention`` with no bias (#3 on the card, its backward
#6; MaskGIT-B's heads are 768 / 16 = 48 wide). Dropout is 0, as the JAX
package's forward applies none.

Every random draw is an explicit ``torch.Generator`` draw or an argument:
the condition-drop mask (``drop``), the training ratio ``t`` and masking
``scores``, and each sampling step's two Gumbel draws (``noise``), so that
a test can replay another sampler's draws.

Parameter names: ``uvit`` follows upstream UViTBert's layout, the inverse of
``imagefolder_tpu/utils/convert_torch.py::convert_maskgit_uvit``; ``bert``
uses the same block layout under ``blocks.{i}`` (upstream's trunk is HF
``BertModel``, which the JAX package does not mirror).
``utils/convert.py::maskgit_state_dict_from_flax`` carries the JAX
package's params into either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda.attention import dot_product_attention
from imagefolder_tpu_torch.ops.cuda.block import dense, row_dense
from imagefolder_tpu_torch.parallel.dist import global_sum
from imagefolder_tpu_torch.utils.init import linear, trunc_normal_

__all__ = ["MaskGITConfig", "MaskGITBlock", "MaskGIT", "mask_input_tokens", "mlm_loss",
           "draw_tokens", "remask", "maskgit_generate", "GUIDANCE_DECAYS"]

GUIDANCE_DECAYS = ("constant", "linear", "power-cosine")


@dataclasses.dataclass
class MaskGITConfig:
    """Mirror of the JAX package's MaskGITConfig: same fields, same defaults."""

    embed_dim: int = 768
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    image_seq_len: int = 256
    codebook_size: int = 4096
    condition_num_classes: int = 1000
    dropout: float = 0.1
    dtype_str: str = "float32"
    arch: str = "bert"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32

    @property
    def mask_token_id(self) -> int:
        return self.codebook_size

    @property
    def vocab(self) -> int:
        return self.codebook_size + self.condition_num_classes + 2

    @property
    def none_condition_id(self) -> int:
        return self.condition_num_classes + self.codebook_size + 1


class MaskGITBlock(nn.Module):
    """A pre-LN block of either trunk: ImageBert's ``_Block``
    (``maskgit.py:63-93``: eps 1e-12, qkv with a bias, torch-default Linear
    init) or U-ViT's ``_UViTBlock`` (``maskgit.py:96-134``: eps 1e-5, qkv
    without a bias, trunc_normal(0.02) init, and with ``skip`` a
    ``skip_linear`` on concat(x, skip) first).

    Under tensor parallelism (``parallel/mesh.py::tp_shard_params``)
    ``attn.tp`` and ``mlp.tp`` are this rank's share: ``attn.qkv`` holds the
    q, k and v rows of its heads, ``attn.proj`` their columns, ``mlp.fc1``
    its hidden rows and ``mlp.fc2`` their columns; each sublayer's input
    enters through f, and the partial products of ``proj`` and ``fc2`` are
    summed over the model group (g) before their bias. ``skip_linear``
    stays whole."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype, *,
                 uvit: bool = False, skip: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.eps = 1e-5 if uvit else 1e-12
        hidden = int(dim * mlp_ratio)

        def lin(din, dout, bias=True):  # U-ViT's weights: trunc_normal(0.02)
            layer = linear(din, dout, generator, bias)
            if uvit:
                trunc_normal_(layer.weight, 0.02, generator)
            return layer

        if skip:
            self.skip_linear = lin(2 * dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=self.eps)
        self.attn = nn.Module()  # attn.qkv, attn.proj: upstream's names
        self.attn.qkv = lin(dim, 3 * dim, bias=not uvit)
        self.attn.proj = lin(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=self.eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = lin(dim, hidden), lin(hidden, dim)

    def _norm(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], norm.weight, norm.bias,
                            self.eps).to(self.dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            s = self.skip_linear
            x = dense(torch.cat([x, skip], dim=-1), s.weight, s.bias)
        b, n, d = x.shape
        a, m = self.attn, self.mlp
        ta, tm = getattr(a, "tp", None), getattr(m, "tp", None)
        h = self._norm(x, self.norm1)
        if ta is not None:
            h = ta.enter(h)
        qkv = F.linear(h, a.qkv.weight.to(h.dtype)) if a.qkv.bias is None \
            else dense(h, a.qkv.weight, a.qkv.bias)
        hd = d // self.num_heads
        q, k, v = qkv.view(b, n, 3, qkv.shape[-1] // (3 * hd), hd).unbind(2)
        o = dot_product_attention(q, k, v)
        x = x + row_dense(o.reshape(b, n, -1), a.proj.weight, a.proj.bias, ta)
        h = self._norm(x, self.norm2)
        if tm is not None:
            h = tm.enter(h)
        h = gelu_exact(dense(h, m.fc1.weight, m.fc1.bias))
        return x + row_dense(h, m.fc2.weight, m.fc2.bias, tm)


class MaskGIT(nn.Module):
    """``maskgit.py:137-195``. Parameters are drawn on the CPU from
    ``generator`` and then moved to ``device``, the card unless the caller
    asks for the CPU."""

    def __init__(self, config: MaskGITConfig, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        cfg = self.config = config
        d, dt = cfg.embed_dim, cfg.dtype
        self.embeddings = skip_init(nn.Embedding, cfg.vocab, d)
        trunc_normal_(self.embeddings.weight, 0.02, generator)
        self.pos_embed = nn.Parameter(
            trunc_normal_(torch.empty(1, cfg.image_seq_len + 1, d), 0.02, generator))

        def block(uvit, skip=False):
            return MaskGITBlock(d, cfg.num_heads, cfg.mlp_ratio, dt, uvit=uvit, skip=skip,
                                generator=generator)

        if cfg.arch == "uvit":
            if cfg.depth % 2:
                raise ValueError("the uvit arch needs an even depth")
            half = cfg.depth // 2
            self.in_blocks = nn.ModuleList(block(True) for _ in range(half))
            self.mid_block = block(True)
            self.out_blocks = nn.ModuleList(block(True, skip=True) for _ in range(half))
            self.norm = nn.LayerNorm(d, eps=1e-5)
        elif cfg.arch == "bert":
            self.blocks = nn.ModuleList(block(False) for _ in range(cfg.depth))
            self.norm = nn.LayerNorm(d, eps=1e-12)
        else:
            raise ValueError(f"unknown maskgit arch {cfg.arch!r}")
        self.lm_head = linear(d, cfg.codebook_size, generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def condition_ids(self, condition: torch.Tensor, cond_drop_prob: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """class ids (B,) -> condition-token ids: shifted by codebook_size + 1;
        all the none-condition when ``cond_drop_prob >= 1``; else the
        none-condition where ``drop`` (B,) is true, or, without ``drop``,
        where a uniform from ``generator`` falls below ``cond_drop_prob``."""
        cfg = self.config
        cond = condition + cfg.codebook_size + 1
        if cond_drop_prob >= 1.0:
            return torch.full_like(cond, cfg.none_condition_id)
        if drop is None and cond_drop_prob > 0 and generator is not None:
            drop = torch.rand(cond.shape, generator=generator,
                              device=cond.device) < cond_drop_prob
        if drop is not None:
            cond = torch.where(drop.to(cond.device), cfg.none_condition_id, cond)
        return cond

    def forward(self, input_ids: torch.Tensor, condition: torch.Tensor, *,
                cond_drop_prob: float = 0.1, generator: Optional[torch.Generator] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fp32 logits (B, L, codebook_size) of the image positions for token
        ids ``input_ids`` (B, L) (the mask token where masked) under class
        ids ``condition`` (B,), dropped as ``condition_ids`` says."""
        cfg = self.config
        b = input_ids.shape[0]
        cond = self.condition_ids(condition, cond_drop_prob, generator, drop)
        ids = torch.cat([cond.reshape(b, 1), input_ids], dim=1)
        x = (self.embeddings.weight[ids] + self.pos_embed).to(cfg.dtype)
        if cfg.arch == "uvit":
            skips = []
            for blk in self.in_blocks:
                x = blk(x)
                skips.append(x)
            x = self.mid_block(x)
            for blk in self.out_blocks:
                x = blk(x, skips.pop())
        else:
            for blk in self.blocks:
                x = blk(x)
        x = F.layer_norm(x[:, 1:].float(), x.shape[-1:], self.norm.weight, self.norm.bias,
                         self.norm.eps)
        return F.linear(x, self.lm_head.weight, self.lm_head.bias)


def mask_input_tokens(tokens: torch.Tensor, mask_token_id: int,
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      scores: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arccos masking schedule (``maskgit.py:198-208``): per sample a
    ratio arccos(t) / (pi / 2) of uniform t (clipped to [1e-6, 1]), round(L
    ratio) tokens (at least 1) masked where uniform ``scores`` (B, L) rank
    lowest. t (B,) and scores are drawn from ``generator`` in that order
    unless given. Returns (the tokens with the mask token at the masked
    positions, the bool mask)."""
    b, l = tokens.shape
    dev = tokens.device
    if t is None:
        t = torch.rand(b, generator=generator, device=dev)
    if scores is None:
        scores = torch.rand((b, l), generator=generator, device=dev)
    t, scores = t.to(dev, torch.float32), scores.to(dev, torch.float32)
    ratio = torch.clamp(torch.arccos(t) / (math.pi * 0.5), 1e-6, 1.0)
    num_masked = torch.clamp(torch.round(l * ratio), 1, l)
    ranks = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
    masks = ranks < num_masked[:, None]
    return torch.where(masks, mask_token_id, tokens), masks


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor, masks: torch.Tensor,
             loss_weight_unmasked: float = 0.1):
    """Reference MLMLoss (``RAR/modules/losses.py:355-373``): cross-entropy
    weighted 1 at masked positions and ``loss_weight_unmasked`` elsewhere,
    and the accuracy on the masked positions, averaged over samples. The
    weighted mean is the global batch's (``parallel/dist.py``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = masks.float()
    lw = (1.0 - w) * loss_weight_unmasked + w
    loss = global_sum((nll * lw).sum()) / (global_sum(lw.sum()) + 1e-8)
    correct = ((logits.argmax(-1) == targets).float() * w).sum(1) / (w.sum(1) + 1e-8)
    return loss, correct.mean()


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """-log(-log(u)) of u uniform in [1e-20, 1), as the JAX package draws it."""
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=1e-20)
    return -torch.log(-torch.log(u))


def draw_tokens(logits: torch.Tensor, gumbel: torch.Tensor, temperature: float) -> torch.Tensor:
    """One token per position by Gumbel-max at ``temperature``:
    argmax(logits + T g)."""
    return torch.argmax(logits + temperature * gumbel, dim=-1)


def remask(confidence: torch.Tensor, mask_len: int) -> torch.Tensor:
    """The positions to mask again: confidence at or below each row's
    ``mask_len``-th smallest."""
    cut = torch.sort(confidence, dim=-1).values[:, mask_len - 1:mask_len]
    return confidence <= cut


@torch.no_grad()
def maskgit_generate(model: MaskGIT, condition: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *,
                     guidance_scale: float = 3.0, guidance_decay: str = "constant",
                     guidance_scale_pow: float = 3.0, randomize_temperature: float = 4.5,
                     softmax_temperature_annealing: bool = False, num_sample_steps: int = 8,
                     noise: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                     ) -> torch.Tensor:
    """Iterative parallel decoding (``maskgit.py:228-285``): (B, L) token ids
    for class ids ``condition`` (B,).

    Each of the ``num_sample_steps`` steps runs the model on the current ids
    (the mask token where still masked), with guidance twice (conditioned,
    then with every condition dropped) mixed as cond + (cond - uncond) s
    (constant s = ``guidance_scale``; linear: s = 0 at the first step, then
    ratio * scale), or uncond + (cond - uncond) s with the power-cosine
    ramp; with ``softmax_temperature_annealing`` the logits are divided by
    0.5 + 0.8 (1 - ratio). A token is drawn per masked position by
    Gumbel-max at temperature T = ``randomize_temperature`` (1 - ratio);
    the fixed positions keep their tokens at confidence +inf; then the
    arccos schedule's ``mask_len`` least confident positions (confidence =
    the drawn token's logit plus T times a second Gumbel draw, re-masked
    where <= the mask_len-th smallest) are masked again, except at the last
    step. The two Gumbel draws of each step come from ``generator``
    ((B, L, V) then (B, L)), or from ``noise[step]``, a test hook that
    replays another sampler's draws."""
    if guidance_decay not in GUIDANCE_DECAYS:
        raise ValueError(f"guidance_decay must be one of {GUIDANCE_DECAYS}, "
                         f"got {guidance_decay!r}")
    cfg = model.config
    b, l = condition.shape[0], cfg.image_seq_len
    dev = condition.device
    ids = torch.full((b, l), cfg.mask_token_id, dtype=torch.long, device=dev)
    scale = guidance_scale if guidance_decay == "constant" else 0.0
    for step in range(num_sample_steps):
        ratio = (step + 1) / num_sample_steps
        temp = randomize_temperature * (1.0 - ratio)
        is_mask = ids == cfg.mask_token_id
        if guidance_decay == "power-cosine":
            ramp = (1 - math.cos(((step / num_sample_steps) ** guidance_scale_pow) * math.pi)) * 0.5
            scale = (guidance_scale - 1) * ramp + 1
        if scale != 0:
            cond_logits = model(ids, condition, cond_drop_prob=0.0)
            uncond_logits = model(ids, condition, cond_drop_prob=1.0)
            base = uncond_logits if guidance_decay == "power-cosine" else cond_logits
            logits = base + (cond_logits - uncond_logits) * scale
        else:
            logits = model(ids, condition, cond_drop_prob=0.0)
        if softmax_temperature_annealing:
            logits = logits / (0.5 + 0.8 * (1 - ratio))
        if noise is not None:
            g1, g2 = (g.to(dev) for g in noise[step])
        else:
            g1 = _gumbel(logits.shape, generator, dev)
            g2 = _gumbel((b, l), generator, dev)
        sampled = draw_tokens(logits, g1, temp)
        sampled_logits = torch.gather(logits, -1, sampled[..., None])[..., 0]
        sampled = torch.where(is_mask, sampled, ids)
        sampled_logits = torch.where(is_mask, sampled_logits, math.inf)
        mask_ratio = math.acos(ratio) / (math.pi * 0.5)
        mask_len = int(max(1, min(l - 1, math.floor(l * mask_ratio))))
        if step == num_sample_steps - 1:
            ids = sampled
        else:
            again = remask(sampled_logits + temp * g2, mask_len)
            ids = torch.where(again, cfg.mask_token_id, sampled)
        if guidance_decay == "linear":
            scale = ratio * guidance_scale
    return ids
