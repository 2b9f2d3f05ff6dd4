"""VAR: next-scale-prediction transformer, inference (counterpart of
``imagefolder_tpu/models/var.py``).

GPT-2-style decoder over the multi-scale token pyramid (L = sum pn^2):
class-embedding SOS + per-scale level embedding + absolute positions, AdaLN
conditioning (shared or per-block), block-causal attention (scale i attends
to scales <= i), and a head of ``codebook_size * product_quant`` logits (the
PQ branches folded, decoded in parallel). Attention goes through the
``fused_attention`` kernel on (B, L, H, hd) views.

Module and parameter names follow the upstream torch layout that
``imagefolder_tpu/utils/convert_torch.py::export_var`` writes, so its state
dicts load with ``strict=True``. Numerics follow the JAX package op for op:
Dense layers compute in the activation dtype (bf16 or fp32) from fp32
parameters, the AdaLN modulation, the LayerNorms and the residual stream are
fp32, and the head is fp32.

KV cache: the JAX package concatenates each stage's k/v onto the cache (its
arrays are immutable). The port preallocates one (B, L, H, hd) cache per
block (``VAR.init_caches``) and writes each stage into it in place;
attention reads the filled prefix as a strided view, with no copy.

Training: ``forward(..., train=True)`` adds class dropout, MLM-style token
dropout and per-block drop path (var.py:186-193, 289-316), with every random
draw taken from an explicit ``torch.Generator`` (``VAR.draw_masks``) before
the blocks run, so that ``remat`` (activation checkpointing per block)
recomputes with the same masks. The two packages' generators differ, so a
test passes the masks themselves (``masks=``). Dropout and attention dropout
(``drop_rate``, ``attn_drop_rate``) are 0 in every configuration and, as in
the JAX package, not applied.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from imagefolder_tpu_torch.ops.cuda.attention import fused_attention
from imagefolder_tpu_torch.ops.cuda.block import dense
from imagefolder_tpu_torch.utils.init import linear, normal_, trunc_normal_

__all__ = ["VARConfig", "VAR", "KVCache", "build_attn_bias"]


@dataclasses.dataclass
class VARConfig:
    """Mirror of the JAX package's VARConfig: same fields, same defaults."""

    vocab_size: int          # total head logits = codebook_size * product_quant
    Cvae: int                # total latent channels = codebook_embed_dim * P
    product_quant: int = 1
    num_classes: int = 1000
    depth: int = 16
    embed_dim: int = 1024    # reference: 64 * depth
    num_heads: int = 16      # reference: depth
    mlp_ratio: float = 4.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6
    shared_aln: bool = False
    cond_drop_rate: float = 0.1
    attn_l2_norm: bool = False
    patch_nums: Sequence[int] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    p_drop: float = 0.15     # MLM-style token dropout budget (var.py:130)
    remat: bool = False      # activation checkpointing per block (training)
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32

    @property
    def L(self) -> int:
        return sum(p * p for p in self.patch_nums)

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2

    @property
    def begin_ends(self) -> List[tuple]:
        out, cur = [], 0
        for p in self.patch_nums:
            out.append((cur, cur + p * p))
            cur += p * p
        return out


def build_attn_bias(patch_nums: Sequence[int]) -> torch.Tensor:
    """Block-causal bias (var.py:110-116): a token of scale i attends to the
    scales <= i. (1, 1, L, L) fp32 of 0 / -inf. Scales are told apart by
    position, so a repeated size is its own scale."""
    d = torch.cat([torch.full((p * p,), i) for i, p in enumerate(patch_nums)])
    bias = torch.zeros(d.numel(), d.numel()).masked_fill(d[:, None] < d[None, :],
                                                         float("-inf"))
    return bias[None, None]


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without scale or bias, fp32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


class KVCache:
    """One block's preallocated keys and values, (B, L, H, hd) each, and the
    number of positions filled so far."""

    def __init__(self, batch: int, length: int, heads: int, head_dim: int,
                 dtype: torch.dtype, device: torch.device):
        self.k = torch.empty((batch, length, heads, head_dim), dtype=dtype, device=device)
        self.v = torch.empty_like(self.k)
        self.filled = 0

    def append(self, k: torch.Tensor, v: torch.Tensor):
        """Write (B, l, H, hd) k, v after the filled prefix; return views of
        the whole prefix, these positions included."""
        end = self.filled + k.shape[1]
        if end > self.k.shape[1]:
            raise ValueError(f"KV cache of {self.k.shape[1]} positions cannot take {end}")
        self.k[:, self.filled:end] = k
        self.v[:, self.filled:end] = v
        self.filled = end
        return self.k[:, :end], self.v[:, :end]


class VARSelfAttention(nn.Module):
    """basic_var.py:58-134: fused qkv with a zero k bias, optional L2-normed
    q and k with a learned per-head temperature, optional KV cache."""

    def __init__(self, embed_dim: int, num_heads: int, attn_l2_norm: bool = False,
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = embed_dim
        self.num_heads, self.head_dim, self.dtype = num_heads, c // num_heads, dtype
        self.attn_l2_norm = attn_l2_norm
        self.mat_qkv = linear(c, 3 * c, generator, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(c))
        self.v_bias = nn.Parameter(torch.zeros(c))
        self.proj = linear(c, c, generator)
        if attn_l2_norm:
            self.scale_mul_1H11 = nn.Parameter(torch.full((1, num_heads, 1, 1), math.log(4.0)))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        b, l, c = x.shape
        dt = self.dtype
        bias_full = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = dense(x, self.mat_qkv.weight, bias_full).view(b, l, 3, self.num_heads,
                                                            self.head_dim)
        q, k, v = qkv.unbind(2)  # (B, L, H, hd) strided views
        if self.attn_l2_norm:
            scale = 1.0
            # (1, H, 1, 1) in the params, (1, 1, H, 1) for the BLHc layout
            mul = self.scale_mul_1H11.clamp(max=math.log(100.0)).exp().transpose(1, 2)
            q = (q.float() / (torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True)
                              + 1e-12) * mul).to(dt)
            k = (k.float() / (torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True)
                              + 1e-12)).to(dt)
        else:
            scale = 0.25 / math.sqrt(self.head_dim)
        if cache is not None:
            k, v = cache.append(k, v)
        out = fused_attention(q, k, v, bias=attn_bias, scale=scale)
        return dense(out.view(b, l, c), self.proj.weight, self.proj.bias)


class FFN(nn.Module):
    def __init__(self, embed_dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(embed_dim, hidden, generator)
        self.fc2 = linear(hidden, embed_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # reference GELU(approximate='tanh')
        h = F.gelu(dense(x, self.fc1.weight, self.fc1.bias), approximate="tanh")
        return dense(h, self.fc2.weight, self.fc2.bias)


class AdaLNSelfAttn(nn.Module):
    """basic_var.py:140-171: AdaLN-modulated attention and FFN around an
    fp32 residual stream; returns the activation dtype. ``drop_path`` is the
    block's drop-path rate in training."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 shared_aln: bool = False, attn_l2_norm: bool = False,
                 norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 drop_path: float = 0.0, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = embed_dim
        self.embed_dim, self.shared_aln, self.norm_eps, self.dtype = c, shared_aln, norm_eps, dtype
        self.drop_path = drop_path
        self.attn = VARSelfAttention(c, num_heads, attn_l2_norm, dtype, generator=generator)
        self.ffn = FFN(c, round(c * mlp_ratio), generator=generator)
        if shared_aln:
            self.ada_gss = nn.Parameter(
                normal_(torch.empty(1, 1, 6, c), 1.0 / math.sqrt(c), generator))
        else:
            self.ada_lin = nn.Sequential(nn.SiLU(), linear(c, 6 * c, generator))

    def _drop_path(self, y: torch.Tensor, keep_B: Optional[torch.Tensor]) -> torch.Tensor:
        """y * mask / keep with a per-sample 0/1 mask, as the JAX package's
        ``_drop_path`` applies it."""
        if keep_B is None:
            return y
        return y * keep_B.to(y.dtype)[:, None, None] / (1.0 - self.drop_path)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                keep_attn: Optional[torch.Tensor] = None,
                keep_ffn: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cond: (B, 1, 6, C) shared modulation when ``shared_aln``, else the
        (B, C) class condition. keep_attn, keep_ffn: the (B,) drop-path masks
        of the two sublayers in training, None otherwise."""
        if self.shared_aln:
            gss = (self.ada_gss + cond).float()
        else:
            gss = self.ada_lin(cond.float()).view(-1, 1, 6, self.embed_dim)
        g1, g2, s1, s2, sh1, sh2 = gss.unbind(2)
        dt = self.dtype
        xf = x.float()
        h = _ln(xf, self.norm_eps) * (s1 + 1.0) + sh1
        x = xf + self._drop_path(self.attn(h.to(dt), attn_bias, cache).float() * g1, keep_attn)
        h = _ln(x, self.norm_eps) * (s2 + 1.0) + sh2
        x = x + self._drop_path(self.ffn(h.to(dt)).float() * g2, keep_ffn)
        return x.to(dt)


class AdaLNBeforeHead(nn.Module):
    """basic_var.py:177-186: AdaLN before the head, fp32."""

    def __init__(self, embed_dim: int, norm_eps: float = 1e-6, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim, self.norm_eps = embed_dim, norm_eps
        self.ada_lin = nn.Sequential(nn.SiLU(), linear(embed_dim, 2 * embed_dim, generator))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = self.ada_lin(cond.float()).view(-1, 1, 2, self.embed_dim).unbind(2)
        return _ln(x, self.norm_eps) * (scale + 1.0) + shift


class VAR(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so that every
    device gets the same weights) and then moved to ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, config: VARConfig, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        cfg = self.config = config
        c = cfg.embed_dim
        init_std = math.sqrt(1 / c / 3)
        self.word_embed = linear(cfg.Cvae, c, generator)
        self.class_emb = skip_init(nn.Embedding, cfg.num_classes + 1, c)
        trunc_normal_(self.class_emb.weight, init_std, generator)
        self.pos_start = nn.Parameter(
            trunc_normal_(torch.empty(1, cfg.first_l, c), init_std, generator))
        self.pos_1LC = nn.Parameter(trunc_normal_(torch.empty(1, cfg.L, c), init_std, generator))
        self.lvl_embed = skip_init(nn.Embedding, len(cfg.patch_nums), c)
        trunc_normal_(self.lvl_embed.weight, init_std, generator)
        if cfg.shared_aln:
            self.shared_ada_lin = nn.Sequential(nn.SiLU(), linear(c, 6 * c, generator))
        dpr = np.linspace(0, cfg.drop_path_rate, cfg.depth)  # the JAX package's rates
        self.blocks = nn.ModuleList(
            AdaLNSelfAttn(c, cfg.num_heads, cfg.mlp_ratio, cfg.shared_aln, cfg.attn_l2_norm,
                          cfg.norm_eps, cfg.dtype, float(dpr[i]), generator=generator)
            for i in range(cfg.depth))
        self.head_nm = AdaLNBeforeHead(c, cfg.norm_eps, generator=generator)
        self.head = linear(c, cfg.vocab_size, generator)
        if cfg.p_drop > 0:  # the learned empty token of MLM-style training
            self.empty_emb = skip_init(nn.Embedding, 1, c)
            trunc_normal_(self.empty_emb.weight, init_std, generator)
        # level id of every position (by scale position: sizes may repeat)
        lvl = torch.cat([torch.full((p * p,), i) for i, p in enumerate(cfg.patch_nums)])
        self.register_buffer("lvl_1L", lvl, persistent=False)
        self.register_buffer("attn_bias", build_attn_bias(cfg.patch_nums), persistent=False)
        self.to(device)

    def _cond(self, cond_BD: torch.Tensor) -> torch.Tensor:
        if self.config.shared_aln:
            return self.shared_ada_lin(cond_BD).view(cond_BD.shape[0], 1, 6,
                                                     self.config.embed_dim)
        return cond_BD

    def _lvl_pos(self) -> torch.Tensor:
        return self.lvl_embed.weight[self.lvl_1L][None] + self.pos_1LC  # (1, L, C)

    def _head(self, x: torch.Tensor, cond_BD: torch.Tensor) -> torch.Tensor:
        h = self.head_nm(x, cond_BD)
        return F.linear(h, self.head.weight, self.head.bias)  # fp32

    def draw_masks(self, batch: int, prog_si: int = -1, p_drop_factor: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        """Every random draw of one training forward, from ``generator`` (on
        the model's device):
        - ``class_drop`` (B,) bool: u < cond_drop_rate; the label becomes
          ``num_classes`` (absent when the rate is 0);
        - ``token_keep`` (B, ed - first_l) bool: u >= p with p ~ U(0, p_drop *
          p_drop_factor) once per batch; a dropped position takes
          ``empty_emb`` (absent when p_drop * p_drop_factor is 0, where
          every position is kept);
        - ``drop_path``: per block, None where its rate is 0, else the (B,)
          float 0/1 keep masks of its attention and FFN sublayers, each a
          Bernoulli draw of keep = 1 - rate."""
        cfg = self.config
        dev = self.pos_1LC.device
        ed = cfg.begin_ends[prog_si][1] if prog_si >= 0 else cfg.L
        masks: Dict[str, object] = {}
        if cfg.cond_drop_rate > 0:
            masks["class_drop"] = torch.rand(batch, generator=generator,
                                             device=dev) < cfg.cond_drop_rate
        budget = cfg.p_drop * p_drop_factor
        if budget > 0:
            p = torch.rand((), generator=generator, device=dev) * budget
            masks["token_keep"] = torch.rand((batch, ed - cfg.first_l), generator=generator,
                                             device=dev) >= p
        masks["drop_path"] = [
            None if blk.drop_path <= 0 else tuple(
                torch.bernoulli(torch.full((batch,), 1.0 - blk.drop_path, device=dev),
                                generator=generator) for _ in range(2))
            for blk in self.blocks]
        return masks

    def forward(self, label_B: torch.Tensor, x_BLCv_wo_first_l: Optional[torch.Tensor],
                prog_si: int = -1, *, train: bool = False, p_drop_factor: float = 0.0,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """Teacher-forcing forward (var.py:235-292) -> fp32 logits (B, L, vocab).

        ``prog_si >= 0`` is progressive training's truncation: the sequence
        ends at ``begin_ends[prog_si][1]``, and the input covers that much
        (``idxBl_to_var_input(..., prog_si)``; None at stage 0, SOS only).

        ``train=True`` applies class dropout, token dropout and drop path
        with the masks of ``draw_masks(..., p_drop_factor, generator)``, or
        with ``masks`` as that method returns them (a test hook)."""
        cfg = self.config
        ed = cfg.begin_ends[prog_si][1] if prog_si >= 0 else cfg.L
        b = label_B.shape[0]
        if train and masks is None:
            masks = self.draw_masks(b, prog_si, p_drop_factor, generator)
        if not train:
            masks = {}
        if "class_drop" in masks:
            label_B = torch.where(masks["class_drop"], cfg.num_classes, label_B)
        cond_BD = self.class_emb(label_B)
        x = cond_BD[:, None].expand(b, cfg.first_l, cfg.embed_dim) + self.pos_start
        if prog_si != 0:
            x = torch.cat([x, self.word_embed(x_BLCv_wo_first_l.float())], dim=1)
        if x.shape[1] != ed:
            raise ValueError(
                f"teacher-forcing input covers {x.shape[1]} positions but prog stage "
                f"{prog_si} expects {ed}: truncate it with idxBl_to_var_input(..., prog_si)")
        if "token_keep" in masks:
            keep = F.pad(masks["token_keep"], (cfg.first_l, 0), value=True)
            x = torch.where(keep[..., None], x, self.empty_emb.weight[None])
        x = (x + self.lvl_embed.weight[self.lvl_1L[:ed]][None]
             + self.pos_1LC[:, :ed]).to(cfg.dtype)
        cond = self._cond(cond_BD)
        bias = self.attn_bias[:, :, :ed, :ed]
        keeps = masks.get("drop_path") or [None] * cfg.depth
        for blk, keep in zip(self.blocks, keeps):
            args = (x, cond, bias, None, *(keep or (None, None)))
            if train and cfg.remat:
                x = checkpoint(blk, *args, use_reentrant=False)
            else:
                x = blk(*args)
        return self._head(x, cond_BD)

    def init_caches(self, batch: int) -> List[KVCache]:
        """Empty KV caches for a decode of ``batch`` rows (2B under CFG)."""
        cfg = self.config
        hd = cfg.embed_dim // cfg.num_heads
        return [KVCache(batch, cfg.L, cfg.num_heads, hd, cfg.dtype, self.pos_1LC.device)
                for _ in range(cfg.depth)]

    def begin_tokens(self, label_B: torch.Tensor):
        """CFG start (var.py:170-173): the (2B, first_l, C) token map and the
        (2B, C) condition, the unconditional half labelled ``num_classes``."""
        cfg = self.config
        lbl = torch.cat([label_B, torch.full_like(label_B, cfg.num_classes)])
        cond_BD = self.class_emb(lbl)
        ntm = cond_BD[:, None] + self.pos_start + self._lvl_pos()[:, :cfg.first_l]
        return ntm, cond_BD

    def decode_stage(self, x: torch.Tensor, cond_BD: torch.Tensor,
                     caches: Sequence[KVCache]) -> torch.Tensor:
        """All blocks on this stage's tokens, each attending to its cache
        (filled in place) with no bias; returns fp32 logits."""
        cond = self._cond(cond_BD)
        x = x.to(self.config.dtype)
        for blk, cache in zip(self.blocks, caches):
            x = blk(x, cond, cache=cache)
        return self._head(x, cond_BD)

    def next_stage_input(self, next_token_map_BHWC: torch.Tensor, cur_L: int,
                         pn_next: int) -> torch.Tensor:
        """Word-embed the next scale's token map and add its positions
        (var.py:228-230); doubled for CFG."""
        cfg = self.config
        b = next_token_map_BHWC.shape[0]
        tokens = next_token_map_BHWC.reshape(b, pn_next * pn_next, cfg.Cvae)
        x = self.word_embed(tokens.float()) + \
            self._lvl_pos()[:, cur_L:cur_L + pn_next * pn_next]
        return torch.cat([x, x], dim=0)
