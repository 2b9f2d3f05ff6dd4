"""RAR: randomized autoregressive next-token generator (counterpart of
``imagefolder_tpu/models/rar.py``, reference ``RAR/rar.py``).

A 1-D AR transformer over a tokenizer's flat image tokens: AdaLN-zero
blocks with qk-norm attention, conditioned on a class token plus a
per-position timestep embedding; training over per-sample orders (raster or
random) through shuffled position and target-aware position embeddings;
KV-cached CFG sampling with a cosine-power guidance schedule
(``rar_generate``).

Numerics follow the JAX package op for op: every LayerNorm has eps 1e-6
(flax's default, not PyTorch's 1e-5): ``q_norm``/``k_norm`` on the head dim
in fp32, ``norm1``/``norm2``, and the affine-free final norm; ``adaLN``,
the final AdaLN and ``lm_head`` are fp32 Dense layers, while ``qkv``,
``proj``, ``fc1`` and ``fc2`` compute in the activation dtype from fp32
parameters; the residual stream is added in fp32 and each block returns the
activation dtype.

Attention: the training forward (causal mask) goes through the
``dot_product_attention`` router (#3 on the card, backward #6, which take
RAR-B's head dim 768 / 16 = 48, RAR-XL's 80 and every other width up to
128).
The KV-cached decode is plain PyTorch attention over the written prefix of
each block's cache, as the JAX package's decode is XLA's
``jax.nn.dot_product_attention`` and no kernel of its own: fp32 scores and
softmax, probabilities cast to the activation dtype before p v.

Module and parameter names follow the reference layout that
``imagefolder_tpu/utils/convert_torch.py::export_rar`` writes, so its state
dicts load with ``strict=True``. Dropout and attention dropout are 0 in the
JAX package's forward (it applies none), and so here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from imagefolder_tpu_torch.ops.activations import gelu_exact
from imagefolder_tpu_torch.ops.cuda.attention import dot_product_attention
from imagefolder_tpu_torch.ops.cuda.block import dense, row_dense
from imagefolder_tpu_torch.utils.init import linear, trunc_normal_

__all__ = ["RARConfig", "RARAttention", "RARBlock", "RAR", "RARKVCache", "ar_loss",
           "rar_generate", "sample_tokens", "cfg_scale"]

_EPS = 1e-6  # flax's LayerNorm default, used by every RAR norm


@dataclasses.dataclass
class RARConfig:
    """Mirror of the JAX package's RARConfig: same fields, same defaults."""

    embed_dim: int = 768
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    image_seq_len: int = 256
    codebook_size: int = 4096
    condition_num_classes: int = 1000
    dropout: float = 0.1
    attn_dropout: float = 0.1
    remat: bool = False
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32

    @property
    def none_condition_id(self) -> int:
        return self.condition_num_classes + self.codebook_size + 1

    @property
    def vocab(self) -> int:
        # [0, V-1] image tokens; V mask token; [V+1, V+nclass] classes;
        # V+1+nclass class-drop label (rar.py:324-328)
        return self.codebook_size + 1 + self.condition_num_classes + 1


class RARKVCache:
    """One block's keys and values, (B, capacity, H, hd) each in the cache
    dtype, and the number of positions written. With ``chunk`` the capacity
    starts at ``chunk`` positions and grows by ``chunk`` up to ``max_len``
    (the JAX package's chunked cache, ``rar_generate(decode_chunk=...)``);
    without it the cache holds ``max_len`` from the start. Attention reads
    only the written prefix, so the capacity never changes a result."""

    def __init__(self, batch: int, heads: int, head_dim: int, max_len: int,
                 dtype: torch.dtype, device: torch.device, chunk: Optional[int] = None):
        self.max_len, self.chunk = max_len, chunk
        cap = max_len if not chunk else min(chunk, max_len)
        self.k = torch.zeros((batch, cap, heads, head_dim), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.filled = 0

    def append(self, k: torch.Tensor, v: torch.Tensor):
        """Write (B, n, H, hd) k, v after the written prefix (cast to the
        cache dtype); return views of the whole prefix."""
        end = self.filled + k.shape[1]
        if end > self.max_len:
            raise ValueError(f"KV cache of {self.max_len} positions cannot take {end}")
        if end > self.k.shape[1]:
            cap = self.k.shape[1]
            while cap < end:
                cap = min(cap + self.chunk, self.max_len)
            grow = (0, 0, 0, 0, 0, cap - self.k.shape[1])
            self.k, self.v = F.pad(self.k, grow), F.pad(self.v, grow)
        self.k[:, self.filled:end] = k
        self.v[:, self.filled:end] = v
        self.filled = end
        return self.k[:, :end], self.v[:, :end]


def _layer_norm(x: torch.Tensor, norm: Optional[nn.LayerNorm] = None, tp=None) -> torch.Tensor:
    """fp32 LayerNorm with eps 1e-6, affine when ``norm`` is given; under
    tensor parallelism (``tp``) its parameters enter through f (a head-dim
    norm that every rank applies to its own heads)."""
    w, b = (None, None) if norm is None else (norm.weight, norm.bias)
    if tp is not None and norm is not None:
        w, b = tp.enter(w), tp.enter(b)
    return F.layer_norm(x.float(), x.shape[-1:], w, b, _EPS)


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over the whole (written) k, v, as
    ``jax.nn.dot_product_attention`` computes it: fp32 scores and softmax,
    the probabilities cast to v's dtype before p v. (B, L, H, hd) layouts."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class RARAttention(nn.Module):
    """rar.py:56-118: fused qkv, qk-norm (LayerNorm on the head dim), KV cache.

    ``tp``: under tensor parallelism (``parallel/mesh.py::tp_shard_params``)
    this rank's share of the heads: ``qkv`` holds the q, k and v rows of its
    heads and their bias entries, ``proj`` the matching input columns; the
    input and the whole ``q_norm`` and ``k_norm`` enter through f, the
    partial products of ``proj`` are summed over the model group (g) before
    its bias, and the KV cache holds this rank's heads."""

    tp = None

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.head_dim, self.dtype = num_heads, dim // num_heads, dtype
        self.qkv = linear(dim, 3 * dim, generator)
        self.q_norm = nn.LayerNorm(self.head_dim, eps=_EPS)
        self.k_norm = nn.LayerNorm(self.head_dim, eps=_EPS)
        self.proj = linear(dim, dim, generator)

    @property
    def local_heads(self) -> int:
        """The heads this rank computes (all but under tensor parallelism)."""
        return self.num_heads if self.tp is None else self.num_heads // self.tp.size

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cache: Optional[RARKVCache] = None) -> torch.Tensor:
        b, n, c = x.shape
        dt, tp = self.dtype, self.tp
        if tp is not None:
            x = tp.enter(x)
        qkv = dense(x, self.qkv.weight, self.qkv.bias).view(b, n, 3, self.local_heads,
                                                           self.head_dim)
        q, k, v = qkv.unbind(2)
        q = _layer_norm(q, self.q_norm, tp).to(dt)
        k = _layer_norm(k, self.k_norm, tp).to(dt)
        if cache is not None:
            k, v = cache.append(k, v)
            out = _cached_attention(q, k.to(dt), v.to(dt))
        else:
            out = dot_product_attention(q, k, v, bias=mask)
        return row_dense(out.reshape(b, n, -1), self.proj.weight, self.proj.bias, tp)


class RARMlp(nn.Module):
    """``tp``: under tensor parallelism this rank's share of the hidden
    units (``fc1``'s rows and bias, ``fc2``'s columns)."""

    tp = None

    def __init__(self, dim: int, hidden: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(dim, hidden, generator)
        self.fc2 = linear(hidden, dim, generator)


def _zero_adaln(dim: int, out: int) -> nn.Sequential:
    """SiLU then an fp32 Linear initialised to zeros (AdaLN-zero)."""
    lin = skip_init(nn.Linear, dim, out)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return nn.Sequential(nn.SiLU(), lin)


class RARBlock(nn.Module):
    """AdaLN-zero block (rar.py:138-183)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = _zero_adaln(dim, 6 * dim)
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = RARAttention(dim, num_heads, dtype, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = RARMlp(dim, int(dim * mlp_ratio), generator=generator)

    def forward(self, x: torch.Tensor, c: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cache: Optional[RARKVCache] = None) -> torch.Tensor:
        """x (B, n, D); c (B, n or 1, D), the condition tokens."""
        sh1, sc1, g1, sh2, sc2, g2 = self.adaLN_modulation(c.float()).chunk(6, dim=-1)
        dt = self.dtype
        h = _layer_norm(x, self.norm1) * (1 + sc1) + sh1
        x = x.float() + g1 * self.attn(h.to(dt), mask, cache).float()
        h = _layer_norm(x, self.norm2) * (1 + sc2) + sh2
        m = self.mlp
        h = h.to(dt) if m.tp is None else m.tp.enter(h.to(dt))
        h = row_dense(gelu_exact(dense(h, m.fc1.weight, m.fc1.bias)), m.fc2.weight, m.fc2.bias,
                      m.tp)
        return (x + g2 * h.float()).to(dt)


class FinalAdaLN(nn.Module):
    """The AdaLN before the head: its ``adaLN_modulation`` (fp32, zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.adaLN_modulation = _zero_adaln(dim, 2 * dim)


def _shuffle(x: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Gather rows (axis 1) by per-sample order (rar.py:289-293)."""
    idx = orders if x.dim() == 2 else orders[..., None].expand(*orders.shape, x.shape[-1])
    return torch.gather(x, 1, idx)


class RAR(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` and then moved to
    ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, config: RARConfig, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        cfg = self.config = config
        d = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.embeddings = skip_init(nn.Embedding, cfg.vocab, d)
        trunc_normal_(self.embeddings.weight, 0.02, generator)
        self.pos_embed = nn.Parameter(
            trunc_normal_(torch.empty(1, cfg.image_seq_len + 1024, d), 0.02, generator))
        self.target_aware_pos_embed = nn.Parameter(
            trunc_normal_(torch.empty(1, cfg.image_seq_len + 1024, d), 0.02, generator))
        self.timesteps_embeddings = nn.Parameter(
            trunc_normal_(torch.empty(1, cfg.image_seq_len + 100, d), 0.02, generator))
        self.blocks = nn.ModuleList(
            RARBlock(d, cfg.num_heads, cfg.mlp_ratio, cfg.dtype, generator=generator)
            for _ in range(cfg.depth))
        self.adaln_before_head = FinalAdaLN(d)
        self.lm_head = linear(d, cfg.codebook_size, generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def _final_head(self, x: torch.Tensor, cond_token: torch.Tensor) -> torch.Tensor:
        scale, shift = self.adaln_before_head.adaLN_modulation(cond_token.float()).chunk(2, -1)
        x = _layer_norm(x) * (1 + scale) + shift
        return F.linear(x, self.lm_head.weight, self.lm_head.bias)  # fp32

    def preprocess_condition(self, condition: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             cond_drop_prob: float = 0.0,
                             drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        """class id -> condition-token id, dropped to the none-condition where
        ``drop`` (B,) is true or, without ``drop``, with probability
        ``cond_drop_prob`` (draws from ``generator``; rar.py:303-308)."""
        cfg = self.config
        cond = condition + cfg.codebook_size + 1
        if drop is None and cond_drop_prob > 0 and generator is not None:
            drop = torch.rand(cond.shape, generator=generator,
                              device=cond.device) < cond_drop_prob
        if drop is not None:
            cond = torch.where(drop.to(cond.device), cfg.none_condition_id, cond)
        return cond

    def sample_orders(self, batch: int, random_ratio: float,
                      generator: Optional[torch.Generator] = None, *,
                      uniforms: Optional[torch.Tensor] = None,
                      permutations: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-sample orders (B, L) (rar.py:266-279): a random permutation
        where a uniform falls below ``random_ratio``, else the raster order.
        ``uniforms`` (B,) and ``permutations`` (B, L) are drawn from
        ``generator`` (the uniforms, then one permutation per sample) unless
        given."""
        l, dev = self.config.image_seq_len, self.device
        if uniforms is None:
            uniforms = torch.rand(batch, generator=generator, device=dev)
        if permutations is None:
            permutations = torch.stack([torch.randperm(l, generator=generator, device=dev)
                                        for _ in range(batch)])
        raster = torch.arange(l, device=dev).expand(batch, l)
        use_random = uniforms.to(dev)[:, None] < random_ratio
        return torch.where(use_random, permutations.to(dev), raster)

    def forward(self, input_ids: torch.Tensor, condition: torch.Tensor,
                orders: Optional[torch.Tensor] = None):
        """Training forward (rar.py:319-405): (logits, shuffled labels), the
        fp32 logits (B, 1+L, V) over the [cond, tok_0..tok_{L-1}] positions.
        ``condition`` holds condition-token ids (``preprocess_condition``);
        ``orders`` (B, L) the per-sample orders, raster when None."""
        cfg = self.config
        b, l = input_ids.shape
        if orders is None:
            orders = torch.arange(l, device=input_ids.device).expand(b, l)
        labels = _shuffle(input_ids, orders)
        emb = self.embeddings.weight
        tok_emb = emb[input_ids]
        cond_emb = emb[condition.reshape(b, 1)]
        d = cfg.embed_dim
        pe = self.pos_embed.expand(b, -1, -1)
        ta = self.target_aware_pos_embed.expand(b, -1, -1)
        pe_post = _shuffle(pe[:, 2:2 + l], orders)
        ta_post = _shuffle(ta[:, 2:2 + l], orders)
        x = torch.cat([self.cls_token.expand(b, 1, d), cond_emb, _shuffle(tok_emb, orders)], 1)
        x = x + torch.cat([pe[:, :2], pe_post], dim=1)
        zero = x.new_zeros(b, 1, d)
        x = x + torch.cat([zero, ta_post, zero], dim=1)
        n = x.shape[1]
        pos = torch.arange(n, device=x.device)
        causal = torch.zeros(n, n, device=x.device).masked_fill(
            pos[:, None] < pos[None, :], float("-inf"))[None, None]
        cond_token = cond_emb[:, 0][:, None] + self.timesteps_embeddings[:, :n]
        x = x.to(cfg.dtype)
        recompute = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, cond_token, causal, use_reentrant=False) if recompute \
                else blk(x, cond_token, mask=causal)
        return self._final_head(x[:, 1:], cond_token[:, 1:]), labels

    # ------------------------------ decode pieces ------------------------------ #

    def init_caches(self, batch: int, dtype: torch.dtype = torch.float32,
                    chunk: Optional[int] = None) -> List[RARKVCache]:
        """Empty KV caches of the [cls, cond, tokens] sequence, one per block
        (of the heads this rank computes)."""
        cfg = self.config
        return [RARKVCache(batch, blk.attn.local_heads, cfg.embed_dim // cfg.num_heads,
                           cfg.image_seq_len + 2, dtype, self.device, chunk)
                for blk in self.blocks]

    def decode_step(self, x_tokens: torch.Tensor, cond_token: torch.Tensor,
                    caches: List[RARKVCache]) -> torch.Tensor:
        """The blocks on new position(s), each appending to its cache; fp32 logits."""
        x = x_tokens.to(self.config.dtype)
        for blk, cache in zip(self.blocks, caches):
            x = blk(x, cond_token, cache=cache)
        return self._final_head(x, cond_token)

    def embed_prefill(self, condition: torch.Tensor):
        """[cls, cond] input embeddings (B, 2, D) for the decode's positions 0
        and 1, the condition carrying image position 0's target-aware
        embedding, and their condition tokens (B, 2, D)."""
        cfg = self.config
        b = condition.shape[0]
        cond_emb = self.embeddings.weight[condition.reshape(b, 1)]
        x = torch.cat([self.cls_token.expand(b, 1, cfg.embed_dim), cond_emb], dim=1)
        x = x + self.pos_embed[:, :2]
        ta = self.target_aware_pos_embed
        x = x + torch.cat([torch.zeros_like(ta[:, :1]), ta[:, 2:3]], dim=1)
        return x, cond_emb + self.timesteps_embeddings[:, :2]

    def embed_decode_token(self, tok: torch.Tensor, i: int) -> torch.Tensor:
        """Input embedding (B, 1, D) of image token ``i`` (raster order): the
        token, position 2+i, and the target-aware embedding of the next
        position, 2+i+1 (none after the last token)."""
        x = self.embeddings.weight[tok[:, None]] + self.pos_embed[:, 2 + i:3 + i]
        if i == self.config.image_seq_len - 1:
            return x
        return x + self.target_aware_pos_embed[:, 3 + i:4 + i]

    def decode_cond_token(self, condition: torch.Tensor, i: int) -> torch.Tensor:
        """Condition token (B, 1, D) at decode position 2+i."""
        b = condition.shape[0]
        return self.embeddings.weight[condition.reshape(b, 1)] + \
            self.timesteps_embeddings[:, 2 + i:3 + i]


def ar_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Reference ARLoss (RAR/modules/losses.py:376-390): drop the last
    position, CE against the shuffled labels, and token accuracy."""
    shift = logits[:, :-1].float()
    loss = F.cross_entropy(shift.reshape(-1, shift.shape[-1]), labels.reshape(-1))
    acc = (shift.argmax(-1) == labels).float().mean()
    return loss, acc


def cfg_scale(step: int, seq_len: int, guidance_scale: float, guidance_scale_pow: float) -> float:
    """The guidance at decode step ``step`` (rar.py:354-359): 1 + (scale - 1)
    (1 - cos(((step / L) ** pow) pi)) / 2."""
    ramp = (1 - math.cos(((step / seq_len) ** guidance_scale_pow) * math.pi)) * 0.5
    return (guidance_scale - 1) * ramp + 1


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """One categorical draw per row by the Gumbel-max trick, as
    ``jax.random.categorical`` draws it: argmax(logits / T + g)."""
    return torch.argmax(logits / temperature + gumbel, dim=-1)


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def rar_generate(rar: RAR, condition: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, guidance_scale: float,
                 randomize_temperature: float, guidance_scale_pow: float,
                 cache_dtype: torch.dtype = torch.float32, decode_chunk: Optional[int] = 64,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-cached CFG sampling (rar.py:408-456): (B, image_seq_len) token ids
    for class ids ``condition`` (B,).

    Step i samples from the logits of the last decoded position, mixed as
    uncond + (cond - uncond) * ``cfg_scale(i, ...)`` when ``guidance_scale``
    is not 0 (the batch is doubled with the none-condition), by
    ``sample_tokens`` with Gumbel noise drawn from ``generator``, or read
    from ``noise`` (L, B, V), a test hook that replays another sampler's
    draws. ``decode_chunk`` grows the caches by that many positions (at
    least 4) as the decode goes, as the JAX package does; None allocates
    the full length at once. Attention reads only the written prefix, so
    the tokens are the same for any ``decode_chunk``."""
    cfg = rar.config
    b = condition.shape[0]
    cond = rar.preprocess_condition(condition)
    use_cfg = guidance_scale != 0
    cond_full = torch.cat([cond, torch.full_like(cond, cfg.none_condition_id)]) \
        if use_cfg else cond
    caches = rar.init_caches(cond_full.shape[0], cache_dtype,
                             max(decode_chunk, 4) if decode_chunk else None)
    logits = rar.decode_step(*rar.embed_prefill(cond_full), caches)[:, -1]
    ids = torch.zeros((b, cfg.image_seq_len), dtype=torch.long, device=condition.device)
    for i in range(cfg.image_seq_len):
        if use_cfg:
            s = cfg_scale(i, cfg.image_seq_len, guidance_scale, guidance_scale_pow)
            logits = logits[b:] + (logits[:b] - logits[b:]) * s
        g = noise[i] if noise is not None else _gumbel(logits.shape, generator, logits.device)
        tok = sample_tokens(logits, g.to(logits.device), randomize_temperature)
        ids[:, i] = tok
        if i == cfg.image_seq_len - 1:
            break
        tok_in = torch.cat([tok, tok]) if use_cfg else tok
        x = rar.embed_decode_token(tok_in, i)
        logits = rar.decode_step(x, rar.decode_cond_token(cond_full, i), caches)[:, -1]
    return ids
