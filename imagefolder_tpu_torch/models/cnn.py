"""VQGAN-style CNN encoder and decoder (counterpart of
``imagefolder_tpu/models/cnn.py``; reference ``xqgan_model.py:454-704``).

The taming-transformers backbone: a ``ch`` = 128 base, the ``ch_mult``
pyramid, 2 res blocks per level in the encoder and 3 in the decoder,
single-head attention at the lowest resolution, GroupNorm(32, eps 1e-6) in
fp32 cast back to the activation dtype, swish, a stride-2 downsample conv
with torch's asymmetric (0, 1) pad, nearest-2x upsampling then a conv.

NHWC at the public functions, as in the JAX package; each conv runs on the
channel-first view through ``F.conv2d`` in the activation dtype (the JAX
package leaves its convs to XLA: no kernel of the TPU's is on this path).
``AttnBlock``'s two products over the h*w positions are plain products,
``torch.matmul``, the scores in fp32. Parameters are fp32 in the upstream
torch layout that ``imagefolder_tpu/utils/convert_torch.py::
export_cnn_encoder`` / ``export_cnn_decoder`` write (``conv_blocks.{i}.res.{j}``,
``conv_blocks.{i}.attn.{j}``, ``mid.{0,1,2}``, ``norm_out``, ``conv_out``),
so their state dicts load with ``strict=True``. fp32 convs on the card run
in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off: a reference
turns it off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagefolder_tpu_torch.utils.init import linear_kaiming_uniform_

__all__ = ["Encoder", "Decoder", "ResnetBlock", "AttnBlock", "Downsample", "Upsample"]


class Conv(nn.Module):
    """A Conv2d's parameters (weight (out, in, k, k): torch's default
    kaiming-uniform, as the JAX package's ``conv_kaiming_uniform``; a zero
    bias, flax's default), applied to NHWC input in the activation dtype.

    ``tp``: under tensor parallelism (``parallel/mesh.py::tp_shard_params``)
    the bias is this rank's share of the output channels (the JAX rule splits
    the biases of the attention's q, k and v, whose kernels it leaves whole),
    gathered whole before the conv."""

    tp = None

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(linear_kaiming_uniform_(
            torch.empty(cout, cin, kernel, kernel), cin * kernel * kernel, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = x.dtype
        bias = self.bias if self.tp is None else self.tp.whole(self.bias)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(act), bias.to(act),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Norm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) in fp32, cast back to the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight,
                         self.bias, self.eps)
        return h.permute(0, 2, 3, 1).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = Norm(cin)
        self.conv1 = Conv(cin, cout, generator=generator)
        self.norm2 = Norm(cout)
        self.dropout = dropout
        self.conv2 = Conv(cout, cout, generator=generator)
        self.nin_shortcut = (Conv(cin, cout, 1, padding=0, generator=generator)
                             if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = swish(self.norm2(h))
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, self.training)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the h*w positions (xqgan_model.py:625):
    1x1 q, k, v convs of the normed input, fp32 scores scaled by c^-0.5 and
    their softmax cast to the activation dtype, p v, a 1x1 out conv, and
    the residual."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = Norm(c)
        self.q = Conv(c, c, 1, padding=0, generator=generator)
        self.k = Conv(c, c, 1, padding=0, generator=generator)
        self.v = Conv(c, c, 1, padding=0, generator=generator)
        self.proj_out = Conv(c, c, 1, padding=0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, h * w, c) for m in (self.q, self.k, self.v))
        # the scores of the activation-dtype q and k, summed and kept in fp32
        attn = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(attn * c ** -0.5, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).reshape(b, h, w, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 conv after torch's asymmetric (0, 1) pad (xqgan_model.py:689)."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(c, c, stride=2, padding=0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a conv (xqgan_model.py:675)."""

    def __init__(self, c: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(c, c, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class _Level(nn.Module):
    """One resolution's blocks, under the upstream names ``res``, ``attn``
    and ``downsample`` / ``upsample``."""

    def __init__(self, res, attn, down=None, up=None):
        super().__init__()
        self.res = nn.ModuleList(res)
        if attn:
            self.attn = nn.ModuleList(attn)
        if down is not None:
            self.downsample = down
        if up is not None:
            self.upsample = up

    def blocks(self):
        attn = getattr(self, "attn", None)
        for j, res in enumerate(self.res):
            yield res
            if attn is not None:
                yield attn[j]


class Encoder(nn.Module):
    """NHWC image -> (B, H / 2^(L-1), W / 2^(L-1), z_channels) latents in the
    activation dtype ``dtype``."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 256, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        n = len(ch_mult)
        self.conv_in = Conv(in_channels, ch, generator=generator)
        levels, cin = [], ch
        for i in range(n):
            cout = ch * ch_mult[i]
            res, attn = [], []
            for _ in range(num_res_blocks):
                res.append(ResnetBlock(cin, cout, dropout, generator))
                cin = cout
                if i == n - 1:
                    attn.append(AttnBlock(cout, generator))
            down = Downsample(cout, generator) if i != n - 1 else None
            levels.append(_Level(res, attn, down=down))
        self.conv_blocks = nn.ModuleList(levels)
        self.mid = nn.ModuleList([ResnetBlock(cin, cin, dropout, generator),
                                  AttnBlock(cin, generator),
                                  ResnetBlock(cin, cin, dropout, generator)])
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, z_channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for level in self.conv_blocks:
            for blk in level.blocks():
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        for blk in self.mid:
            h = blk(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """(B, g, g, z) latents -> NHWC image (unclamped) in the activation
    dtype; with ``return_prelast`` also the input of ``conv_out`` (the
    adaptive GAN weight's anchor is ``conv_out.weight``)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 256, out_channels: int = 3,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        n = len(ch_mult)
        cin = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, cin, generator=generator)
        self.mid = nn.ModuleList([ResnetBlock(cin, cin, dropout, generator),
                                  AttnBlock(cin, generator),
                                  ResnetBlock(cin, cin, dropout, generator)])
        levels = []
        for li, i_level in enumerate(reversed(range(n))):
            cout = ch * ch_mult[i_level]
            res, attn = [], []
            for _ in range(num_res_blocks + 1):
                res.append(ResnetBlock(cin, cout, dropout, generator))
                cin = cout
                if i_level == n - 1:
                    attn.append(AttnBlock(cout, generator))
            up = Upsample(cout, generator) if li != n - 1 else None
            levels.append(_Level(res, attn, up=up))
        self.conv_blocks = nn.ModuleList(levels)
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, out_channels, generator=generator)

    @property
    def last_layer(self) -> torch.Tensor:
        return self.conv_out.weight

    def forward(self, z: torch.Tensor, return_prelast: bool = False):
        h = self.conv_in(z.to(self.dtype))
        for blk in self.mid:
            h = blk(h)
        for level in self.conv_blocks:
            for blk in level.blocks():
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = swish(self.norm_out(h))
        out = self.conv_out(h)
        return (out, h) if return_prelast else out
