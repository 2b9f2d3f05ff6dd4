"""The kernels' width routing on the CPU:

- #9 (``codebook_argmin``) is compiled at code widths 8, 16, 32, 64 and
  128; the wrapper passes the true width C and the smallest compiled one
  that holds it (``kernel_width``) to the kernel, which zero-fills its
  tiles' columns past C. At C = 12, 14, 24, 40 and 100, the plain version
  on operands zero-filled so gives the plain version's indices at C (zero
  columns change neither |e|^2 nor x.e), cosine and L2; the launch path
  passes the unpadded operands with (C, its width), and past 128 the width
  goes to 128, which walks C in chunks of 128. The quantizer pads nothing
  on the CPU.
- #3-#6 are compiled at head widths 48, 64, 128, 256, 512 and 1024: each
  width from 1 to 1024 runs under the smallest that holds it (its multiple
  of 8; ``bnhd_kernel_width``), which each of the four wrappers passes to
  its C entry (recorded here with ``_launch`` replaced), and a wider one
  runs under the smallest multiple of 1024 that holds it (the segmented
  kernels).
"""

import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from imagefolder_tpu_torch.ops import quantize
from imagefolder_tpu_torch.ops.cuda import attention as attn
from imagefolder_tpu_torch.ops.cuda import codebook
from tests._torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("c", [12, 14, 24, 40, 100])
@pytest.mark.parametrize("maximize", [True, False], ids=["cosine", "l2"])
def test_padded_search_equals_unpadded(c, maximize):
    g = torch.Generator().manual_seed(c)
    x = torch.randn((300, c), generator=g)
    cb = torch.randn((1000, c), generator=g)
    if maximize:
        x, cb = x / x.norm(dim=1, keepdim=True), cb / cb.norm(dim=1, keepdim=True)
    w = codebook.kernel_width(c)
    assert w in codebook.WIDTHS and w >= c and (w // 2 < c or w == 8)
    xp, cbp = F.pad(x, (0, w - c)), F.pad(cb, (0, w - c))  # as the kernel's tiles hold them
    want = codebook.codebook_argmin_reference(x, cb, maximize)
    got = codebook.codebook_argmin_reference(xp, cbp, maximize)
    assert torch.equal(got, want)
    assert torch.equal(codebook.codebook_argmin(x, cb, maximize), want)


def test_code_widths_map_to_the_compiled_ones():
    """Up to 128 the smallest compiled width that holds C; past it 128,
    which walks C in chunks of 128; a width below 1 is refused."""
    assert [codebook.kernel_width(c) for c in (1, 8, 9, 16, 17, 33, 64, 65, 128)] == \
        [8, 8, 16, 16, 32, 64, 64, 128, 128]
    assert [codebook.kernel_width(c) for c in (129, 256, 1000)] == [128, 128, 128]
    with pytest.raises(ValueError, match="positive, got 0"):
        codebook.kernel_width(0)


def test_quantizer_pads_nothing_on_the_cpu():
    cb = torch.randn((64, 12))
    rest = torch.randn((10, 12))
    assert torch.equal(quantize._codebook_lookup(rest, cb, False),
                       codebook.codebook_argmin_reference(rest, cb))


@pytest.mark.parametrize("c", [12, 14, 32, 100])
def test_codebook_launch_passes_the_true_width_and_its_kernel_width(c, monkeypatch):
    """The card's launch path, with the kernel entry replaced by a recorder:
    x and the codebook reach it unpadded (C columns), with C and
    ``kernel_width(C)``; one launch is counted. Past 128 the call launches
    at (C, 128), the chunked search."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(codebook, "_kernel", lambda: entry)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(
        cuda_stream=None))
    x, cb = torch.randn((50, c)), torch.randn((70, c))
    before = codebook.LAUNCHES
    codebook._codebook_argmin_cuda(x, cb, False)
    assert codebook.LAUNCHES == before + 1
    (xp, cbp, e2, _, n, v, cc, w, _), = calls
    assert (n, v, cc, w) == (50, 70, c, codebook.kernel_width(c))
    assert xp == x.data_ptr() and cbp == cb.data_ptr() and e2 is not None
    codebook._codebook_argmin_cuda(torch.randn((5, 129)), torch.randn((7, 129)), True)
    assert len(calls) == 2 and codebook.LAUNCHES == before + 2
    assert calls[1][4:8] == (5, 7, 129, 128) and calls[1][2] is None  # cosine: no |e|^2


@pytest.mark.parametrize("hd,want", [(1, 48), (8, 48), (48, 48), (56, 64), (64, 64),
                                     (72, 128), (128, 128), (129, 256), (256, 256),
                                     (257, 512), (264, 512), (512, 512), (513, 1024),
                                     (1000, 1024), (1024, 1024)])
def test_head_widths_route_to_the_compiled_ones(hd, want):
    assert attn.bnhd_kernel_width(hd) == want


@pytest.mark.parametrize("hd", [1025, 1032, 4096])
def test_head_widths_past_the_cap_are_refused(hd):
    """Past the widest FMA instantiation (1024), refused until the segmented
    kernels: now the smallest multiple of 1024 that holds the width (its
    segments); only a width below 1 is refused."""
    assert attn.bnhd_kernel_width(hd) == -(-hd // 1024) * 1024
    with pytest.raises(ValueError, match="positive, got 0"):
        attn.bnhd_kernel_width(0)


@pytest.mark.parametrize("hd,want", [(40, 48), (64, 64), (80, 128), (200, 256), (264, 512),
                                     (1000, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wrappers_pass_the_kernel_width_to_the_c_entries(hd, want, dtype, monkeypatch):
    """#3, #4, #5 and #6 on the card's launch path with ``_launch`` replaced
    by a recorder: each entry gets the head width padded to a multiple of 8
    and, last, the kD that ``bnhd_kernel_width`` picks for it."""
    calls = []
    monkeypatch.setattr(attn, "_launch", lambda what, entry, device, *args: calls.append(
        (what, args)))
    g = torch.Generator().manual_seed(hd)
    q, k, v, o = (torch.randn((1, 70, 2, hd), generator=g).to(dtype) for _ in range(4))
    lse = torch.zeros((1, 2, 70))
    attn._fused_attention_cuda(q, k, v, None, 0.125)
    attn._fused_attention_qblk_cuda(q, k, v, None, 0.125)
    attn._fused_attention_bwd_cuda(q, k, v, None, o, 0.125, False, o=o, lse=lse)
    attn._fused_attention_qblk_bwd_cuda(q, k, v, None, o, 0.125, False, o=o, lse=lse)
    assert [w for w, _ in calls] == ["fused_attention", "fused_attention_qblk",
                                     "fused_attention backward",
                                     "fused_attention_qblk backward"]
    assert all(args[-2:] == (-(-hd // 8) * 8, want) for _, args in calls)
