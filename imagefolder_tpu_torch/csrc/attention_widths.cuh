// The head widths kD that the BNHD kernels (#3-#6) are compiled at, and the
// check each of their C entries makes of the kD that the wrapper chose
// (ops/cuda/attention.py, bnhd_kernel_width): hd, a multiple of 8 from 8 to
// 1024, runs under the smallest of 48, 64, 128, 256, 512 and 1024 that holds
// it, and a wider hd under the smallest multiple of 1024 that holds it (the
// segmented kernels of attention_wide.cuh, 1024 columns a segment); a kD
// that is not that one is refused.
#pragma once

inline bool bnhd_width_ok(int hd, int kd) {
  const int below = kd == 48     ? 0
                    : kd == 64   ? 48
                    : kd == 128  ? 64
                    : kd == 256  ? 128
                    : kd == 512  ? 256
                    : kd == 1024 ? 512
                    : kd > 1024 && kd % 1024 == 0 ? kd - 1024
                                 : -1;
  return below >= 0 && hd >= 8 && hd % 8 == 0 && hd > below && hd <= kd;
}
