// Native host-side data ops for the input pipeline.
//
// The reference's data path is pure Python/PIL; this provides the fused
// crop + horizontal-flip + [-1,1] normalization as a single C++ pass over
// the decoded uint8 buffer (one read, one write, no intermediate arrays).
// Bound via ctypes (no pybind11 in this image); see fastops.py.

#include <cstdint>
#include <cstring>

namespace {

// (v/255 - 0.5)/0.5 computed in double precision per uint8 value, so the
// endpoints are exactly -1.0f and 1.0f (a single-precision multiply-add
// rounds 255 -> 1.0000001, which escapes the [-1, 1] contract; the torch
// reference normalizes via ToTensor + Normalize(0.5, 0.5), which is exact).
struct NormLut {
  float v[256];
  NormLut() {
    for (int i = 0; i < 256; ++i) {
      v[i] = static_cast<float>((i / 255.0 - 0.5) / 0.5);
    }
  }
};
const NormLut kLut;

}  // namespace

extern "C" {

// src: uint8 HWC (src_h, src_w, 3). dst: float32 (size, size, 3).
// Crops at (oy, ox), optionally flips horizontally, maps [0,255] -> [-1,1].
void crop_flip_normalize(const uint8_t* src, int64_t src_h, int64_t src_w,
                         int64_t oy, int64_t ox, int64_t size, int flip,
                         float* dst) {
  for (int64_t y = 0; y < size; ++y) {
    const uint8_t* row = src + ((oy + y) * src_w + ox) * 3;
    float* out = dst + y * size * 3;
    if (flip) {
      for (int64_t x = 0; x < size; ++x) {
        const uint8_t* px = row + (size - 1 - x) * 3;
        out[x * 3 + 0] = kLut.v[px[0]];
        out[x * 3 + 1] = kLut.v[px[1]];
        out[x * 3 + 2] = kLut.v[px[2]];
      }
    } else {
      for (int64_t x = 0; x < size * 3; ++x) {
        out[x] = kLut.v[row[x]];
      }
    }
  }
}

// Batched uint8 -> float32 [-1,1] conversion (collate fast path,
// reference datasets/prefetcher.py fast_collate + device normalize).
void normalize_batch(const uint8_t* src, int64_t n, float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = kLut.v[src[i]];
  }
}

}  // extern "C"
