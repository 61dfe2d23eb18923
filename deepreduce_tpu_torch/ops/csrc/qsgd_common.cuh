// Device helpers shared by the QSGD kernels (qsgd_quantize.cu and
// qsgd_encode.cu), so both draw the same random bits and round alike.
//
// Philox-4x32-10: key = (seed lo, seed hi), counter = (group lo, group hi,
// offset lo, offset hi) where group = i / 4 of the leaf's padded vector, and
// element i takes output word i % 4. The plain PyTorch versions
// (`philox_uniforms_plain`, `quantize_levels_plain` in ops/qsgd_kernel.py)
// repeat this arithmetic exactly.
//
// Numerics: |v| * scale is __fmul_rn so it is never contracted into an FMA
// with the following subtraction (the build also passes -fmad=false); the
// frac and the uniform are then the same floats the plain version computes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qsgd {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words for padded elements 4g .. 4g+3 of the stream (seed, offset).
__device__ __forceinline__ uint4 philox_group(int64_t g, uint2 key, uint32_t off_lo, uint32_t off_hi) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(static_cast<uint64_t>(g) >> 32), off_lo,
                 off_hi),
      key);
}

__device__ __forceinline__ uint32_t word_of(uint4 r, int w) {
  return w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
}

__device__ __forceinline__ int8_t quantize_one(float v, float s, uint32_t bits) {
  const float level_float = __fmul_rn(fabsf(v), s);
  const float lo = floorf(level_float);
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  const float level = lo + ((u < level_float - lo) ? 1.0f : 0.0f);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  // saturating float -> int8, as XLA's convert does
  const float q = fminf(fmaxf(level * sgn, -128.0f), 127.0f);
  return static_cast<int8_t>(q);
}

}  // namespace qsgd
