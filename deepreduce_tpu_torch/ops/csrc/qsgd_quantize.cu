// QSGD stochastic quantizer for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (deepreduce_tpu_torch/ops/qsgd_kernel.py).
//
// Replaces the Pallas TPU kernel deepreduce_tpu/ops/qsgd_kernel.py
// (`quantize_levels_pallas`, body `_kernel`). Per element:
//
//     level = sign(v) * (floor(|v| * scale) + [u < frac]),  saturated to int8
//
// with u = (bits >> 8) * 2^-24 as in the TPU kernel. The TPU core's hardware
// PRNG becomes a counter-based Philox-4x32-10: key = (seed lo, seed hi),
// counter = (group lo, group hi, offset lo, offset hi) where group = i / 4,
// and element i takes output word i % 4. The plain PyTorch version
// (`philox_uniforms_plain`, `quantize_levels_plain`) repeats this
// arithmetic exactly, so kernel and plain version agree bitwise.
//
// Bound: memory. Each element reads 8 bytes (value, scale) and writes 1;
// the Philox rounds are ~20 integer multiplies per 4 elements, far below the
// card's integer rate. Design: one thread per group of 4 elements, one
// Philox call per thread, grid-stride loop for any n, no tiles or padding.
// Fast paths (vectorised loads, fusing the bucket norm) are later work.
//
// Numerics: |v| * scale is __fmul_rn so it is never contracted into an FMA
// with the following subtraction (the build also passes -fmad=false); the
// frac and the uniform are then the same floats the plain version computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void qsgd_quantize_kernel(const float* __restrict__ values,
                                     const float* __restrict__ scale,
                                     int8_t* __restrict__ out, int64_t n,
                                     uint2 key, uint32_t off_lo, uint32_t off_hi) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), off_lo, off_hi),
        key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const int64_t base = g * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = base + j;
      if (i < n) out[i] = quantize_one(values[i], scale[i], bits[j]);
    }
  }
}

}  // namespace

extern "C" {

// values, scale: f32[n] on the device; out: int8[n] on the device, allocated
// by the caller. Launches on `stream` and returns cudaGetLastError() as an
// int (0 = success). Does not synchronise.
int qsgd_quantize_levels(const float* values, const float* scale, int8_t* out,
                         long long n, unsigned long long seed,
                         unsigned long long offset, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  qsgd_quantize_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      values, scale, out, static_cast<int64_t>(n), key,
      static_cast<uint32_t>(offset), static_cast<uint32_t>(offset >> 32));
  return static_cast<int>(cudaGetLastError());
}

const char* qsgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
