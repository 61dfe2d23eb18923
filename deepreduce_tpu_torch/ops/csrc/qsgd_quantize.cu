// QSGD stochastic quantizer for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (deepreduce_tpu_torch/ops/qsgd_kernel.py).
//
// Replaces the Pallas TPU kernel deepreduce_tpu/ops/qsgd_kernel.py
// (`quantize_levels_pallas`, body `_kernel`). Per element:
//
//     level = sign(v) * (floor(|v| * scale) + [u < frac]),  saturated to int8
//
// with u = (bits >> 8) * 2^-24 as in the TPU kernel. The TPU core's hardware
// PRNG becomes the counter-based Philox-4x32-10 of qsgd_common.cuh. The plain
// PyTorch version (`philox_uniforms_plain`, `quantize_levels_plain`) repeats
// this arithmetic exactly, so kernel and plain version agree bitwise.
//
// This is the direct counterpart of the TPU kernel, (values, scale) ->
// levels, kept for callers that bring their own scale. The training step's
// QSGD encode does not call it: qsgd_encode.cu fuses the bucket norm, the
// scale, these levels and the wire rows into one grouped launch.
//
// Bound: memory. Each element reads 8 bytes (value, scale) and writes 1;
// the Philox rounds are ~20 integer multiplies per 4 elements, far below the
// card's integer rate. Design: one thread per group of 4 elements, one
// Philox call per thread, grid-stride loop for any n, no tiles or padding.

#include "qsgd_common.cuh"

namespace {

__global__ void qsgd_quantize_kernel(const float* __restrict__ values,
                                     const float* __restrict__ scale,
                                     int8_t* __restrict__ out, int64_t n,
                                     uint2 key, uint32_t off_lo, uint32_t off_hi) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = qsgd::philox_group(g, key, off_lo, off_hi);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const int64_t base = g * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = base + j;
      if (i < n) out[i] = qsgd::quantize_one(values[i], scale[i], bits[j]);
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
