// QSGD encode for Hopper (sm_90a): bucket norm, scale, stochastic levels and
// wire rows of many leaves in one grouped launch, with a plain C interface
// loaded through ctypes (deepreduce_tpu_torch/ops/qsgd_encode.py).
//
// Replaces the Pallas TPU kernel deepreduce_tpu/ops/qsgd_kernel.py
// (`quantize_levels_pallas`, body `_kernel`) together with what the JAX
// codec (deepreduce_tpu/codecs/qsgd.py `encode`) builds around it in XLA:
// the zero padding, the bucket norm and scale, and the concatenation of the
// levels with the norm bytes. For each segment (one leaf's f32[k] values, a
// Philox stream and a destination) it writes the wire rows
//
//     [bucket_size int8 levels | 4 norm bytes (f32, little-endian)] x B
//
// with B = ceil(k / bucket_size); elements at or past k are zeros made in
// registers. Per bucket: norm = float(sqrt(sum of squares in float64)),
// scale = q / (norm > 0 ? norm : 1) as an IEEE divide, then per element
// level = sign(v) * (floor(|v| * scale) + [u < frac]) (qsgd_common.cuh) with
// element i of the leaf's padded vector taking word i % 4 of
// Philox((i / 4, offset), seed), the stream of qsgd_quantize.cu.
//
// The norm's float64 sum has a fixed order, repeated by the plain version
// (`bucket_norms_ordered`): lane l of the bucket's warp owns the elements e
// with (e / 4) % 32 == l and adds their squares in increasing e; the lanes
// then fold at distances 16, 8, 4, 2, 1. A float32 square is exact in
// float64, so contraction could not change the sum; the build still passes
// -fmad=false for the levels' __fmul_rn.
//
// Bound: memory. Each live value is read once (4 B) and each padded element
// writes one level (1 B), plus 4 norm bytes per bucket: on the WordLSTM's
// 12 compressed leaves 2,419,028 B per worker-step, 0.72 us at 3.35 TB/s.
// The arithmetic (two float64 operations, eight float32 ones and a quarter
// of a Philox call per element) is far below the card's rates. Design: one
// pass over the values, held in registers between the norm and the levels;
// no scale vector, no padded copy and no concatenation touch device memory;
// one launch for every leaf of a step. One warp per bucket: at 512, lane l
// loads the float4 chunks l, l+32, l+64, l+96, so each warp instruction reads
// 512 contiguous bytes; it draws one Philox call per chunk while the loads
// are in flight, and stores one char4 per chunk.
// A segment table passed by value (__grid_constant__) maps buckets to
// leaves; each warp finds its segment by binary search over the first-bucket
// prefix. Bucket sizes that are not a multiple of 4 or above 512, and values
// that are not 16-byte aligned, take a scalar path that reads the values
// twice (the second time from cache) and stores bytes.

#include "qsgd_common.cuh"

namespace {

constexpr int kMaxSegments = 64;
constexpr int kWarpsPerBlock = 4;
constexpr int kRegChunks = 4;  // float4 chunks per lane held in registers: buckets up to 512
constexpr unsigned kFullMask = 0xffffffffu;

struct Segment {
  const float* values;
  uint8_t* out;
  unsigned long long seed;
  unsigned long long offset;
  long long k;
  long long first_bucket;  // global index of the segment's bucket 0
};

struct SegmentTable {
  Segment seg[kMaxSegments];
  int count;
};

struct Stream {
  uint2 key;
  uint32_t off_lo, off_hi;
  __device__ explicit Stream(const Segment& s)
      : key(make_uint2(static_cast<uint32_t>(s.seed), static_cast<uint32_t>(s.seed >> 32))),
        off_lo(static_cast<uint32_t>(s.offset)),
        off_hi(static_cast<uint32_t>(s.offset >> 32)) {}
  __device__ uint4 group(int64_t g) const { return qsgd::philox_group(g, key, off_lo, off_hi); }
};

__device__ __forceinline__ double add_square(double acc, float x) {
  const double d = static_cast<double>(x);
  return __dadd_rn(acc, __dmul_rn(d, d));
}

// Fold the 32 lanes' partial sums (16, 8, 4, 2, 1) and return the bucket's
// float32 norm in every lane.
__device__ __forceinline__ float warp_norm(double acc) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc = __dadd_rn(acc, __shfl_down_sync(kFullMask, acc, w));
  return __double2float_rn(__dsqrt_rn(__shfl_sync(kFullMask, acc, 0)));
}

__device__ __forceinline__ float scale_of(float norm, float q) {
  return __fdiv_rn(q, norm > 0.0f ? norm : 1.0f);
}

__device__ __forceinline__ void store_norm(uint8_t* dst, float norm, bool aligned) {
  const uint32_t bits = __float_as_uint(norm);
  if (aligned) {
    *reinterpret_cast<uint32_t*>(dst) = bits;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) dst[t] = static_cast<uint8_t>(bits >> (8 * t));
  }
}

// bucket_size % 4 == 0, bucket_size <= 512, values 16-byte aligned.
template <bool kAlignedOut>
__device__ void encode_bucket_vec(const Segment& s, long long b, int bs, float q, int lane) {
  const long long base = b * bs;  // padded index of the bucket's element 0
  const int chunks = bs >> 2;
  float4 v[kRegChunks];
#pragma unroll
  for (int j = 0; j < kRegChunks; ++j) {
    const int c = lane + 32 * j;
    const long long i = base + 4LL * c;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < chunks) {
      if (i + 4 <= s.k) {
        x = __ldg(reinterpret_cast<const float4*>(s.values + i));
      } else if (i < s.k) {
        x.x = s.values[i];
        if (i + 1 < s.k) x.y = s.values[i + 1];
        if (i + 2 < s.k) x.z = s.values[i + 2];
      }
    }
    v[j] = x;
  }
  // the random bits do not depend on the values: draw them while the loads
  // are in flight
  const Stream st(s);
  uint4 r[kRegChunks];
#pragma unroll
  for (int j = 0; j < kRegChunks; ++j) {
    r[j] = lane + 32 * j < chunks ? st.group((base >> 2) + lane + 32 * j) : make_uint4(0u, 0u, 0u, 0u);
  }
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < kRegChunks; ++j) {
    if (lane + 32 * j < chunks) {
      acc = add_square(acc, v[j].x);
      acc = add_square(acc, v[j].y);
      acc = add_square(acc, v[j].z);
      acc = add_square(acc, v[j].w);
    }
  }
  const float norm = warp_norm(acc);
  const float scale = scale_of(norm, q);
  uint8_t* row = s.out + b * (bs + 4);
#pragma unroll
  for (int j = 0; j < kRegChunks; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
      const char4 o = make_char4(
          qsgd::quantize_one(v[j].x, scale, r[j].x), qsgd::quantize_one(v[j].y, scale, r[j].y),
          qsgd::quantize_one(v[j].z, scale, r[j].z), qsgd::quantize_one(v[j].w, scale, r[j].w));
      uint8_t* dst = row + 4 * c;
      if (kAlignedOut) {
        *reinterpret_cast<char4*>(dst) = o;
      } else {
        dst[0] = static_cast<uint8_t>(o.x);
        dst[1] = static_cast<uint8_t>(o.y);
        dst[2] = static_cast<uint8_t>(o.z);
        dst[3] = static_cast<uint8_t>(o.w);
      }
    }
  }
  if (lane == 0) store_norm(row + bs, norm, kAlignedOut);
}

// Any bucket_size > 0 and any alignment: the same lane ownership and sum
// order as the vector path, scalar loads (twice) and byte stores.
__device__ void encode_bucket_generic(const Segment& s, long long b, int bs, float q, int lane) {
  const long long base = b * bs;
  double acc = 0.0;
  for (int c = lane; 4 * c < bs; c += 32) {
    for (int t = 0; t < 4 && 4 * c + t < bs; ++t) {
      const long long i = base + 4 * c + t;
      acc = add_square(acc, i < s.k ? s.values[i] : 0.0f);
    }
  }
  const float norm = warp_norm(acc);
  const float scale = scale_of(norm, q);
  const Stream st(s);
  uint8_t* row = s.out + b * (bs + 4);
  for (int c = lane; 4 * c < bs; c += 32) {
    int64_t g = (base + 4 * c) >> 2;
    uint4 r = st.group(g);
    for (int t = 0; t < 4 && 4 * c + t < bs; ++t) {
      const long long i = base + 4 * c + t;
      if ((i >> 2) != g) {  // a chunk straddles two Philox groups when bs % 4 != 0
        g = i >> 2;
        r = st.group(g);
      }
      const float x = i < s.k ? s.values[i] : 0.0f;
      row[4 * c + t] = static_cast<uint8_t>(qsgd::quantize_one(x, scale, qsgd::word_of(r, static_cast<int>(i & 3))));
    }
  }
  if (lane == 0) store_norm(row + bs, norm, false);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    qsgd_encode_rows_kernel(const __grid_constant__ SegmentTable table, long long total_buckets, int bs,
                            float q) {
  const int lane = threadIdx.x & 31;
  const long long gb = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gb >= total_buckets) return;  // whole warps leave together
  // the last segment whose first bucket is <= gb
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.seg[mid].first_bucket <= gb) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Segment s = table.seg[lo];  // into registers: one indexed read of the parameter bank
  const long long b = gb - s.first_bucket;
  const bool vec = (bs & 3) == 0 && bs <= 128 * kRegChunks && (reinterpret_cast<uintptr_t>(s.values) & 15) == 0;
  const bool out_aligned = (bs & 3) == 0 && (reinterpret_cast<uintptr_t>(s.out) & 3) == 0;
  if (!vec) {
    encode_bucket_generic(s, b, bs, q, lane);
  } else if (out_aligned) {
    encode_bucket_vec<true>(s, b, bs, q, lane);
  } else {
    encode_bucket_vec<false>(s, b, bs, q, lane);
  }
}

}  // namespace

extern "C" {

// One segment as the wrapper describes it (ctypes mirrors this layout).
struct QsgdEncodeSegment {
  const float* values;  // f32[k] on the device
  unsigned char* out;   // the segment's first row: ceil(k / bucket_size) * (bucket_size + 4) bytes
  unsigned long long seed;
  unsigned long long offset;
  long long k;
};

int qsgd_encode_max_segments(void) { return kMaxSegments; }

// Writes the wire rows of `count` (<= qsgd_encode_max_segments()) segments in
// one launch on `stream`. Returns cudaGetLastError() as an int (0 = success),
// or cudaErrorInvalidValue for arguments it refuses. Does not synchronise.
int qsgd_encode_rows(const QsgdEncodeSegment* segs, int count, int bucket_size, int quantum_num,
                     void* stream) {
  if (count < 0 || count > kMaxSegments || bucket_size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegmentTable table{};
  long long total = 0;
  int used = 0;
  for (int i = 0; i < count; ++i) {
    const long long buckets = (segs[i].k + bucket_size - 1) / bucket_size;
    if (buckets <= 0) continue;
    table.seg[used] = Segment{segs[i].values, segs[i].out, segs[i].seed, segs[i].offset, segs[i].k, total};
    total += buckets;
    ++used;
  }
  table.count = used;
  if (total == 0) return 0;
  const long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  qsgd_encode_rows_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(table, total, bucket_size,
                                                                 static_cast<float>(quantum_num));
  return static_cast<int>(cudaGetLastError());
}

const char* qsgd_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
