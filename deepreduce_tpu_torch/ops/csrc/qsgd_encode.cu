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
// The norm's float64 sum has one log-depth order, repeated by the plain
// version (`bucket_sq_sums_ordered`): the bucket zero-padded to 128 * J
// elements (J a power of two) is read as [J, 32, 4], element 128 j + 4 l + i
// (chunk (j, l), lane l); each chunk's four squares fold in pairs, then the
// J chunks of each lane in adjacent pairs, then the 32 lanes in adjacent
// pairs. More zero padding adds exact zeros. A float32 square is exact in
// float64.
//
// What bounds it (PERF.md: the phase-6 sweep of chip_smoke.py, which also
// times `qsgd_encode_floor`, this kernel's parameter block and grid with an
// empty body, and `--compare-encode`). Not the bytes (4 per live value
// read, 1 per padded element and 4 per bucket written: 2,419,028 B, 0.722
// us at 3.35 TB/s, on the WordLSTM's 12-segment table) but the launch
// floor, 0.82 us for one block and 1.10 us for that table's 476, and the
// latency of a bucket's dependent chain where a launch has few buckets.
// Where it has many (the 4,050,944-element segment reaches 52-60% of its
// bytes bound) the limit is not measured by unit; the instruction
// throughput of the per-element work (four conversions and a quarter of a
// ten-round Philox call) is a hypothesis. What the design does:
// - the order lets lane l of a warp hold the chunks (j, l) of a run of rows
//   j: a warp's loads and stores are contiguous (512 and 128 bytes an
//   instruction), a lane folds its chunks in registers, the warps of a
//   bucket meet through shared memory, and one XOR butterfly over the lanes
//   finishes (every lane ends with the same bits: nothing is broadcast).
//   The chain is 2 + log2(chunks) adds in the thread, log2(warps) after
//   the barrier and 5 folds, where the earlier kernel's lane summed 16
//   squares in a row. The adjacent-pair tree over a whole bucket (four
//   butterflies a warp at 512) measured about 10% slower on the largest
//   table;
// - the geometry follows the launch's buckets per SM (the card's count,
//   read once per device): up to 2, a bucket is spread over bucket_size / 4
//   threads (one float4 and one Philox call each, 128 threads at 512),
//   which shortens its chain; up to 16, two float4s a lane; above, four,
//   which took the least time on the largest table. A block has 128
//   threads (one to four buckets), which keeps the block count, and so the
//   floor, low;
// - each thread draws its Philox words while its loads are in flight;
// - the segment lookup is a binary search over a compact first-bucket
//   array at the head of the parameter block: log2(count) dependent reads
//   with one address per warp, none for one segment. One round of
//   independent compares, or per-lane reads and ballots (whose addresses
//   differ across the warp and serialise in the constant cache), measured
//   slower; a parameter block sized to the call (704 B against 2,816 B)
//   left the floor unchanged.
// A launch with any segment's values off a 16-byte boundary takes the
// vector kernel's variant that checks each bucket's segment and loads such
// values as scalars (the check read slower on the L2-flushed large segment,
// PERF.md, so an aligned launch skips it). Bucket sizes that are not a
// multiple of 4 or above 4,096 take a generic kernel over the same chunks
// and order: scalar loads (twice, the second from cache) and byte stores.
// The kernel reads every byte once and reuses nothing, so tensor cores and
// TMA have no part in it.

#include <atomic>
#include <climits>

#include "qsgd_common.cuh"

namespace {

// The wrapper's table (ops/qsgd_encode.py MAX_SEGMENTS): room for every
// compressed leaf of the paper's models in one launch (BERT-base's 88,
// ResNet-50's 76). The block, 5,632 B, is past the 4 KB that CUDA before
// 12.1 allowed a kernel's parameters.
constexpr int kMaxSegments = 128;
constexpr int kMaxThreads = 1024;
constexpr int kMaxRegChunks = 4;  // float4 chunks a lane holds in registers
constexpr unsigned kFullMask = 0xffffffffu;

struct Segment {
  const float* values;
  uint8_t* out;
  unsigned long long seed;
  unsigned long long offset;
  long long k;
};

struct SegmentTable {
  int first_bucket[kMaxSegments];  // the global index of each segment's bucket 0; INT_MAX past the count
  Segment seg[kMaxSegments];
};

// What every thread of a launch shares besides the table.
struct Shape {
  int total;        // buckets
  int top;          // the largest power of two below the segment count (0 for one segment)
  int bs;           // bucket_size
  int chunks;       // chunks (j) a lane takes
  int group_shift;  // log2 of the warps a bucket takes
  float q;
};

// The segment of bucket gb, the last whose first bucket is <= gb: a binary
// search over the compact first-bucket array.
__device__ __forceinline__ int find_segment(const SegmentTable& table, int gb, int top) {
  int si = 0;
  for (int step = top; step > 0; step >>= 1) {
    if (table.first_bucket[si + step] <= gb) si += step;
  }
  return si;
}

__device__ __forceinline__ double square(float x) {
  const double d = static_cast<double>(x);
  return __dmul_rn(d, d);
}

__device__ __forceinline__ double chunk_sum(float x, float y, float z, float w) {
  return __dadd_rn(__dadd_rn(square(x), square(y)), __dadd_rn(square(z), square(w)));
}

// Adds v as the j-th leaf of an adjacent-pair tree kept as one partial per
// level; after leaf 2^n - 1 the returned value is the tree's root.
__device__ __forceinline__ double push_leaf(double* level, int j, double v) {
  int l = 0;
  for (; (j >> l) & 1; ++l) v = __dadd_rn(level[l], v);
  level[l] = v;
  return v;
}

// The bucket's float32 norm from each lane's sum over its chunks: the
// bucket's `warps` warps (a power of two, aligned in the block) meet through
// shared memory, lane l folding the warps' column-l sums in adjacent pairs,
// then the 32 lanes fold in an XOR butterfly, after which every lane holds
// the root. Every thread of the block calls it once, from one place; the
// launch gives a block of multi-warp buckets 8 bytes of shared memory a
// thread.
__device__ __forceinline__ float bucket_norm(double part, int warps) {
  extern __shared__ double partial[];
  if (warps > 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    partial[threadIdx.x] = part;
    __syncthreads();
    const double* col = partial + 32 * (warp & ~(warps - 1)) + lane;
    double level[6];
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      if (w >= warps) break;
      part = push_leaf(level, w, col[32 * w]);
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) part = __dadd_rn(part, __shfl_xor_sync(kFullMask, part, d));
  return __double2float_rn(__dsqrt_rn(part));
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

// One bucket as a thread sees it.
struct Bucket {
  const float* values;
  long long k;     // the segment's live values
  long long base;  // padded index of the bucket's element 0
  uint8_t* row;
  uint2 key;
  uint32_t off_lo, off_hi;
  int first;  // the lane's first chunk row j
  int lane;
  bool live;  // false past the last bucket: the thread folds zeros and writes nothing
  __device__ uint4 group(int64_t g) const { return qsgd::philox_group(g, key, off_lo, off_hi); }
  __device__ float value(long long e, int bs) const {
    const long long i = base + e;
    return e < bs && i < k ? values[i] : 0.0f;
  }
};

// The thread's bucket: a bucket is taken by 2^group_shift warps, a block by
// blockDim.x / 32 >> group_shift buckets, and lane l of the bucket's warp w
// by the chunks (w * chunks + m, l), m < chunks.
__device__ __forceinline__ Bucket locate(const Shape& shape, const SegmentTable& table) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, gs = shape.group_shift;
  const int gb = static_cast<int>(blockIdx.x) * ((static_cast<int>(blockDim.x) >> 5) >> gs) + (warp >> gs);
  Bucket bk;
  bk.live = gb < shape.total;
  const int bucket = bk.live ? gb : shape.total - 1;
  const int si = find_segment(table, bucket, shape.top);
  const Segment& s = table.seg[si];
  const long long b = bucket - table.first_bucket[si];  // the bucket within its segment
  bk.values = s.values;
  bk.k = s.k;
  bk.base = b * shape.bs;
  bk.row = s.out + b * (shape.bs + 4);
  bk.key = make_uint2(static_cast<uint32_t>(s.seed), static_cast<uint32_t>(s.seed >> 32));
  bk.off_lo = static_cast<uint32_t>(s.offset);
  bk.off_hi = static_cast<uint32_t>(s.offset >> 32);
  bk.first = (warp & ((1 << gs) - 1)) * shape.chunks;
  bk.lane = static_cast<int>(threadIdx.x) & 31;
  return bk;
}

template <int kChunks, bool kAlignedOut>
__device__ __forceinline__ void store_levels(const Bucket& bk, int bs, float scale, const float4* x, const uint4* r) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int e = 128 * (bk.first + m) + 4 * bk.lane;
    if (e < bs) {
      const char4 o = make_char4(qsgd::quantize_one(x[m].x, scale, r[m].x), qsgd::quantize_one(x[m].y, scale, r[m].y),
                                 qsgd::quantize_one(x[m].z, scale, r[m].z), qsgd::quantize_one(x[m].w, scale, r[m].w));
      uint8_t* dst = bk.row + e;
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
}

// The vector path: bucket_size % 4 == 0 and <= 4,096; kChunks (1, 2 or 4)
// float4s a lane in registers, loaded as one float4 where the segment's
// values are 16-byte aligned (always, with kAlignedIn).
template <int kChunks, bool kAlignedIn>
__global__ void __launch_bounds__(kMaxThreads / kChunks)
    qsgd_encode_rows_kernel(const Shape shape, const __grid_constant__ SegmentTable table) {
  const Bucket bk = locate(shape, table);
  const int bs = shape.bs;
  const bool aligned_in = kAlignedIn || (reinterpret_cast<uintptr_t>(bk.values) & 15) == 0;
  float4 x[kChunks];
  uint4 r[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int e = 128 * (bk.first + m) + 4 * bk.lane;
    const long long i = bk.base + e;
    x[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (bk.live && e < bs) {
      if (aligned_in && i + 4 <= bk.k) {
        x[m] = __ldg(reinterpret_cast<const float4*>(bk.values + i));
      } else if (i < bk.k) {
        x[m].x = bk.values[i];
        if (i + 1 < bk.k) x[m].y = bk.values[i + 1];
        if (i + 2 < bk.k) x[m].z = bk.values[i + 2];
        if (!kAlignedIn && i + 3 < bk.k) x[m].w = bk.values[i + 3];  // a whole float4 only off 16 bytes
      }
    }
  }
  // the random bits do not depend on the values: draw them while the loads
  // are in flight
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int e = 128 * (bk.first + m) + 4 * bk.lane;
    r[m] = bk.live && e < bs ? bk.group((bk.base + e) >> 2) : make_uint4(0u, 0u, 0u, 0u);
  }
  double sum[kChunks];
#pragma unroll
  for (int m = 0; m < kChunks; ++m) sum[m] = chunk_sum(x[m].x, x[m].y, x[m].z, x[m].w);
#pragma unroll
  for (int w = kChunks / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int m = 0; m < w; ++m) sum[m] = __dadd_rn(sum[2 * m], sum[2 * m + 1]);
  }
  const float norm = bucket_norm(sum[0], 1 << shape.group_shift);
  if (!bk.live) return;
  const float scale = scale_of(norm, shape.q);
  const bool aligned_out = (reinterpret_cast<uintptr_t>(bk.row) & 3) == 0;
  if (aligned_out) {
    store_levels<kChunks, true>(bk, bs, scale, x, r);
  } else {
    store_levels<kChunks, false>(bk, bs, scale, x, r);
  }
  if (bk.first == 0 && bk.lane == 0) store_norm(bk.row + bs, norm, aligned_out);
}

// The generic path: any bucket size and alignment, any number of chunks a
// lane, over the same chunks and the same order: scalar loads (twice, the
// second from cache) and byte stores.
__global__ void __launch_bounds__(kMaxThreads)
    qsgd_encode_rows_kernel_generic(const Shape shape, const __grid_constant__ SegmentTable table) {
  const Bucket bk = locate(shape, table);
  const int bs = shape.bs;
  double level[32];
  double part = 0.0;
  for (int m = 0; bk.live && m < shape.chunks; ++m) {
    const long long e = 128LL * (bk.first + m) + 4 * bk.lane;
    part = push_leaf(level, m, chunk_sum(bk.value(e, bs), bk.value(e + 1, bs), bk.value(e + 2, bs),
                                         bk.value(e + 3, bs)));
  }
  const float norm = bucket_norm(part, 1 << shape.group_shift);
  if (!bk.live) return;
  const float scale = scale_of(norm, shape.q);
  long long g = -1;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  for (int m = 0; m < shape.chunks; ++m) {
    const long long e0 = 128LL * (bk.first + m) + 4 * bk.lane;
    for (long long e = e0; e < e0 + 4 && e < bs; ++e) {
      const long long i = bk.base + e;
      if ((i >> 2) != g) {  // a chunk straddles Philox groups when bs % 4 != 0
        g = i >> 2;
        r = bk.group(g);
      }
      bk.row[e] = static_cast<uint8_t>(
          qsgd::quantize_one(bk.value(e, bs), scale, qsgd::word_of(r, static_cast<int>(i & 3))));
    }
  }
  if (bk.first == 0 && bk.lane == 0) store_norm(bk.row + bs, norm, false);
}

// The launch floor: the same parameter block and grid, no work.
__global__ void __launch_bounds__(kMaxThreads)
    qsgd_encode_floor_kernel(const Shape shape, const __grid_constant__ SegmentTable table) {}

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

}  // extern "C"

namespace {

// The float4 chunks a lane takes, by the launch's buckets per SM: one (a
// bucket of 512 over four warps) up to 2, two up to 16, four above (PERF.md,
// the phase-6 sweep).
constexpr long long kSpreadBucketsPerSm = 2;
constexpr long long kHalfBucketsPerSm = 16;
constexpr int kVecBucketMax = 4096;  // the vector path: 32 chunk rows, a lane's chunks in registers
constexpr int kMaxDevices = 64;

// The current device's SM count, read once per device.
cudaError_t sm_count(int* n) {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  *n = counts[dev].load(std::memory_order_relaxed);
  if (*n > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) counts[dev].store(*n, std::memory_order_relaxed);
  return e;
}

struct Geometry {
  int chunks, group_shift, block;
  long long blocks;
};

// `vec`: the vector path, which holds at most kMaxRegChunks chunks a lane.
Geometry geometry(int bs, long long total, int sms, bool vec) {
  long long j = 1;  // the bucket zero-padded to 128 * j elements
  while (128 * j < bs) j <<= 1;
  long long c = total <= kSpreadBucketsPerSm * sms ? 1 : (total <= kHalfBucketsPerSm * sms ? 2 : kMaxRegChunks);
  if (c > j) c = j;
  if (j / c > kMaxThreads / 32) c = j / (kMaxThreads / 32);
  const long long warps = j / c;
  const long long max_threads = vec ? kMaxThreads / c : kMaxThreads;
  long long per = warps < 4 ? 4 / warps : 1;  // 128-thread blocks
  while (per > 1 && 32 * warps * per > max_threads) per >>= 1;
  Geometry g;
  g.chunks = static_cast<int>(c);
  g.group_shift = 0;
  while ((1LL << g.group_shift) < warps) ++g.group_shift;
  g.block = static_cast<int>(32 * warps * per);
  g.blocks = (total + per - 1) / per;
  return g;
}

template <int kChunks>
void launch_vec(bool aligned, unsigned int blocks, int block, size_t smem, cudaStream_t stream, const Shape& shape,
                const SegmentTable& table) {
  if (aligned) {
    qsgd_encode_rows_kernel<kChunks, true><<<blocks, block, smem, stream>>>(shape, table);
  } else {
    qsgd_encode_rows_kernel<kChunks, false><<<blocks, block, smem, stream>>>(shape, table);
  }
}

int launch(const QsgdEncodeSegment* segs, int count, int bucket_size, int quantum_num, cudaStream_t stream,
           bool floor) {
  if (count < 0 || count > kMaxSegments || bucket_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SegmentTable table{};
  long long total = 0;
  int used = 0;
  bool aligned = true;
  for (int i = 0; i < count; ++i) {
    const long long buckets = (segs[i].k + bucket_size - 1) / bucket_size;
    if (buckets <= 0) continue;
    table.first_bucket[used] = static_cast<int>(total);
    table.seg[used] = Segment{segs[i].values, segs[i].out, segs[i].seed, segs[i].offset, segs[i].k};
    aligned = aligned && (reinterpret_cast<uintptr_t>(segs[i].values) & 15) == 0;
    total += buckets;
    if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    ++used;
  }
  for (int i = used; i < kMaxSegments; ++i) table.first_bucket[i] = INT_MAX;
  if (total == 0) return 0;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = bucket_size % 4 == 0 && bucket_size <= kVecBucketMax;
  const Geometry g = geometry(bucket_size, total, sms, vec);
  Shape shape;
  shape.total = static_cast<int>(total);
  shape.top = used > 1 ? 1 : 0;  // the largest power of two <= used - 1
  while (shape.top > 0 && 2 * shape.top <= used - 1) shape.top *= 2;
  shape.bs = bucket_size;
  shape.chunks = g.chunks;
  shape.group_shift = g.group_shift;
  shape.q = static_cast<float>(quantum_num);
  const unsigned int blocks = static_cast<unsigned int>(g.blocks);
  const size_t smem = g.group_shift > 0 ? sizeof(double) * g.block : 0;
  if (floor) {
    qsgd_encode_floor_kernel<<<blocks, g.block, smem, stream>>>(shape, table);
  } else if (!vec) {
    qsgd_encode_rows_kernel_generic<<<blocks, g.block, smem, stream>>>(shape, table);
  } else if (g.chunks == 1) {
    launch_vec<1>(aligned, blocks, g.block, smem, stream, shape, table);
  } else if (g.chunks == 2) {
    launch_vec<2>(aligned, blocks, g.block, smem, stream, shape, table);
  } else {
    launch_vec<4>(aligned, blocks, g.block, smem, stream, shape, table);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qsgd_encode_max_segments(void) { return kMaxSegments; }

// Writes the wire rows of `count` (<= qsgd_encode_max_segments()) segments in
// one launch on `stream`. Returns cudaGetLastError() as an int (0 = success),
// or cudaErrorInvalidValue for arguments it refuses. Does not synchronise.
int qsgd_encode_rows(const QsgdEncodeSegment* segs, int count, int bucket_size, int quantum_num, void* stream) {
  return launch(segs, count, bucket_size, quantum_num, static_cast<cudaStream_t>(stream), false);
}

// The launch floor of the same call: an empty kernel with qsgd_encode_rows's
// parameter block and grid. Writes nothing.
int qsgd_encode_floor(const QsgdEncodeSegment* segs, int count, int bucket_size, int quantum_num, void* stream) {
  return launch(segs, count, bucket_size, quantum_num, static_cast<cudaStream_t>(stream), true);
}

const char* qsgd_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
