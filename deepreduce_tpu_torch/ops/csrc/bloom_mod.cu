// The mod-blocked bloom index codec for Hopper (sm_90a): the filter's insert,
// the encoder's universe query with compaction and value gather, and the
// decoder's placement, each one launch a leaf, with a plain C interface
// loaded through ctypes (deepreduce_tpu_torch/ops/bloom_mod.py).
//
// These kernels replace no Pallas kernel: on the TPU the JAX package leaves
// the three stages to XLA fusions (deepreduce_tpu/codecs/bloom.py `insert`,
// `query_universe`, `sparse._prefix_positions`, `decode_dense`). The port
// ran them as plain PyTorch, some 500 small launches a leaf a step, which
// kept the card idle while the host issued them. Each kernel computes what
// the plain version, that torch code (codecs/bloom.py `insert`'s mod branch,
// `_fp_aware_payload` and `decode_dense`'s prefix branch), computes, bit
// for bit:
//
// - insert: the words start at zero (a memset); live slot s < nnz (nnz read
//   from device memory) ORs lane_mask(j) into word j mod W, j = indices[s].
//   OR is order-free, so the words are those of the scatter-and-pack.
// - select (encode): universe index j < d is a hit when
//   (words[j mod W] & lane_mask(j)) == lane_mask(j); a hit of ascending
//   rank r < budget writes values[r] = flat[j]. The values start at zero (a
//   memset), so the slots past the hit count stay zero; the last tile
//   writes nsel = min(hits, budget).
// - place (decode): the same hits and ranks; dense[j] = vals[r] for a hit
//   of rank r < min(nsel, budget, n_vals), else 0, for every j < d. The
//   bound is read from device memory: no second pass, no host read.
// lane_mask(j) sets the h lanes of 5-bit fields of fmix32(j ^ seed1) (and
// of fmix32(j ^ seed2) for lanes 6..11), in uint32 registers. Nothing is
// computed in floating point: values are moved as 2-, 4- or 8-byte words.
//
// What bounds it: the larger of the bytes (the filter words, the budget
// values gathered, and in the decoder the d output elements, at 3.35 TB/s)
// and the integer work of the hashing, about 25 operations a universe index
// (one or two fmix32, h shifts and ORs, the mask test, the word index). At
// BERT-base's embedding (d = 23,440,896, h = 3) that is 94 MB written by the
// decoder (28 us) against ~590 M integer operations (~35 us at 132 SMs x 64
// lanes x 1.98 GHz), so the query is near the line between the two. What
// the design does:
// - a tile is 4,096 consecutive universe indices (256 threads x 16), item i
//   of thread t at j = base + 256 i + t: a warp's word loads are 32
//   consecutive words of j mod W (coalesced, from L2), and the decoder's
//   stores are coalesced. The word index advances by 256 mod W per item,
//   with no division. A tile reads each word of its window once (more only
//   where W < 4,096, from L1), so staging the words in shared memory would
//   add a pass over them and save no device-memory read;
// - ranks come from one ballot per item and warp (popc of the lower lanes),
//   a scan of the tile's 128 warp counts in shared memory by one warp, and
//   a decoupled look-back over the tiles: a block takes its tile from an
//   atomic counter (so every earlier tile is running or done), publishes its
//   count, then sums its predecessors' published counts 32 at a time until
//   one has published its inclusive prefix. The counter and the tile states
//   are the wrapper's scratch, zeroed by a memset before the launch;
// - the encoder skips its writes in a tile whose prefix is past the budget;
//   the tile state is published all the same, for the tiles after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kCounts = kItems * kWarps;  // warp counts a tile scans
constexpr int kPerLane = kCounts / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kSeedLane1 = 0x6A09E667u;
constexpr uint32_t kSeedLane2 = 0xBB67AE85u;
// a tile state: flag in the upper 32 bits, count in the lower
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

static_assert(kCounts % 32 == 0, "the warp counts split evenly over one warp's lanes");

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The h (1..12) in-word lanes of index j: lanes 0..5 from fmix32(j ^ seed1),
// 6..11 from fmix32(j ^ seed2), lane l from bits 5 (l mod 6) .. +4.
__device__ __forceinline__ uint32_t lane_mask(uint32_t j, int h) {
  const uint32_t r1 = fmix32(j ^ kSeedLane1);
  uint32_t m = 0;
#pragma unroll
  for (int l = 0; l < 6; ++l) {
    if (l < h) m |= 1u << ((r1 >> (5 * l)) & 31u);
  }
  if (h > 6) {
    const uint32_t r2 = fmix32(j ^ kSeedLane2);
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      if (l + 6 < h) m |= 1u << ((r2 >> (5 * l)) & 31u);
    }
  }
  return m;
}

__device__ __forceinline__ long long read_count(const void* p, int bytes) {
  return bytes == 8 ? *static_cast<const long long*>(p) : static_cast<long long>(*static_cast<const int*>(p));
}

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    bloom_insert_kernel(const I* __restrict__ indices, long long k, const void* nnz, int nnz_bytes,
                        uint32_t* __restrict__ words, int n_words, int h) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= k || s >= read_count(nnz, nnz_bytes)) return;
  const long long j = static_cast<long long>(indices[s]);
  long long w = j % n_words;
  if (w < 0) w += n_words;
  atomicOr(words + w, lane_mask(static_cast<uint32_t>(j), h));
}

struct RankArgs {
  const uint32_t* words;
  long long d;
  int n_words;
  int h;
  int step_mod;  // kThreads mod n_words
  long long budget;
  const void* src;    // select: flat[d]; place: vals[n_vals]
  void* dst;          // select: values[budget]; place: dense[d]
  long long n_vals;   // place only
  const void* nsel_in;  // place only: the payload's count
  int nsel_bytes;
  int* nsel_out;  // select only
  unsigned long long* state;  // [tiles]
  unsigned int* counter;
};

// One tile: the hits of its 4,096 indices, their ranks, then the kDecode
// stage's writes. T is the element moved (2, 4 or 8 bytes).
template <bool kDecode, typename T>
__global__ void __launch_bounds__(kThreads) bloom_rank_kernel(RankArgs a) {
  __shared__ unsigned int s_counts[kCounts];
  __shared__ int s_tile;
  __shared__ long long s_prefix;
  __shared__ long long s_bound;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    s_tile = static_cast<int>(atomicAdd(a.counter, 1u));
    long long bound = a.budget;
    if (kDecode) {
      const long long n = read_count(a.nsel_in, a.nsel_bytes);
      bound = min(min(bound, n), a.n_vals);
    }
    s_bound = bound;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;

  uint32_t ballots[kItems];
  uint32_t wi = static_cast<uint32_t>((base + t) % a.n_words);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads + t;
    bool hit = false;
    if (j < a.d) {
      const uint32_t m = lane_mask(static_cast<uint32_t>(j), a.h);
      hit = (__ldg(a.words + wi) & m) == m;
    }
    ballots[i] = __ballot_sync(kFullMask, hit);
    wi += a.step_mod;
    if (wi >= static_cast<uint32_t>(a.n_words)) wi -= a.n_words;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) s_counts[i * kWarps + warp] = __popc(ballots[i]);
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the warp counts in (item, warp) order
    unsigned int c[kPerLane];
    unsigned int run = 0;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      c[e] = s_counts[lane * kPerLane + e];
      run += c[e];
    }
    unsigned int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int up = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += up;
    }
    const unsigned int aggregate = __shfl_sync(kFullMask, incl, 31);
    unsigned int ex = incl - run;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      s_counts[lane * kPerLane + e] = ex;
      ex += c[e];
    }
    // publish, then look back over the earlier tiles
    if (lane == 0) store_state(a.state + tile, (tile == 0 ? kInclusive : kAggregate) | aggregate);
    unsigned int exclusive = 0;
    if (tile > 0) {
      int last = tile - 1;
      while (true) {
        const int p = last - lane;
        unsigned long long st;
        do {
          st = p >= 0 ? load_state(a.state + p) : kInclusive;
        } while (__any_sync(kFullMask, (st >> 32) == 0));
        const unsigned int inclusive = __ballot_sync(kFullMask, (st >> 32) == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        unsigned int v = lane <= stop ? static_cast<unsigned int>(st) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
        exclusive += v;
        if (inclusive) break;
        last -= 32;
      }
      if (lane == 0) store_state(a.state + tile, kInclusive | (exclusive + aggregate));
    }
    if (lane == 0) {
      s_prefix = exclusive;
      if (!kDecode && tile == static_cast<int>(gridDim.x) - 1) {
        *a.nsel_out = static_cast<int>(min(static_cast<long long>(exclusive) + aggregate, a.budget));
      }
    }
  }
  __syncthreads();

  const long long prefix = s_prefix;
  const long long bound = s_bound;
  const unsigned int below = (1u << lane) - 1u;
  if (kDecode) {
    const T* vals = static_cast<const T*>(a.src);
    T* dense = static_cast<T*>(a.dst);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = base + static_cast<long long>(i) * kThreads + t;
      if (j >= a.d) break;
      T out = 0;
      if ((ballots[i] >> lane) & 1u) {
        const long long r = prefix + s_counts[i * kWarps + warp] + __popc(ballots[i] & below);
        if (r < bound) out = vals[r];
      }
      dense[j] = out;
    }
  } else if (prefix < bound) {
    const T* flat = static_cast<const T*>(a.src);
    T* values = static_cast<T*>(a.dst);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if ((ballots[i] >> lane) & 1u) {
        const long long j = base + static_cast<long long>(i) * kThreads + t;
        const long long r = prefix + s_counts[i * kWarps + warp] + __popc(ballots[i] & below);
        if (r < bound) values[r] = flat[j];
      }
    }
  }
}

long long tiles_of(long long d) { return (d + kTile - 1) / kTile; }

template <bool kDecode>
int launch_rank(RankArgs a, int elem_bytes, void* scratch, cudaStream_t stream) {
  const long long tiles = tiles_of(a.d);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (tiles + 1), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.counter = static_cast<unsigned int*>(scratch);
  a.state = static_cast<unsigned long long*>(scratch) + 1;
  a.step_mod = kThreads % a.n_words;
  const dim3 grid(static_cast<unsigned int>(tiles));
  if (elem_bytes == 2) {
    bloom_rank_kernel<kDecode, uint16_t><<<grid, kThreads, 0, stream>>>(a);
  } else if (elem_bytes == 4) {
    bloom_rank_kernel<kDecode, uint32_t><<<grid, kThreads, 0, stream>>>(a);
  } else {
    bloom_rank_kernel<kDecode, unsigned long long><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid_geometry(int n_words, int h, long long d) {
  return n_words > 0 && h >= 1 && h <= 12 && d > 0 && tiles_of(d) < (1ll << 31) && d < (1ll << 32);
}

bool valid_size(int bytes) { return bytes == 2 || bytes == 4 || bytes == 8; }

}  // namespace

extern "C" {

// The universe indices a tile of the select and place kernels covers.
int bloom_mod_tile(void) { return kTile; }

// Bytes of scratch the select and place kernels take for a universe of d.
long long bloom_mod_scratch_bytes(long long d) {
  return static_cast<long long>(sizeof(unsigned long long)) * (tiles_of(d) + 1);
}

// words[n_words] (uint32) = the filter of the live indices[s], s < min(k,
// *nnz): a memset, then one launch on `stream`. index_bytes and nnz_bytes
// are 4 or 8. Returns cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for arguments it refuses. Does not synchronise.
int bloom_mod_insert(const void* indices, int index_bytes, long long k, const void* nnz, int nnz_bytes,
                     void* words, int n_words, int num_hash, void* stream) {
  if (n_words <= 0 || num_hash < 1 || num_hash > 12 || k < 0 || (index_bytes != 4 && index_bytes != 8) ||
      (nnz_bytes != 4 && nnz_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(words, 0, sizeof(uint32_t) * n_words, s);
  if (e != cudaSuccess || k == 0) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned int>((k + kThreads - 1) / kThreads));
  uint32_t* w = static_cast<uint32_t*>(words);
  if (index_bytes == 4) {
    bloom_insert_kernel<int><<<grid, kThreads, 0, s>>>(static_cast<const int*>(indices), k, nnz, nnz_bytes, w,
                                                        n_words, num_hash);
  } else {
    bloom_insert_kernel<long long><<<grid, kThreads, 0, s>>>(static_cast<const long long*>(indices), k, nnz,
                                                              nnz_bytes, w, n_words, num_hash);
  }
  return static_cast<int>(cudaGetLastError());
}

// values[budget] = flat at the first `budget` hits of the universe [0, d) in
// ascending order, zeros past them; *nsel = min(hits, budget). One memset of
// the values, one of the scratch (bloom_mod_scratch_bytes(d)), one launch.
int bloom_mod_select(const void* words, int n_words, int num_hash, long long d, long long budget,
                     const void* flat, int elem_bytes, void* values, void* nsel, void* scratch, void* stream) {
  if (!valid_geometry(n_words, num_hash, d) || budget < 0 || budget > d || !valid_size(elem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(values, 0, static_cast<size_t>(budget) * elem_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  RankArgs a{};
  a.words = static_cast<const uint32_t*>(words);
  a.d = d;
  a.n_words = n_words;
  a.h = num_hash;
  a.budget = budget;
  a.src = flat;
  a.dst = values;
  a.nsel_out = static_cast<int*>(nsel);
  return launch_rank<false>(a, elem_bytes, scratch, s);
}

// dense[d] = vals[r] at the hit of rank r < min(*nsel, budget, n_vals), 0
// elsewhere. nsel_bytes is 4 or 8. One memset of the scratch, one launch.
int bloom_mod_place(const void* words, int n_words, int num_hash, long long d, long long budget, const void* vals,
                    long long n_vals, int elem_bytes, const void* nsel, int nsel_bytes, void* dense, void* scratch,
                    void* stream) {
  if (!valid_geometry(n_words, num_hash, d) || budget < 0 || n_vals < 0 || !valid_size(elem_bytes) ||
      (nsel_bytes != 4 && nsel_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RankArgs a{};
  a.words = static_cast<const uint32_t*>(words);
  a.d = d;
  a.n_words = n_words;
  a.h = num_hash;
  a.budget = budget;
  a.src = vals;
  a.dst = dense;
  a.n_vals = n_vals;
  a.nsel_in = nsel;
  a.nsel_bytes = nsel_bytes;
  return launch_rank<true>(a, elem_bytes, scratch, static_cast<cudaStream_t>(stream));
}

const char* bloom_mod_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
