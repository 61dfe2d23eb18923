// Native host-path codec library — the TPU-framework equivalent of the
// reference's TensorFlow CPU custom ops (bloom_filter_compression.cc,
// integer_compression.cc, policies.hpp) and their vendored third_party
// bloomfilter/FastPFor layers. Built from scratch:
//
// - the bloom filter uses the same murmur3-finalizer hash mix as the JAX
//   codec (deepreduce_tpu/codecs/bloom.py::fmix32), so bitmaps built on
//   either side are byte-identical and cross-checkable;
// - the wire format mirrors the reference op's
//   [int32 m_bytes | int32 hash_num | K x int32 value-bits | m bytes]
//   layout (bloom_filter_compression.cc:112-141);
// - selection policies: leftmostK, randomK, policy_zero, conflict_sets
//   (P2 — native-only in the reference too, policies.hpp:43-194). The RNG
//   is an explicit splitmix64/xorshift so determinism does not depend on a
//   particular libstdc++ (the reference's std::uniform_int_distribution
//   is not cross-implementation stable);
// - the integer codec implements delta + frame-bit-packing in the exact
//   bit layout of deepreduce_tpu/codecs/packing.py (value i bit b at
//   stream position i*width+b, LSB-first within little-endian uint32
//   words), a VByte/varint variant, and PFor128 with patched exceptions —
//   the FastPFor delta/PFor/VByte family role, selectable by name through
//   drn_int_{en,de}code_named (CODECFactory::getFromName,
//   integer_compression.cc:62).
//
// Exposed as a plain C ABI for ctypes; see native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

extern "C" {

// ----------------------------------------------------------------------
// Hashing (matches codecs/bloom.py)

static inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

static const uint32_t kGolden = 0x9e3779b9u;

static inline uint32_t hash_pos(uint32_t idx, uint32_t j, uint32_t m_bits) {
  uint32_t seed = fmix32((j + 1u) * kGolden);
  return fmix32(idx ^ seed) % m_bits;
}

uint32_t drn_fmix32(uint32_t x) { return fmix32(x); }

// Deterministic RNG (splitmix64 -> xorshift-style stream)
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire-style rejection)
  uint64_t below(uint64_t n) {
    if (n == 0) return 0;
    uint64_t x, r;
    do {
      x = next();
      r = x % n;
    } while (x - r > UINT64_MAX - n + 1);
    return r;
  }
};

// ----------------------------------------------------------------------
// Bloom filter core

void drn_bloom_insert(const int32_t* indices, int32_t k, int32_t m_bits,
                      int32_t num_hash, uint8_t* bitmap /* m_bits/8 bytes */) {
  for (int32_t i = 0; i < k; ++i) {
    uint32_t idx = (uint32_t)indices[i];
    for (int32_t j = 0; j < num_hash; ++j) {
      uint32_t p = hash_pos(idx, (uint32_t)j, (uint32_t)m_bits);
      bitmap[p >> 3] |= (uint8_t)(1u << (p & 7u));
    }
  }
}

static inline bool bloom_query(const uint8_t* bitmap, uint32_t idx,
                               int32_t num_hash, uint32_t m_bits) {
  for (int32_t j = 0; j < num_hash; ++j) {
    uint32_t p = hash_pos(idx, (uint32_t)j, m_bits);
    if (!(bitmap[p >> 3] & (1u << (p & 7u)))) return false;
  }
  return true;
}

// out_mask: d bytes of 0/1. Returns the positive count.
int32_t drn_bloom_query_universe(const uint8_t* bitmap, int32_t m_bits,
                                 int32_t num_hash, int32_t d, uint8_t* out_mask) {
  int32_t count = 0;
  for (int32_t i = 0; i < d; ++i) {
    bool hit = bloom_query(bitmap, (uint32_t)i, num_hash, (uint32_t)m_bits);
    out_mask[i] = hit ? 1 : 0;
    count += hit;
  }
  return count;
}

// ----------------------------------------------------------------------
// Selection policies (policies.hpp role). All return selected count;
// selected indices are ascending (canonical order) except randomK/
// conflict_sets which sort at the end, like the reference's
// choose_indices_from_conflict_sets (policies.hpp:130-134).

int32_t drn_select_leftmost(const uint8_t* mask, int32_t d, int32_t k,
                            int32_t* out) {
  int32_t n = 0;
  for (int32_t i = 0; i < d && n < k; ++i)
    if (mask[i]) out[n++] = i;
  return n;
}

int32_t drn_select_p0(const uint8_t* mask, int32_t d, int32_t cap, int32_t* out) {
  int32_t n = 0;
  for (int32_t i = 0; i < d && n < cap; ++i)
    if (mask[i]) out[n++] = i;
  return n;
}

int32_t drn_select_random(const uint8_t* mask, int32_t d, int32_t k,
                          int64_t step, int32_t* out) {
  std::vector<int32_t> positives;
  for (int32_t i = 0; i < d; ++i)
    if (mask[i]) positives.push_back(i);
  Rng rng((uint64_t)step);
  int32_t n = (int32_t)std::min<size_t>((size_t)k, positives.size());
  // partial Fisher-Yates: first n slots become the sample
  for (int32_t i = 0; i < n; ++i) {
    size_t j = i + (size_t)rng.below(positives.size() - i);
    std::swap(positives[i], positives[j]);
  }
  std::sort(positives.begin(), positives.begin() + n);
  std::copy(positives.begin(), positives.begin() + n, out);
  return n;
}

// P2: conflict sets — group positives by shared hash buckets, smallest set
// first, round-robin one random member per set, dedup against chosen
// (policies.hpp:43-146 semantics).
int32_t drn_select_conflict_sets(const uint8_t* mask, int32_t d, int32_t k,
                                 int32_t m_bits, int32_t num_hash, int64_t step,
                                 int32_t* out) {
  std::map<uint32_t, std::vector<int32_t>> sets;
  for (int32_t i = 0; i < d; ++i) {
    if (!mask[i]) continue;
    for (int32_t j = 0; j < num_hash; ++j)
      sets[hash_pos((uint32_t)i, (uint32_t)j, (uint32_t)m_bits)].push_back(i);
  }
  std::vector<std::vector<int32_t>> ordered;
  ordered.reserve(sets.size());
  for (auto& kv : sets) ordered.push_back(std::move(kv.second));
  std::stable_sort(ordered.begin(), ordered.end(),
                   [](const std::vector<int32_t>& a, const std::vector<int32_t>& b) {
                     return a.size() < b.size();
                   });
  Rng rng((uint64_t)step);
  std::vector<int32_t> chosen;
  std::vector<uint8_t> taken(d, 0);
  int32_t left = k;
  bool progress = true;
  while (left > 0 && progress) {
    progress = false;
    for (auto& cset : ordered) {
      if (left <= 0) break;
      // drop members already chosen; a compromised set skips this round
      size_t before = cset.size();
      cset.erase(std::remove_if(cset.begin(), cset.end(),
                                [&](int32_t v) { return taken[v]; }),
                 cset.end());
      bool compromised = cset.size() != before;
      if (compromised || cset.empty()) continue;
      size_t pick = (size_t)rng.below(cset.size());
      int32_t v = cset[pick];
      cset.erase(cset.begin() + pick);
      taken[v] = 1;
      chosen.push_back(v);
      --left;
      progress = true;
    }
  }
  // top up from any remaining positives if round-robin stalled
  for (int32_t i = 0; i < d && left > 0; ++i) {
    if (mask[i] && !taken[i]) {
      taken[i] = 1;
      chosen.push_back(i);
      --left;
    }
  }
  std::sort(chosen.begin(), chosen.end());
  std::copy(chosen.begin(), chosen.end(), out);
  return (int32_t)chosen.size();
}

static int32_t select_by_policy(int32_t policy, const uint8_t* mask, int32_t d,
                                int32_t k, int32_t m_bits, int32_t num_hash,
                                int64_t step, int32_t* out, int32_t cap) {
  switch (policy) {
    case 0:  // leftmostK
      return drn_select_leftmost(mask, d, k < cap ? k : cap, out);
    case 1:  // randomK
      return drn_select_random(mask, d, k < cap ? k : cap, step, out);
    case 2:  // conflict_sets
      return drn_select_conflict_sets(mask, d, k < cap ? k : cap, m_bits,
                                      num_hash, step, out);
    case 3:  // policy_zero: all positives
      return drn_select_p0(mask, d, cap, out);
  }
  return -1;
}

// ----------------------------------------------------------------------
// Bloom wire codec: [int32 m_bytes | int32 num_hash | int32 nsel |
//                    nsel x float values | m_bytes bitmap]
// (reference layout bloom_filter_compression.cc:112-141, with an explicit
// in-band nsel so policy_zero's variable size is self-describing).

int32_t drn_bloom_compress(const float* dense, const int32_t* indices,
                           int32_t k, int32_t d, int32_t m_bits,
                           int32_t num_hash, int32_t policy, int64_t step,
                           int32_t select_cap, int8_t* out, int32_t capacity) {
  int32_t m_bytes = m_bits / 8;
  std::vector<uint8_t> bitmap(m_bytes, 0);
  drn_bloom_insert(indices, k, m_bits, num_hash, bitmap.data());
  std::vector<uint8_t> mask(d);
  drn_bloom_query_universe(bitmap.data(), m_bits, num_hash, d, mask.data());
  std::vector<int32_t> selected(select_cap);
  int32_t nsel = select_by_policy(policy, mask.data(), d, k, m_bits, num_hash,
                                  step, selected.data(), select_cap);
  if (nsel < 0) return -1;
  int32_t need = 12 + nsel * 4 + m_bytes;
  if (need > capacity) return -need;
  int8_t* p = out;
  std::memcpy(p, &m_bytes, 4); p += 4;
  std::memcpy(p, &num_hash, 4); p += 4;
  std::memcpy(p, &nsel, 4); p += 4;
  for (int32_t i = 0; i < nsel; ++i) {
    float v = dense[selected[i]];
    std::memcpy(p, &v, 4); p += 4;
  }
  std::memcpy(p, bitmap.data(), m_bytes);
  return need;
}

int32_t drn_bloom_decompress(const int8_t* payload, int32_t payload_len,
                             int32_t d, int32_t k, int32_t policy, int64_t step,
                             float* out_values, int32_t* out_indices,
                             int32_t cap) {
  if (payload_len < 12) return -1;
  int32_t m_bytes, num_hash, nsel;
  std::memcpy(&m_bytes, payload, 4);
  std::memcpy(&num_hash, payload + 4, 4);
  std::memcpy(&nsel, payload + 8, 4);
  const int8_t* vals = payload + 12;
  const uint8_t* bitmap = (const uint8_t*)(payload + 12 + nsel * 4);
  if (12 + nsel * 4 + m_bytes > payload_len) return -2;
  std::vector<uint8_t> mask(d);
  drn_bloom_query_universe(bitmap, m_bytes * 8, num_hash, d, mask.data());
  std::vector<int32_t> selected(cap);
  int32_t n = select_by_policy(policy, mask.data(), d, k, m_bytes * 8, num_hash,
                               step, selected.data(), cap);
  if (n != nsel) n = n < nsel ? n : nsel;  // truncation guard
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(&out_values[i], vals + i * 4, 4);
    out_indices[i] = selected[i];
  }
  return n;
}

// ----------------------------------------------------------------------
// Integer codec (FastPFor role): delta + frame bit packing, same bit
// layout as codecs/packing.py. Header: [uint32 n | uint32 width].

static inline void set_stream_bit(uint32_t* words, uint64_t pos) {
  words[pos >> 5] |= (1u << (pos & 31u));
}
static inline uint32_t get_stream_bit(const uint32_t* words, uint64_t pos) {
  return (words[pos >> 5] >> (pos & 31u)) & 1u;
}

int32_t drn_fbp_encode(const uint32_t* sorted_vals, int32_t n,
                       uint32_t* out_words, int32_t capacity_words) {
  uint32_t max_delta = 0;
  uint32_t prev = 0;
  for (int32_t i = 0; i < n; ++i) {
    uint32_t delta = sorted_vals[i] - prev;
    prev = sorted_vals[i];
    if (delta > max_delta) max_delta = delta;
  }
  uint32_t width = 1;
  while (width < 32 && (max_delta >> width)) ++width;
  int64_t body_words = ((int64_t)n * width + 31) / 32;
  if (2 + body_words > capacity_words) return -(int32_t)(2 + body_words);
  out_words[0] = (uint32_t)n;
  out_words[1] = width;
  std::memset(out_words + 2, 0, (size_t)body_words * 4);
  prev = 0;
  for (int32_t i = 0; i < n; ++i) {
    uint32_t delta = sorted_vals[i] - prev;
    prev = sorted_vals[i];
    uint64_t base = (uint64_t)i * width;
    for (uint32_t b = 0; b < width; ++b)
      if ((delta >> b) & 1u) set_stream_bit(out_words + 2, base + b);
  }
  return (int32_t)(2 + body_words);
}

int32_t drn_fbp_decode(const uint32_t* words, int32_t nwords, uint32_t* out,
                       int32_t cap) {
  if (nwords < 2) return -1;
  int32_t n = (int32_t)words[0];
  uint32_t width = words[1];
  if (n > cap || width == 0 || width > 32) return -2;
  uint32_t prev = 0;
  for (int32_t i = 0; i < n; ++i) {
    uint32_t delta = 0;
    uint64_t base = (uint64_t)i * width;
    for (uint32_t b = 0; b < width; ++b)
      delta |= get_stream_bit(words + 2, base + b) << b;
    prev += delta;
    out[i] = prev;
  }
  return n;
}

// VByte / varint variant (the FastPFor "VByte" family member)
int32_t drn_varint_encode(const uint32_t* sorted_vals, int32_t n, uint8_t* out,
                          int32_t capacity) {
  int32_t pos = 0;
  uint32_t prev = 0;
  for (int32_t i = 0; i < n; ++i) {
    uint32_t delta = sorted_vals[i] - prev;
    prev = sorted_vals[i];
    do {
      if (pos >= capacity) return -1;
      uint8_t byte = delta & 0x7f;
      delta >>= 7;
      out[pos++] = byte | (delta ? 0x80 : 0);
    } while (delta);
  }
  return pos;
}

int32_t drn_varint_decode(const uint8_t* data, int32_t len, uint32_t* out,
                          int32_t cap) {
  int32_t n = 0, pos = 0;
  uint32_t prev = 0;
  while (pos < len && n < cap) {
    uint32_t delta = 0, shift = 0;
    while (true) {
      if (pos >= len) return n;
      uint8_t byte = data[pos++];
      delta |= (uint32_t)(byte & 0x7f) << shift;
      if (!(byte & 0x80)) break;
      shift += 7;
    }
    prev += delta;
    out[n++] = prev;
  }
  return n;
}

// ----------------------------------------------------------------------
// PFor with patched exceptions (the FastPFor "PFor/NewPFD" family member,
// /root/reference/tensorflow/integer_compression.cc CODECFactory role):
// deltas in blocks of 128; per block an exact-cost-minimized base width b
// stores the low b bits in a frame, and values that overflow b become
// *patched exceptions* — their in-block positions (1 byte each, 4/word)
// plus their full 32-bit deltas appended after the frame.
//
// Wire: [u32 n | blocks...]; block = [u32 (b<<16|n_exc) | frame words |
// position words | exception words].

static const int32_t kPforBlock = 128;

int32_t drn_pfor_encode(const uint32_t* sorted_vals, int32_t n,
                        uint32_t* out_words, int32_t capacity_words) {
  int64_t pos = 1;  // out_words[0] = n
  if (capacity_words < 1) return -1;
  out_words[0] = (uint32_t)n;
  uint32_t prev = 0;
  for (int32_t start = 0; start < n; start += kPforBlock) {
    int32_t len = (n - start) < kPforBlock ? (n - start) : kPforBlock;
    uint32_t deltas[kPforBlock];
    for (int32_t i = 0; i < len; ++i) {
      uint32_t v = sorted_vals[start + i];
      deltas[i] = v - prev;
      prev = v;
    }
    // exact cost scan: frame bits + 8 bits/exception position + 32/value
    uint32_t best_b = 32;
    int64_t best_cost = (int64_t)len * 32;
    for (uint32_t b = 0; b <= 31; ++b) {
      int32_t n_exc = 0;
      for (int32_t i = 0; i < len; ++i)
        if (b == 0 ? deltas[i] != 0 : (deltas[i] >> b) != 0) ++n_exc;
      int64_t cost = (int64_t)len * b + (int64_t)n_exc * (8 + 32);
      if (cost < best_cost) {
        best_cost = cost;
        best_b = b;
      }
    }
    uint32_t b = best_b;
    uint8_t exc_pos[kPforBlock];
    uint32_t exc_val[kPforBlock];
    int32_t n_exc = 0;
    for (int32_t i = 0; i < len; ++i)
      if (b == 32 ? false : (b == 0 ? deltas[i] != 0 : (deltas[i] >> b) != 0)) {
        exc_pos[n_exc] = (uint8_t)i;
        exc_val[n_exc] = deltas[i];
        ++n_exc;
      }
    int64_t frame_words = ((int64_t)len * b + 31) / 32;
    int64_t pos_words = (n_exc + 3) / 4;
    int64_t need = 1 + frame_words + pos_words + n_exc;
    if (pos + need > capacity_words) return -(int32_t)(pos + need);
    out_words[pos] = (b << 16) | (uint32_t)n_exc;
    uint32_t* frame = out_words + pos + 1;
    std::memset(frame, 0, (size_t)frame_words * 4);
    if (b > 0 && b < 32) {
      uint32_t mask = (b == 32) ? 0xffffffffu : ((1u << b) - 1u);
      for (int32_t i = 0; i < len; ++i) {
        uint32_t low = deltas[i] & mask;
        uint64_t base = (uint64_t)i * b;
        for (uint32_t bit = 0; bit < b; ++bit)
          if ((low >> bit) & 1u) set_stream_bit(frame, base + bit);
      }
    } else if (b == 32) {
      for (int32_t i = 0; i < len; ++i) frame[i] = deltas[i];
    }
    uint32_t* pwords = frame + frame_words;
    std::memset(pwords, 0, (size_t)pos_words * 4);
    for (int32_t e = 0; e < n_exc; ++e)
      pwords[e >> 2] |= (uint32_t)exc_pos[e] << (8 * (e & 3));
    uint32_t* evals = pwords + pos_words;
    for (int32_t e = 0; e < n_exc; ++e) evals[e] = exc_val[e];
    pos += need;
  }
  return (int32_t)pos;
}

int32_t drn_pfor_decode(const uint32_t* words, int32_t nwords, uint32_t* out,
                        int32_t cap) {
  if (nwords < 1) return -1;
  int32_t n = (int32_t)words[0];
  if (n > cap) return -2;
  int64_t pos = 1;
  uint32_t prev = 0;
  for (int32_t start = 0; start < n; start += kPforBlock) {
    int32_t len = (n - start) < kPforBlock ? (n - start) : kPforBlock;
    if (pos >= nwords) return -3;
    uint32_t hdr = words[pos];
    uint32_t b = hdr >> 16;
    int32_t n_exc = (int32_t)(hdr & 0xffffu);
    if (b > 32 || n_exc > len) return -4;
    int64_t frame_words = ((int64_t)len * b + 31) / 32;
    int64_t pos_words = (n_exc + 3) / 4;
    if (pos + 1 + frame_words + pos_words + n_exc > nwords) return -5;
    const uint32_t* frame = words + pos + 1;
    uint32_t deltas[kPforBlock];
    if (b == 32) {
      for (int32_t i = 0; i < len; ++i) deltas[i] = frame[i];
    } else if (b == 0) {
      for (int32_t i = 0; i < len; ++i) deltas[i] = 0;
    } else {
      for (int32_t i = 0; i < len; ++i) {
        uint32_t v = 0;
        uint64_t base = (uint64_t)i * b;
        for (uint32_t bit = 0; bit < b; ++bit)
          v |= get_stream_bit(frame, base + bit) << bit;
        deltas[i] = v;
      }
    }
    const uint32_t* pwords = frame + frame_words;
    const uint32_t* evals = pwords + pos_words;
    for (int32_t e = 0; e < n_exc; ++e) {
      uint32_t p = (pwords[e >> 2] >> (8 * (e & 3))) & 0xffu;
      if ((int32_t)p < len) deltas[p] = evals[e];
    }
    for (int32_t i = 0; i < len; ++i) {
      prev += deltas[i];
      out[start + i] = prev;
    }
    pos += 1 + frame_words + pos_words + n_exc;
  }
  return n;
}

// ----------------------------------------------------------------------
// Name-keyed codec selection — the CODECFactory::getFromName role
// (/root/reference/tensorflow/integer_compression.cc:62): one entry point,
// member chosen by string. varint's byte stream rides in words behind a
// [u32 nbytes] header so every member shares the words-in/words-out shape.

static int32_t pfor_name_id(const char* name) {
  std::string s(name ? name : "");
  if (s == "fbp" || s == "fastbinarypacking32") return 0;
  if (s == "varint" || s == "vbyte") return 1;
  if (s == "pfor" || s == "pfor128" || s == "newpfd") return 2;
  return -1;
}

int32_t drn_int_encode_named(const char* name, const uint32_t* sorted_vals,
                             int32_t n, uint32_t* out_words,
                             int32_t capacity_words) {
  switch (pfor_name_id(name)) {
    case 0:
      return drn_fbp_encode(sorted_vals, n, out_words, capacity_words);
    case 1: {
      if (capacity_words < 1) return -1;
      int32_t nbytes = drn_varint_encode(
          sorted_vals, n, reinterpret_cast<uint8_t*>(out_words + 1),
          (capacity_words - 1) * 4);
      if (nbytes < 0) return nbytes;
      out_words[0] = (uint32_t)nbytes;
      return 1 + (nbytes + 3) / 4;
    }
    case 2:
      return drn_pfor_encode(sorted_vals, n, out_words, capacity_words);
    default:
      return -100;  // unknown codec name
  }
}

int32_t drn_int_decode_named(const char* name, const uint32_t* words,
                             int32_t nwords, uint32_t* out, int32_t cap) {
  switch (pfor_name_id(name)) {
    case 0:
      return drn_fbp_decode(words, nwords, out, cap);
    case 1: {
      if (nwords < 1) return -1;
      int32_t nbytes = (int32_t)words[0];
      if (nbytes > (nwords - 1) * 4) return -2;
      return drn_varint_decode(reinterpret_cast<const uint8_t*>(words + 1),
                               nbytes, out, cap);
    }
    case 2:
      return drn_pfor_decode(words, nwords, out, cap);
    default:
      return -100;
  }
}

}  // extern "C"
