"""ctypes bindings for the port's copy of the C++ host codec library.

`csrc/deepreduce_native.cc` is a byte-for-byte copy of the JAX package's
`deepreduce_tpu/native/deepreduce_native.cc` (a test holds the two files
equal, so a fix on one side shows on the other). It is the role of the
reference's C++ TensorFlow ops (bloom_filter_compression.cc,
integer_compression.cc, policies.hpp): the classic bloom filter with the
same murmur3-finalizer hash mix as the on-device codec, its selection
policies leftmost, random, p0 and the exact P2 `conflict_sets`, the
`[m | h | count | values | bit-array]` wire codec, and the FastPFor-role
integer family fbp, varint and pfor behind name-keyed selection.

`ops.build` compiles it with g++ into `deepreduce_tpu_torch/_build/` at
first use (a hash of the source and the flags names the library) and it is
loaded here with ctypes: there is no Python fallback coder. The signatures
and the numpy-facing wrappers are those of `deepreduce_tpu/native/__init__.py`,
so the same inputs give the same bytes. The JAX package's second route,
XLA FFI custom calls (`native/xla_ops.py`), exists only because a jitted
XLA program cannot call ctypes; eager PyTorch can, so the port has this one
route.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from deepreduce_tpu_torch.ops import build

POLICY_IDS = {"leftmost": 0, "random": 1, "conflict_sets": 2, "p0": 3, "policy_zero": 3}

_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (if needed) and load the host library, with every function's
    argument and result types set (a ctypes call without them passes
    pointers as 32-bit ints)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.library("deepreduce_native")
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64, u32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32

    lib.drn_fmix32.restype = u32
    lib.drn_fmix32.argtypes = [u32]
    lib.drn_bloom_insert.restype = None
    lib.drn_bloom_insert.argtypes = [i32p, i32, i32, i32, u8p]
    lib.drn_bloom_query_universe.restype = i32
    lib.drn_bloom_query_universe.argtypes = [u8p, i32, i32, i32, u8p]
    lib.drn_select_leftmost.restype = i32
    lib.drn_select_leftmost.argtypes = [u8p, i32, i32, i32p]
    lib.drn_select_p0.restype = i32
    lib.drn_select_p0.argtypes = [u8p, i32, i32, i32p]
    lib.drn_select_random.restype = i32
    lib.drn_select_random.argtypes = [u8p, i32, i32, i64, i32p]
    lib.drn_select_conflict_sets.restype = i32
    lib.drn_select_conflict_sets.argtypes = [u8p, i32, i32, i32, i32, i64, i32p]
    lib.drn_bloom_compress.restype = i32
    lib.drn_bloom_compress.argtypes = [f32p, i32p, i32, i32, i32, i32, i32, i64, i32, i8p, i32]
    lib.drn_bloom_decompress.restype = i32
    lib.drn_bloom_decompress.argtypes = [i8p, i32, i32, i32, i32, i64, f32p, i32p, i32]
    lib.drn_fbp_encode.restype = i32
    lib.drn_fbp_encode.argtypes = [u32p, i32, u32p, i32]
    lib.drn_fbp_decode.restype = i32
    lib.drn_fbp_decode.argtypes = [u32p, i32, u32p, i32]
    lib.drn_varint_encode.restype = i32
    lib.drn_varint_encode.argtypes = [u32p, i32, u8p, i32]
    lib.drn_varint_decode.restype = i32
    lib.drn_varint_decode.argtypes = [u8p, i32, u32p, i32]
    lib.drn_pfor_encode.restype = i32
    lib.drn_pfor_encode.argtypes = [u32p, i32, u32p, i32]
    lib.drn_pfor_decode.restype = i32
    lib.drn_pfor_decode.argtypes = [u32p, i32, u32p, i32]
    lib.drn_int_encode_named.restype = i32
    lib.drn_int_encode_named.argtypes = [ctypes.c_char_p, u32p, i32, u32p, i32]
    lib.drn_int_decode_named.restype = i32
    lib.drn_int_decode_named.argtypes = [ctypes.c_char_p, u32p, i32, u32p, i32]
    _lib = lib
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------- numpy-facing wrappers ------------------------- #


def fmix32(x: int) -> int:
    return int(load().drn_fmix32(ctypes.c_uint32(x)))


def bloom_insert(indices: np.ndarray, m_bits: int, num_hash: int) -> np.ndarray:
    lib = load()
    idx = np.ascontiguousarray(indices, np.int32)
    bitmap = np.zeros(m_bits // 8, np.uint8)
    lib.drn_bloom_insert(_ptr(idx, ctypes.c_int32), len(idx), m_bits, num_hash,
                         _ptr(bitmap, ctypes.c_uint8))
    return bitmap


def bloom_query_universe(bitmap: np.ndarray, num_hash: int, d: int) -> np.ndarray:
    lib = load()
    bm = np.ascontiguousarray(bitmap, np.uint8)
    mask = np.zeros(d, np.uint8)
    lib.drn_bloom_query_universe(_ptr(bm, ctypes.c_uint8), len(bm) * 8, num_hash, d,
                                 _ptr(mask, ctypes.c_uint8))
    return mask


def select(policy: str, mask: np.ndarray, k: int, *, m_bits: int = 0,
           num_hash: int = 0, step: int = 0, cap: Optional[int] = None) -> np.ndarray:
    lib = load()
    mask = np.ascontiguousarray(mask, np.uint8)
    d = len(mask)
    cap = cap or max(k, int(mask.sum()))
    out = np.zeros(cap, np.int32)
    pid = POLICY_IDS[policy]
    if pid == 0:
        n = lib.drn_select_leftmost(_ptr(mask, ctypes.c_uint8), d, min(k, cap),
                                    _ptr(out, ctypes.c_int32))
    elif pid == 1:
        n = lib.drn_select_random(_ptr(mask, ctypes.c_uint8), d, min(k, cap),
                                  step, _ptr(out, ctypes.c_int32))
    elif pid == 2:
        n = lib.drn_select_conflict_sets(_ptr(mask, ctypes.c_uint8), d, min(k, cap),
                                         m_bits, num_hash, step, _ptr(out, ctypes.c_int32))
    else:
        n = lib.drn_select_p0(_ptr(mask, ctypes.c_uint8), d, cap, _ptr(out, ctypes.c_int32))
    return out[:n]


def bloom_compress(dense: np.ndarray, indices: np.ndarray, m_bits: int,
                   num_hash: int, policy: str, step: int, select_cap: int) -> np.ndarray:
    lib = load()
    dense = np.ascontiguousarray(dense, np.float32).reshape(-1)
    idx = np.ascontiguousarray(indices, np.int32)
    cap = 12 + select_cap * 4 + m_bits // 8
    out = np.zeros(cap, np.int8)
    n = lib.drn_bloom_compress(_ptr(dense, ctypes.c_float), _ptr(idx, ctypes.c_int32),
                               len(idx), dense.size, m_bits, num_hash,
                               POLICY_IDS[policy], step, select_cap,
                               _ptr(out, ctypes.c_int8), cap)
    if n < 0:
        raise ValueError(f"bloom_compress needs {-n} bytes, capacity {cap}")
    return out[:n]


def bloom_decompress(payload: np.ndarray, d: int, k: int, policy: str,
                     step: int, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = load()
    payload = np.ascontiguousarray(payload, np.int8)
    vals = np.zeros(cap, np.float32)
    idxs = np.zeros(cap, np.int32)
    n = lib.drn_bloom_decompress(_ptr(payload, ctypes.c_int8), len(payload), d, k,
                                 POLICY_IDS[policy], step,
                                 _ptr(vals, ctypes.c_float), _ptr(idxs, ctypes.c_int32), cap)
    if n < 0:
        raise ValueError(f"bloom_decompress error {n}")
    return vals[:n], idxs[:n]


def fbp_encode(sorted_vals: np.ndarray) -> np.ndarray:
    lib = load()
    v = np.ascontiguousarray(sorted_vals, np.uint32)
    cap = 2 + len(v) + 1
    out = np.zeros(cap, np.uint32)
    n = lib.drn_fbp_encode(_ptr(v, ctypes.c_uint32), len(v), _ptr(out, ctypes.c_uint32), cap)
    if n < 0:
        raise ValueError("fbp_encode capacity")
    return out[:n]


def fbp_decode(words: np.ndarray, n_max: int) -> np.ndarray:
    lib = load()
    w = np.ascontiguousarray(words, np.uint32)
    out = np.zeros(n_max, np.uint32)
    n = lib.drn_fbp_decode(_ptr(w, ctypes.c_uint32), len(w), _ptr(out, ctypes.c_uint32), n_max)
    if n < 0:
        raise ValueError(f"fbp_decode error {n}")
    return out[:n]


def varint_encode(sorted_vals: np.ndarray) -> np.ndarray:
    lib = load()
    v = np.ascontiguousarray(sorted_vals, np.uint32)
    cap = 5 * len(v) + 8
    out = np.zeros(cap, np.uint8)
    n = lib.drn_varint_encode(_ptr(v, ctypes.c_uint32), len(v), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError("varint_encode capacity")
    return out[:n]


def varint_decode(data: np.ndarray, n_max: int) -> np.ndarray:
    lib = load()
    b = np.ascontiguousarray(data, np.uint8)
    out = np.zeros(n_max, np.uint32)
    n = lib.drn_varint_decode(_ptr(b, ctypes.c_uint8), len(b), _ptr(out, ctypes.c_uint32), n_max)
    return out[:n]


def pfor_encode(sorted_vals: np.ndarray) -> np.ndarray:
    """PFor128 with patched exceptions over the sorted values' deltas."""
    lib = load()
    v = np.ascontiguousarray(sorted_vals, np.uint32)
    # worst case: every block falls back to b=32 (header + full words)
    cap = 1 + len(v) + 2 * ((len(v) + 127) // 128) + 8
    out = np.zeros(cap, np.uint32)
    n = lib.drn_pfor_encode(_ptr(v, ctypes.c_uint32), len(v), _ptr(out, ctypes.c_uint32), cap)
    if n < 0:
        raise ValueError(f"pfor_encode capacity {n}")
    return out[:n]


def pfor_decode(words: np.ndarray, n_max: int) -> np.ndarray:
    lib = load()
    w = np.ascontiguousarray(words, np.uint32)
    out = np.zeros(n_max, np.uint32)
    n = lib.drn_pfor_decode(_ptr(w, ctypes.c_uint32), len(w), _ptr(out, ctypes.c_uint32), n_max)
    if n < 0:
        raise ValueError(f"pfor_decode error {n}")
    return out[:n]


INT_CODEC_NAMES = ("fbp", "varint", "pfor")


def int_cap_words(k: int) -> int:
    """Family-wide worst-case wire size in words for k values: every pfor
    block at base width 32 (header + full words) / 5-byte varints, plus
    headers. The single sizing formula for every encode entry point."""
    return 2 * k + 2 * ((k + 127) // 128) + 16


def int_codec_from_name(name: str):
    """(encode, decode) for a named integer-codec family member — the
    CODECFactory::getFromName role (the reference's tensorflow/
    integer_compression.cc:62,161). Every member shares the words-in /
    words-out shape; unknown names raise like the factory does."""
    lib = load()
    cname = name.encode()
    if lib.drn_int_encode_named(cname, None, 0, None, 0) == -100:
        raise KeyError(f"unknown integer codec {name!r}; have {INT_CODEC_NAMES}")

    def enc(sorted_vals: np.ndarray) -> np.ndarray:
        v = np.ascontiguousarray(sorted_vals, np.uint32)
        cap = int_cap_words(len(v))
        out = np.zeros(cap, np.uint32)
        n = lib.drn_int_encode_named(
            cname, _ptr(v, ctypes.c_uint32), len(v), _ptr(out, ctypes.c_uint32), cap
        )
        if n < 0:
            raise ValueError(f"{name} encode error {n}")
        return out[:n]

    def dec(words: np.ndarray, n_max: int) -> np.ndarray:
        w = np.ascontiguousarray(words, np.uint32)
        out = np.zeros(max(1, n_max), np.uint32)
        n = lib.drn_int_decode_named(
            cname, _ptr(w, ctypes.c_uint32), len(w), _ptr(out, ctypes.c_uint32), n_max
        )
        if n < 0:
            raise ValueError(f"{name} decode error {n}")
        return out[:n]

    return enc, dec
