"""Canonical Huffman index codec (host path, lossless, order-preserving),
ported from `deepreduce_tpu/codecs/huffman.py`.

The int32 byte stream of the indices is Huffman-coded with a codec rebuilt
on both sides from the byte stream of `arange(d)` (the reference's
pytorch/deepreduce.py:770-802): no tree is transmitted. The canonical code
is built once per d and cached. Encode and decode are the JAX package's
vectorised numpy on the host (`codecs.host`): the payload is the
static budget of 8k + 16 bytes with the stream's bit length in band, and
its bytes are the JAX codec's.
"""

from __future__ import annotations

import dataclasses
import heapq
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.codecs import host
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class HuffmanMeta:
    k: int
    d: int

    @property
    def budget_bytes(self) -> int:
        # the int32 stream is 4k bytes; the arange-universe code is near
        # uniform (longest code ~9 bits), so 2x is ample
        return 8 * self.k + 16


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code length per byte symbol (0 for absent symbols)."""
    heap = [(int(f), s, s) for s, f in enumerate(freqs) if f > 0]
    if len(heap) == 1:
        lengths = np.zeros(256, np.int64)
        lengths[heap[0][1]] = 1
        return lengths
    heapq.heapify(heap)
    parent: dict = {}
    nxt = 256
    while len(heap) > 1:
        f1, t1, n1 = heapq.heappop(heap)
        f2, t2, n2 = heapq.heappop(heap)
        parent[n1] = nxt
        parent[n2] = nxt
        heapq.heappush(heap, (f1 + f2, min(t1, t2), nxt))
        nxt += 1
    lengths = np.zeros(256, np.int64)
    for s in range(256):
        if freqs[s] > 0:
            depth, node = 0, s
            while node in parent:
                node = parent[node]
                depth += 1
            lengths[s] = depth
    return lengths


@lru_cache(maxsize=64)
def _universe_codec(d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lengths[256], codes[256], decode_order) from the byte frequencies of
    the int32 stream of arange(d) — identical on every worker
    (pytorch/deepreduce.py:778-781)."""
    universe = np.arange(d, dtype="<i4").tobytes()
    freqs = np.bincount(np.frombuffer(universe, np.uint8), minlength=256)
    lengths = _code_lengths(freqs)
    # canonical assignment: sort by (length, symbol)
    order = np.lexsort((np.arange(256), np.where(lengths > 0, lengths, 999)))
    codes = np.zeros(256, np.uint64)
    code = 0
    prev_len = 0
    for s in order:
        length = lengths[s]
        if length == 0:
            continue
        code <<= int(length - prev_len)
        codes[s] = code
        code += 1
        prev_len = length
    return lengths, codes, order


def _encode_host(idx_bytes: np.ndarray, d: int, budget: int) -> Tuple[np.ndarray, np.ndarray]:
    lengths, codes, _ = _universe_codec(d)
    lens = lengths[idx_bytes]
    total = int(lens.sum())
    if (total + 7) // 8 > budget:
        raise ValueError("huffman payload exceeds static budget")
    max_len = int(lens.max()) if lens.size else 1
    # MSB-first bits of each code in a [n, max_len] lane grid; symbol i's
    # valid bits are the last `lens[i]` lanes (lane m holds bit
    # (code >> (max_len-1-m)) & 1, so the MSB sits at lane max_len-lens[i])
    shifts = np.arange(max_len - 1, -1, -1, dtype=np.uint64)
    bits_mat = (codes[idx_bytes][:, None] >> shifts[None, :]) & 1
    lane = np.arange(max_len)[None, :]
    valid = lane >= (max_len - lens[:, None])
    flat_bits = bits_mat[valid].astype(np.uint8)
    stream = np.packbits(flat_bits)
    out = np.zeros(budget, np.uint8)
    out[: stream.size] = stream
    return out, np.int32(total)


@lru_cache(maxsize=64)
def _decode_lut(d: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(symbol[2^L], length[2^L], L): every L-bit window resolves its first
    codeword in one lookup — L = max code length, ~9 bits for the
    arange-universe codec, so the table is tiny."""
    lengths, codes, _ = _universe_codec(d)
    max_len = int(lengths.max())
    lut_sym = np.zeros(1 << max_len, np.uint8)
    lut_len = np.ones(1 << max_len, np.int64)
    for s in range(256):
        length = int(lengths[s])
        if length == 0:
            continue
        lo = int(codes[s]) << (max_len - length)
        hi = (int(codes[s]) + 1) << (max_len - length)
        lut_sym[lo:hi] = s
        lut_len[lo:hi] = length
    return lut_sym, lut_len, max_len


def _decode_host(stream: np.ndarray, nbits: int, n_syms: int, d: int) -> np.ndarray:
    """LUT decode, fully vectorized via binary lifting (the round-2 version
    walked the canonical tables bit by bit in Python; round 3's first cut
    kept a per-symbol Python loop — still ~1.6M iterations at ResNet-50
    scale). Every bit position's successor is `pos + codeword_length(pos)`;
    decoding is the orbit of position 0 under that successor map. Doubling
    the known prefix of the orbit log2(n_syms) times extracts all symbol
    boundaries with O(n log n) numpy gathers and no Python-per-symbol work."""
    if n_syms == 0:
        return np.zeros(0, np.uint8)
    lut_sym, lut_len, max_len = _decode_lut(d)
    bits = np.unpackbits(stream)[:nbits]
    padded = np.concatenate([bits, np.zeros(max_len, np.uint8)])
    # window ints by max_len shifted adds — O(nbits) memory (a 2D
    # sliding-window matrix would transiently be ~max_len*8 bytes/bit)
    n = max(nbits, 1)
    windows = np.zeros(n, np.int32)
    for i in range(max_len):
        windows += padded[i : i + n].astype(np.int32) << (max_len - 1 - i)
    # successor map over bit positions; orbit positions past nbits park on a
    # self-loop sentinel slot n so doubling never reads out of range
    nxt = np.full(n + 1, n, np.int64)
    nxt[:n] = np.minimum(np.arange(n, dtype=np.int64) + lut_len[windows], n)
    # orbit-prefix doubling: `orbit` holds positions after 0..len-1 symbols;
    # jump[p] = position `len` symbols after p, squared each round
    orbit = np.zeros(1, np.int64)
    jump = nxt
    while orbit.size < n_syms:
        orbit = np.concatenate([orbit, jump[orbit]])
        if orbit.size < n_syms:
            jump = jump[jump]
    orbit = orbit[:n_syms]
    # a start position landing on the sentinel means the stream ran out
    # before all symbols decoded (truncated/corrupt payload, or the sides
    # disagree on d) — fail loudly like the per-symbol loop's IndexError did
    if int(orbit[-1]) >= n:
        raise ValueError("huffman stream exhausted before all symbols decoded")
    return lut_sym[windows[orbit]]


@dataclasses.dataclass(frozen=True)
class HuffmanPayload:
    values: torch.Tensor  # f32[k], untouched (order-preserving); f32[0] in 'both' mode
    stream: torch.Tensor  # uint8[budget_bytes]
    nbits: torch.Tensor  # i32[]: the stream's live bits
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.values, self.stream, self.nbits, self.nnz)


def encode(sp: SparseGrad, meta: HuffmanMeta) -> HuffmanPayload:
    dev = sp.values.device
    with host.span("huffman.encode"):
        idx = host.to_host(sp.indices)
        raw = np.frombuffer(np.ascontiguousarray(idx.astype("<i4")).tobytes(), np.uint8)
        stream, nbits = _encode_host(raw, meta.d, meta.budget_bytes)
    return HuffmanPayload(values=sp.values, stream=host.to_device(stream, dev), nbits=host.scalar(nbits, dev),
                          nnz=sp.nnz)


def decode(payload: HuffmanPayload, meta: HuffmanMeta, shape: Tuple[int, ...],
           host_payload: Optional[HuffmanPayload] = None) -> SparseGrad:
    """`host_payload`: the same payload's leaves on the host, if the caller
    has copied them already."""
    dev = payload.stream.device
    with host.span("huffman.decode"):
        src = payload if host_payload is None else host_payload
        stream, nbits = host.to_host(src.stream), host.to_host(src.nbits)
        raw = _decode_host(stream, int(nbits), 4 * meta.k, meta.d)
        idx = np.frombuffer(raw.tobytes(), "<i4").astype(np.int32)
    return SparseGrad(values=payload.values, indices=host.to_device(idx, dev), nnz=payload.nnz, shape=shape)


def wire_bits(payload: HuffmanPayload, meta: HuffmanMeta) -> torch.Tensor:
    return payload.nbits.to(torch.float32) + 64
