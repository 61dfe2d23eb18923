"""Frozen plain arithmetic the codec references share: top-k slots, the
mod-blocked bloom filter (geometry, lanes, insert, universe query), the p0
prefix policy, QSGD's bucketed stochastic quantizer and its Philox-4x32-10
draws keyed by (seed, tensor name, step, worker).

Written after the port's specification (`sparse.num_slots`,
`codecs/bloom.py`, `codecs/qsgd.py`, `ops/qsgd_kernel.py`) and imports
nothing of it. Every function is a straight loop-free formula over whole
tensors; nothing here is tuned for speed.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_LN2 = 0.6931471805599453
_SEED_LANE1 = 0x6A09E667
_SEED_LANE2 = 0xBB67AE85
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def num_slots(d: int, ratio: float) -> int:
    """k = max(1, int(d * ratio))."""
    return max(1, int(d * ratio))


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """bool[d]: the k largest |x|, ties to the lower index."""
    flat = x.reshape(-1)
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return torch.zeros(flat.shape[0], dtype=torch.bool, device=x.device).index_fill_(0, order, True)


# -- wrapping uint32 arithmetic in int64 ------------------------------------ #

def _mul_lo(a: torch.Tensor, b: int) -> torch.Tensor:
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def _mul_hilo(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    p0, p1 = a * b_lo, a * b_hi
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer over int64 words in [0, 2**32)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul_lo(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_lo(x, 0xC2B2AE35)
    return x ^ (x >> 16)


# -- the mod-blocked bloom filter ------------------------------------------- #

def _classic_bits(k: int, fpr: float) -> int:
    m_bytes = int(math.ceil(k * abs(math.log(fpr)) / (_LN2 * _LN2) / 8.0))
    return max(8, (m_bytes + 7) // 8 * 8) * 8


def _blocked_fpr(k: int, n_words: int, h: int) -> float:
    """The false-positive rate of a filter of 32-bit words: the Poisson
    mixture over the number of indices a word holds."""
    lam = k / n_words
    total, pj = 0.0, math.exp(-lam)
    for j in range(64):
        total += pj * ((32.0 * (1.0 - (1.0 - 1.0 / 32.0) ** (j * h))) / 32.0) ** h
        pj *= lam / (j + 1)
        if pj < 1e-12 and j > lam:
            break
    return total


def bloom_geometry(k: int, d: int, fpr: float, policy: str) -> Tuple[int, int, int]:
    """(words, hashes, slot budget) of the mod-blocked filter: the fewest
    words (grown by 1.3x from the classic filter's bits) and hashes that
    meet `fpr`, the word count made odd. The budget is k under `leftmost`;
    under `p0` it is k plus 1.05 times the expected false positives, plus
    64."""
    if policy not in ("leftmost", "p0"):
        raise NotImplementedError(f"the reference has no bloom policy {policy!r}")
    n_words, best = max(1, _classic_bits(k, fpr) // 32), None
    for _ in range(16):
        for h in range(1, 13):
            if _blocked_fpr(k, n_words, h) <= fpr:
                best = (n_words, h)
                break
        if best:
            break
        n_words = int(n_words * 1.3) + 1
    n_words, h = best or (n_words, 12)
    budget = min(d, int(math.ceil(k + 1.05 * fpr * (d - k))) + 64) if policy == "p0" else k
    return n_words | 1, h, budget


def lane_masks(j: torch.Tensor, h: int) -> torch.Tensor:
    """int64 32-bit mask of each index: h lanes from 5-bit fields of one
    murmur-mixed word (two above six hashes)."""
    idx = j & MASK32
    r1 = fmix32(idx ^ _SEED_LANE1)
    r2 = fmix32(idx ^ _SEED_LANE2) if h > 6 else None
    mask = torch.zeros_like(idx)
    for i in range(h):
        lane = ((r1 if i < 6 else r2) >> (5 * (i % 6))) & 31
        mask = mask | (torch.ones_like(lane) << lane)
    return mask


def bloom_positives(selected: torch.Tensor, n_words: int, h: int) -> torch.Tensor:
    """bool[d]: the universe indices the filter of the `selected` indices
    (bool[d]) answers yes for. Index j lives in word j mod W."""
    d = selected.shape[0]
    j = torch.arange(d, dtype=torch.int64, device=selected.device)
    masks = lane_masks(j, h)
    sel = torch.nonzero(selected).flatten()
    # OR as a sum of distinct bits: one (word, lane) bit set once
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=selected.device)
    for lane in range(32):
        hit = sel[((masks[sel] >> lane) & 1) == 1]
        bits.index_fill_(0, (hit % n_words) * 32 + lane, 1)
    words = (bits.view(n_words, 32) << torch.arange(32, device=selected.device)).sum(dim=1)
    return (words[j % n_words] & masks) == masks


def first_positions(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """int64 positions of the first `budget` True entries, ascending."""
    return torch.nonzero(mask).flatten()[:budget]


# -- QSGD -------------------------------------------------------------------- #

def stable_name_hash(name: str) -> int:
    h = 0x9747B28C
    for b in name.encode("utf-8"):
        h = (h ^ b) & MASK32
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & MASK32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & MASK32
        h ^= h >> 16
    return h


def stream(seed: int, name: str, step: int, worker: int) -> Tuple[int, int]:
    """The Philox (key, counter's upper half) of one tensor's draws."""
    return (int(seed) & MASK32) | (stable_name_hash(name) << 32), (int(worker) & MASK32) | ((int(step) & MASK32) << 32)


def philox_uniforms(n: int, key: int, offset: int, device) -> torch.Tensor:
    """f32[n] on [0, 1): element i is word i % 4 of Philox-4x32-10 at counter
    (i // 4, offset) under `key`, as (bits >> 8) * 2**-24."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = g & MASK32, g >> 32
    c2, c3 = torch.full_like(g, offset & MASK32), torch.full_like(g, (offset >> 32) & MASK32)
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mul_hilo(c0, PHILOX_M0)
        hi1, lo1 = _mul_hilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    bits = torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def qsgd_roundtrip(values: torch.Tensor, q: int, bucket: int, uniforms: torch.Tensor) -> torch.Tensor:
    """What the receiver reads back of f32 `values` quantized in buckets:
    norm = the bucket's L2 norm (summed in float64, rounded to float32),
    level = floor(|v| q / norm) + [u < frac], saturated to int8 with v's
    sign, and the value level * (norm * fl(1/q))."""
    n = values.shape[0]
    b = -(-n // bucket)
    padded = torch.zeros(b * bucket, dtype=torch.float32, device=values.device)
    padded[:n] = values
    norms = padded.view(b, bucket).double().square().sum(dim=1).sqrt().float()
    scale = torch.full_like(norms, float(q)) / torch.where(norms > 0, norms, torch.ones_like(norms))
    mag = padded.abs() * scale.repeat_interleave(bucket)
    lo = torch.floor(mag)
    level = torch.clamp((lo + (uniforms < mag - lo).float()) * torch.sign(padded), -128.0, 127.0)
    inv_q = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(q), dtype=torch.float32))
    return (level * (norms * inv_q).repeat_interleave(bucket))[:n]
