"""The resilience subsystem's counter-based draws.

A draw is a function of its key and its position alone: the key chains the
murmur3 `fmix32` finalizer over (seed, tag, salt, step, worker) on the
host, and position i's 32-bit word is `fmix32(fmix32(i * golden ^ key))`.
The same key gives the same draws on the CPU and on the card, with no
generator state to carry and no host sync: a scalar event's word is
computed on the host from host integers, a per-byte stream's words on the
tensor's device. The draws are not `jax.random`'s (the JAX package's
chaos and dropout streams cannot be reproduced in torch); the contract
with them is the distribution, and the parity tests inject JAX's events.
"""

from __future__ import annotations

import math

import torch

from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.codecs.bloom import fmix32

_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _fmix32_int(x: int) -> int:
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def key(*words: int) -> int:
    """The 32-bit key of a stream: `fmix32` chained over the words."""
    h = 0x9747B28C
    for w in words:
        h = _fmix32_int(h ^ (int(w) & _MASK32))
    return h


def word(k: int, i: int = 0) -> int:
    """Position i's 32-bit word of stream `k`, on the host."""
    return _fmix32_int(_fmix32_int(((i * _GOLDEN) & _MASK32) ^ k))


def words(k: int, n: int, device) -> torch.Tensor:
    """Positions 0..n-1's 32-bit words of stream `k`: int64 [n] on `device`,
    the same values `word` gives."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return fmix32(fmix32(u32.mul_lo(i, _GOLDEN) ^ k))


def fmix32_chain(h, word):
    """One link of `key`'s chain, `fmix32(h ^ word)`, where `h` or `word`
    (or both) may be int64 tensors: a key whose last words vary over a
    tensor (one worker a row) is made on the device."""
    if torch.is_tensor(h) or torch.is_tensor(word):
        return fmix32((h ^ word) & _MASK32)
    return _fmix32_int(h ^ (int(word) & _MASK32))


def words_at_keys(k: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of the streams `k` (an int64 tensor of keys) at
    `positions`, broadcast against each other: `words_at` with a key a row."""
    return fmix32(fmix32(u32.mul_lo(positions, _GOLDEN) ^ k))


def words_at(k: int, positions: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of stream `k` at the int64 `positions` (any shape),
    on their device: `words` at arbitrary positions."""
    return fmix32(fmix32(u32.mul_lo(positions, _GOLDEN) ^ k))


def to_uniform(w: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from 32-bit words: the top 24 bits, exact."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniforms(k: int, n: int, device) -> torch.Tensor:
    """f32[n] uniforms in [0, 1) at positions 0..n-1 of stream `k`."""
    return to_uniform(words(k, n, device))


def normals(k: int, positions: torch.Tensor) -> torch.Tensor:
    """float32 standard normals at the int64 `positions` of stream `k`
    (Box-Muller over the words at 2p and 2p + 1), on their device."""
    u1 = to_uniform(words_at(k, 2 * positions))
    u2 = to_uniform(words_at(k, 2 * positions + 1))
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def threshold(p: float) -> int:
    """A word below this is a success of a Bernoulli(p) draw."""
    return int(round(float(p) * (1 << 32)))


def bernoulli(k: int, p: float, i: int = 0) -> bool:
    """One Bernoulli(p) draw at position i of stream `k`, on the host."""
    return word(k, i) < threshold(p)
