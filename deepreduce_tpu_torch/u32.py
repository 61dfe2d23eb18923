"""Wrapping uint32 arithmetic on int64 tensors.

Torch's `uint32` dtype lacks `>>`, `%` and scatter on the CPU, so the plain
code keeps 32-bit words in int64 tensors holding values in [0, 2**32). A
32x32-bit product does not fit a signed int64, so multiplies are split
into 16-bit halves whose partial products stay below 2**49. The words these
helpers produce are bitwise equal to the JAX package's uint32 arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF


def mul_lo(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 `a` in [0, 2**32) and a constant b."""
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


def mul_hilo(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * b."""
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    p0 = a * b_lo
    p1 = a * b_hi
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & MASK32


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), int64 in and out."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def to_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensor with the same bit pattern
    (the uint32 wire form: 4 little-endian bytes each)."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_bits`."""
    return bits.to(torch.int64) & MASK32
