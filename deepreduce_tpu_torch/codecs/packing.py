"""Bit-packing at a data-dependent width into a static word budget, ported
from `deepreduce_tpu/codecs/packing.py`.

The caller fixes the word budget (the worst case, `budget_words(n,
max_width)`); the packed stream carries `(words, count, width)` and the
padding words are zero. Value i's bit b (LSB first) lands at stream bit
`i * width + b`, and stream bit p lives in word `p // 32` at bit `p % 32`,
as in the JAX package, so the words are bitwise equal to its uint32 words.

uint32 arithmetic runs in int64 (`u32`): a left shift keeps the bits that
uint32 drops, so it is masked back to 32 bits, and a spill into the word
past the budget is dropped, like JAX's `mode="drop"`. The bit ranges of
different values are disjoint, so `index_add_` is an OR.
Words travel as int32 tensors holding the uint32 bit pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deepreduce_tpu_torch import u32


@dataclasses.dataclass(frozen=True)
class PackedInts:
    words: torch.Tensor  # int32[budget_words] — uint32 words as bit patterns
    count: torch.Tensor  # i32[] — number of packed values
    width: torch.Tensor  # i32[] — bits per value (1..32)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.words, self.count, self.width)


def bits_needed(max_val: torch.Tensor) -> torch.Tensor:
    """i32[]: ceil(log2(max_val + 1)), at least 1, in integer arithmetic
    (a float log2 is off by one near powers of two). `max_val` holds a
    value in [0, 2**32)."""
    v = max_val.to(torch.int64) & u32.MASK32
    powers = torch.ones(31, dtype=torch.int64, device=v.device) << torch.arange(1, 32, device=v.device)
    return (1 + (v >= powers).sum()).to(torch.int32)


def budget_words(n: int, max_width: int = 32) -> int:
    """Static word budget for packing `n` values at up to `max_width` bits."""
    return (n * max_width + 31) // 32


def _width_mask(width: torch.Tensor) -> torch.Tensor:
    """int64 (1 << width) - 1, which is 0xFFFFFFFF at width 32."""
    w = width.to(torch.int64)
    return (torch.ones_like(w) << w) - 1


def pack(values: torch.Tensor, width: torch.Tensor, *, max_width: int = 32) -> PackedInts:
    """Pack the low `width` bits of each value (int64 in [0, 2**32), or any
    integer tensor read as uint32) into `budget_words(n, max_width)` 32-bit
    words; `width` must not exceed `max_width`. Value i spans stream bits
    [i*width, (i+1)*width): the low part lands in word w0 = p0 >> 5 and what
    spills past bit 31 in word w0 + 1."""
    n = values.shape[0]
    dev = values.device
    nw = budget_words(n, max_width)
    width = width.to(torch.int32)
    v = (values.to(torch.int64) & u32.MASK32) & _width_mask(width)
    p0 = torch.arange(n, dtype=torch.int64, device=dev) * width.to(torch.int64)
    w0 = p0 >> 5
    off = p0 & 31
    lo = (v << off) & u32.MASK32
    hi = torch.where(off == 0, 0, v >> (32 - off))
    # the last value's spill word can lie one past the budget (its bits are
    # then zero): a spare slot takes it
    words = torch.zeros(nw + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, torch.clamp(w0, max=nw), lo)
    words.index_add_(0, torch.clamp(w0 + 1, max=nw), hi)
    return PackedInts(
        words=u32.to_bits(words[:nw]),
        count=torch.full((), n, dtype=torch.int32, device=dev),
        width=width,
    )


def unpack(packed: PackedInts, n: int) -> torch.Tensor:
    """int64[n]: the inverse of `pack`; `n` is the static value count, and
    values at or past `packed.count` read 0."""
    words = u32.from_bits(packed.words)
    dev = words.device
    last = words.shape[0] - 1
    p0 = torch.arange(n, dtype=torch.int64, device=dev) * packed.width.to(torch.int64)
    w0 = torch.clamp(p0 >> 5, 0, last)
    off = p0 & 31
    lo = words[w0] >> off
    hi = torch.where(off == 0, 0, (words[torch.clamp(w0 + 1, 0, last)] << (32 - off)) & u32.MASK32)
    vals = (lo | hi) & _width_mask(packed.width)
    live = torch.arange(n, device=dev) < packed.count
    return torch.where(live, vals, 0)


def wire_bits(packed: PackedInts) -> torch.Tensor:
    """Meaningful bits on the wire: a 40-bit header (count word and width
    byte) plus count * width."""
    return 40 + packed.count.to(torch.int64) * packed.width.to(torch.int64)
