"""Bytes-on-wire accounting: per-tensor `WireStats` and their sum."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class WireStats:
    """Per-tensor per-step wire accounting in bits (0-d float32 tensors)."""

    index_bits: torch.Tensor
    value_bits: torch.Tensor
    dense_bits: torch.Tensor
    # number of payloads whose selection filled every budget slot
    saturated: torch.Tensor

    @property
    def total_bits(self) -> torch.Tensor:
        return self.index_bits + self.value_bits

    def rel_volume(self) -> torch.Tensor:
        return self.total_bits / self.dense_bits

    def idx_rel_volume(self) -> torch.Tensor:
        return self.index_bits / self.dense_bits

    def val_rel_volume(self) -> torch.Tensor:
        return self.value_bits / self.dense_bits

    @classmethod
    def constant(cls, index_bits: float, value_bits: float, dense_bits: float, device) -> "WireStats":
        """Stats fixed by the shapes alone (no saturation), as 0-d float32
        tensors on `device`, filled without a host copy."""
        full = lambda x: torch.full((), float(x), dtype=torch.float32, device=device)
        return cls(index_bits=full(index_bits), value_bits=full(value_bits), dense_bits=full(dense_bits),
                   saturated=full(0.0))


def combine(stats: Dict[str, WireStats]) -> WireStats:
    """Sum wire stats across a gradient dict's tensors."""
    vals = list(stats.values())
    return WireStats(
        index_bits=sum(s.index_bits for s in vals),
        value_bits=sum(s.value_bits for s in vals),
        dense_bits=sum(s.dense_bits for s in vals),
        saturated=sum(s.saturated for s in vals),
    )
