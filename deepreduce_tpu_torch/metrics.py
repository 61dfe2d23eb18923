"""Bytes-on-wire accounting and timers, ported from
`deepreduce_tpu/metrics.py`: per-tensor `WireStats` and their sum, the ring
exchange's per-worker bytes, the padded bytes a payload occupies on the
device (`payload_device_bytes`) and the reference's micro-benchmark timer
(`timed`)."""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Union

import torch


@dataclasses.dataclass(frozen=True)
class WireStats:
    """Per-tensor per-step wire accounting in bits (0-d float32 tensors)."""

    index_bits: torch.Tensor
    value_bits: torch.Tensor
    dense_bits: torch.Tensor
    # number of payloads whose selection filled every budget slot
    saturated: torch.Tensor
    # bits this worker moved on the intra-node link: the hierarchical
    # exchange's slice-mean leg, ring-adjusted like the cost model's terms;
    # 0.0 in every flat exchange. index_bits and value_bits stay the scarce
    # link's (the flat group's, or the one across slices), and total_bits
    # leaves this counter out.
    ici_bits: Union[float, torch.Tensor] = 0.0

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
        ici_bits=sum(s.ici_bits for s in vals),
    )


def ring_wire_bytes(buffer_bytes: int, num_workers: int) -> int:
    """Per-worker wire bytes of the ring exchange (`comm_ring.py`): each
    worker forwards the B-byte buffer W - 1 times."""
    return int(buffer_bytes) * max(0, int(num_workers) - 1)


def payload_device_bytes(payload: Any) -> int:
    """The padded bytes a payload's tensors occupy (what the allgather
    moves), as opposed to `WireStats`' meaningful bits: a payload object
    with `leaves()`, a tensor, or a dict / list / tuple of them."""
    if torch.is_tensor(payload):
        return payload.numel() * payload.element_size()
    if hasattr(payload, "leaves"):
        payload = payload.leaves()
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_device_bytes(p) for p in payload)
    return 0


@contextmanager
def timed(label: str, enabled: bool = True, sink: Dict[str, float] | None = None) -> Iterator[None]:
    """The reference's micro-benchmark timer around host code. It reads
    the host clock only: synchronize the device inside the body for a
    device time. Records in a ``finally``, so a raising body still
    reports; a `sink` receives the accumulated total, else the time is
    printed when `enabled`."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if sink is not None:
            sink[label] = sink.get(label, 0.0) + elapsed
        elif enabled:
            print(f"{label} time:{elapsed}")
