"""Participation faults: the `FaultPlan` schedule and i.i.d. dropout,
ported from `deepreduce_tpu/resilience/faults.py`.

A participation mask is a bool[W] tensor on the device: True = the
worker's payload enters this step's aggregate; False = it contributes
zero, the mean renormalizes by the live count, and its own decode is zero
so that its residual keeps its whole compensated gradient. Both sources
are functions of host data every worker holds (the config, the step):

- `FaultPlan`, a schedule parsed from a spec like ``"2@5:9,0@12"``
  (worker 2 dropped for steps 5..8, worker 0 at step 12);
- dropout, each worker dropped with `drop_rate` per step, drawn from the
  counter-based stream keyed by (seed, tag 0x0FA17, step), never by the
  worker, so every worker derives the same mask without a collective.

The mask is built on the device without a copy: the plan's flags filled in
place, the dropout drawn there from the same stream.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import torch

from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.resilience import stream

# `worker@step` or `worker@start:stop`
_ENTRY_RE = re.compile(r"^\s*(\d+)\s*@\s*(\d+)\s*(?::\s*(\d+)\s*)?$")
# domain separation of the dropout stream (the chaos stream's is 0x0C405)
DROPOUT_TAG = 0x0FA17


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static drop schedule: (worker, start, stop) triples, the worker
    dropped for steps ``start <= t < stop``."""

    entries: Tuple[Tuple[int, int, int], ...]

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"fault_plan must be a non-empty spec string like '2@5:9,0@12', got {spec!r}")
        entries = []
        for part in spec.split(","):
            m = _ENTRY_RE.match(part)
            if m is None:
                raise ValueError(f"bad fault_plan entry {part.strip()!r} — expected 'worker@step' or 'worker@start:stop'")
            worker, start = int(m.group(1)), int(m.group(2))
            stop = int(m.group(3)) if m.group(3) is not None else start + 1
            if stop <= start:
                raise ValueError(f"fault_plan entry {part.strip()!r} has empty range [{start}, {stop})")
            entries.append((worker, start, stop))
        return cls(entries=tuple(entries))

    def dropped(self, step: int, num_workers: int) -> List[int]:
        """The workers the plan drops at `step`, ascending; entries whose
        worker id is past the mesh width are ignored."""
        return sorted({w for w, a, b in self.entries if a <= step < b and w < num_workers})

    def mask(self, step: int, num_workers: int, *, device: DeviceLike = "cuda") -> torch.Tensor:
        """bool[W] on `device`: True = live at `step`."""
        return live_mask([w not in self.dropped(step, num_workers) for w in range(num_workers)], device)


def live_mask(live: Sequence[bool], device: DeviceLike = "cuda") -> torch.Tensor:
    """bool[W] on `device` from host flags, filled in place: no host copy."""
    mask = torch.ones(len(live), dtype=torch.bool, device=resolve_device(device))
    for w, ok in enumerate(live):
        if not ok:
            mask[w : w + 1].fill_(False)
    return mask


def dropout_live(num_workers: int, step: int, seed: int, drop_rate: float) -> List[bool]:
    """Each worker live with probability 1 - drop_rate at `step`: position
    w of the stream keyed by (seed, DROPOUT_TAG, step)."""
    k = stream.key(seed, DROPOUT_TAG, step)
    return [stream.bernoulli(k, 1.0 - float(drop_rate), w) for w in range(num_workers)]


def participation_mask(
    num_workers: int,
    step: int,
    seed: int = 0,
    *,
    drop_rate: float = 0.0,
    fault_plan: Optional[str] = None,
    device: DeviceLike = "cuda",
    draws: Optional[Sequence[bool]] = None,
) -> Optional[torch.Tensor]:
    """The step's mask: the AND of the plan and the dropout, or None when
    neither is configured. `draws` (W host flags, True = live) replaces the
    dropout's draws: the parity tests inject `jax.random.bernoulli`'s."""
    if drop_rate <= 0.0 and fault_plan is None:
        return None
    W = int(num_workers)
    live = [True] * W
    if fault_plan is not None:
        gone = FaultPlan.parse(fault_plan).dropped(step, W)
        live = [ok and w not in gone for w, ok in enumerate(live)]
    if drop_rate > 0.0 and draws is not None:
        live = [a and bool(b) for a, b in zip(live, draws)]
    mask = live_mask(live, device)
    if drop_rate > 0.0 and draws is None:
        # `dropout_live`'s draws, made on the device: no per-worker launch
        k = stream.key(seed, DROPOUT_TAG, step)
        mask = mask & (stream.words(k, W, mask.device) < stream.threshold(1.0 - float(drop_rate)))
    return mask
