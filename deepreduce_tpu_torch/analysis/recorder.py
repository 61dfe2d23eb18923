"""The run-time collective inventory: a `Collectives` that records every
call it forwards, the port's counterpart of the JAX package's static
inventory (`COLLECTIVE_PRIMS`, `collective_counts`,
`collective_counts_by_axis` in `deepreduce_tpu/analysis/rules.py`).

`Recorder(inner, axis)` wraps any `collectives.Collectives` (a
`ProcessGroupCollectives` over NCCL or gloo, an `InProcessMember`, `Solo`)
and appends one `Call` per collective, in call order: the JAX primitive the
call stands for, its operand's bytes, shape and dtype, and the axis name
the recorder was given. A hierarchical worker wraps its `ici` and `dcn`
members in two recorders sharing one `Tape`, which gives the by-axis
inventory. A `Tape` may also carry the census's ops and the harness's
markers (`mark`), so that one sequence orders collectives against the work
around them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch

from deepreduce_tpu_torch.collectives import Collectives, Gathered

# the port's collective -> the JAX primitive it stands for
JAX_PRIM = {
    "all_gather": "all_gather",
    "all_gather_async": "all_gather",
    "ring_shift": "ppermute",
    "all_to_all": "all_to_all",
    "reduce_scatter_sum": "reduce_scatter",
    "all_reduce_sum": "psum",
    "all_reduce_max": "pmax",
}

# the JAX primitives the inventory tracks (its `COLLECTIVE_PRIMS`)
COLLECTIVE_PRIMS = (
    "all_gather",
    "all_to_all",
    "ppermute",
    "pshuffle",
    "psum",
    "psum_scatter",
    "reduce_scatter",
    "pmax",
    "pmin",
    "pbroadcast",
)


@dataclasses.dataclass(frozen=True)
class Call:
    """One collective call: the JAX primitive, the port's method, the
    operand's bytes, shape and dtype, and the axis."""

    op: str
    method: str
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str
    axis: str

    def key(self) -> Tuple[str, str, int]:
        return (self.axis, self.op, self.nbytes)


class Tape:
    """One worker's sequence of events, appended from any thread: ('coll',
    Call), ('op', census entry) and ('mark', text)."""

    def __init__(self):
        self.events: List[tuple] = []
        self._lock = threading.Lock()

    def append(self, kind: str, item) -> None:
        with self._lock:
            self.events.append((kind, item))

    def mark(self, text: str) -> None:
        self.append("mark", text)

    @property
    def calls(self) -> List[Call]:
        return [item for kind, item in self.events if kind == "coll"]


class Recorder(Collectives):
    """`inner`'s collectives, each recorded on `tape` under `axis`."""

    def __init__(self, inner: Collectives, axis: str = "data", tape: Optional[Tape] = None):
        self.inner = inner
        self.axis = axis
        self.tape = Tape() if tape is None else tape
        self.world_size = inner.world_size
        self.rank = inner.rank

    def _record(self, method: str, x: torch.Tensor) -> None:
        self.tape.append("coll", Call(JAX_PRIM[method], method, x.numel() * x.element_size(), tuple(x.shape),
                                      str(x.dtype).replace("torch.", ""), self.axis))

    def all_gather(self, x):
        self._record("all_gather", x)
        return self.inner.all_gather(x)

    def all_gather_async(self, x) -> Gathered:
        self._record("all_gather_async", x)
        return self.inner.all_gather_async(x)

    def ring_shift(self, x, reverse=False) -> Gathered:
        self._record("ring_shift", x)
        return self.inner.ring_shift(x, reverse=reverse)

    def all_to_all(self, x):
        self._record("all_to_all", x)
        return self.inner.all_to_all(x)

    def reduce_scatter_sum(self, x):
        self._record("reduce_scatter_sum", x)
        return self.inner.reduce_scatter_sum(x)

    def all_reduce_sum(self, x):
        self._record("all_reduce_sum", x)
        return self.inner.all_reduce_sum(x)

    def all_reduce_max(self, x):
        self._record("all_reduce_max", x)
        return self.inner.all_reduce_max(x)


def counts(calls: List[Call]) -> Dict[str, int]:
    """{JAX primitive: calls}."""
    out: Dict[str, int] = {}
    for c in calls:
        out[c.op] = out.get(c.op, 0) + 1
    return dict(sorted(out.items()))


def counts_by_axis(calls: List[Call]) -> Dict[str, Dict[str, int]]:
    """{axis: {JAX primitive: calls}}."""
    out: Dict[str, Dict[str, int]] = {}
    for c in calls:
        per = out.setdefault(c.axis, {})
        per[c.op] = per.get(c.op, 0) + 1
    return {a: dict(sorted(per.items())) for a, per in sorted(out.items())}


def operand_bytes(calls: List[Call], *, ops=None, axis: Optional[str] = None) -> int:
    """The summed operand bytes of the calls of `ops` (all when None) on
    `axis` (all when None)."""
    return sum(c.nbytes for c in calls if (ops is None or c.op in ops) and (axis is None or c.axis == axis))


def schedule(calls: List[Call]) -> List[Tuple[str, str, int]]:
    """The collective sequence as (axis, op, bytes): what
    `jx-collective-schedule` holds fixed across values and masks."""
    return [c.key() for c in calls]
