"""The collectives of the data-parallel workers, behind one small interface.

The in-collective communicators (`qar.py`, `sparse_rs.py`) and the exchange
are written against `Collectives`: five operations on one tensor each, in
rank order, and an all_gather that returns before it completes
(`all_gather_async`, for the bucketed exchange's schedules). Three
implementations:

- `ProcessGroupCollectives`: a `torch.distributed` group, NCCL on the card
  (int8 `reduce_scatter_tensor` and `all_to_all_single` are NCCL-native),
  gloo in the CPU tests;
- `Solo`: world size 1 without a group; every collective is the identity;
- `InProcessGroup`: W lockstep workers in one process, one thread each,
  meeting at a barrier inside every collective. The parity tests drive W
  workers with it; sums run in worker order from zero.

`collectives_for(group)` picks the implementation for what the entry points
accept as `group`: None, a `torch.distributed.ProcessGroup` or a
`Collectives`.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch
import torch.distributed as dist


class Gathered:
    """An all_gather in flight; `wait()` returns its [W, ...] result. On
    NCCL the wait makes the current CUDA stream wait for the collective (the
    host does not block); a gather that completed at once returns it."""

    def __init__(self, out: torch.Tensor, work=None):
        self._out = out
        self._work = work

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out


class Collectives:
    """`world_size` workers; this one is `rank`. Every method is called by
    every worker in the same order, with tensors of the same shape and
    dtype on each."""

    world_size: int = 1
    rank: int = 0

    def all_gather_async(self, x: torch.Tensor) -> Gathered:
        """`all_gather(x)`, started now and read at `wait()`; `x` must not
        change before then. Here it completes at once."""
        return Gathered(self.all_gather(x))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x[W, ...] -> [W, ...]: row j of every worker lands on worker j;
        row w of the result came from worker w."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x[...] -> [W, ...], row w from worker w."""
        raise NotImplementedError

    def reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x[W * s] -> [s]: the sum over workers of chunk `rank`."""
        raise NotImplementedError

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Solo(Collectives):
    """One worker, no group: every collective is the identity."""

    def all_to_all(self, x):
        return x

    def all_gather(self, x):
        return x[None]

    def reduce_scatter_sum(self, x):
        return x

    def all_reduce_sum(self, x):
        return x

    def all_reduce_max(self, x):
        return x


class ProcessGroupCollectives(Collectives):
    """A `torch.distributed` process group; results are fresh tensors."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def all_to_all(self, x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x):
        return self.all_gather_async(x).wait()

    def all_gather_async(self, x):
        x = x.contiguous()
        # the concatenated form: gloo accepts no stacked output
        out = torch.empty(self.world_size * x.numel(), dtype=x.dtype, device=x.device)
        work = dist.all_gather_into_tensor(out, x.reshape(-1), group=self.group, async_op=True)
        return Gathered(out.view((self.world_size,) + tuple(x.shape)), work)

    def reduce_scatter_sum(self, x):
        x = x.contiguous()
        out = torch.empty(x.shape[0] // self.world_size, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def _all_reduce(self, x, op):
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_reduce_sum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)


class InProcessGroup:
    """W lockstep workers in one process. `member(r)` is worker r's
    `Collectives`; each worker runs in its own thread (`run`). A collective
    posts this worker's tensor, waits for all W, reads what it needs, and
    waits again before the slots are reused."""

    def __init__(self, world_size: int, timeout: float = 120.0):
        self.world_size = world_size
        self._barrier = threading.Barrier(world_size, timeout=timeout)
        self._slots: List[Optional[torch.Tensor]] = [None] * world_size

    def member(self, rank: int) -> "InProcessMember":
        return InProcessMember(self, rank)

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Every worker's `x`, in rank order."""
        self._slots[rank] = x
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def run(self, fn, *args_per_rank):
        """[fn(member(r), *args[r]) for r] with one thread per worker; the
        first exception of any worker is raised after all have stopped."""
        results: List[object] = [None] * self.world_size
        errors: List[BaseException] = []

        def body(r):
            try:
                results[r] = fn(self.member(r), *(a[r] for a in args_per_rank))
            except BaseException as e:  # noqa: BLE001 - re-raised below, after the join
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


class InProcessMember(Collectives):
    def __init__(self, group: InProcessGroup, rank: int):
        self._group = group
        self.world_size = group.world_size
        self.rank = rank

    def _sum(self, parts):
        acc = torch.zeros_like(parts[0])
        for p in parts:  # worker order, from zero
            acc = acc + p
        return acc

    def all_to_all(self, x):
        return torch.stack([p[self.rank] for p in self._group.exchange(self.rank, x)])

    def all_gather(self, x):
        return torch.stack(self._group.exchange(self.rank, x))

    def reduce_scatter_sum(self, x):
        s = x.shape[0] // self.world_size
        parts = self._group.exchange(self.rank, x)
        return self._sum([p[self.rank * s : (self.rank + 1) * s] for p in parts])

    def all_reduce_sum(self, x):
        return self._sum(self._group.exchange(self.rank, x))

    def all_reduce_max(self, x):
        return torch.stack(self._group.exchange(self.rank, x)).amax(dim=0)


def collectives_for(group) -> Collectives:
    """The `Collectives` of what an entry point was given as `group`."""
    if group is None:
        return Solo()
    if isinstance(group, Collectives):
        return group
    return ProcessGroupCollectives(group)
