"""The collectives of the data-parallel workers, behind one small interface.

The in-collective communicators (`qar.py`, `sparse_rs.py`) and the exchange
are written against `Collectives`: five operations on one tensor each, in
rank order, an all_gather that returns before it completes
(`all_gather_async`, for the bucketed exchange's schedules) and the ring
hop `ring_shift` (send to rank + 1, receive from rank - 1, also returned
before it completes: the ring decode's transfer overlaps its decode; with
`reverse=True` the hop the other way, the backward of ring attention's).
Three implementations:

- `ProcessGroupCollectives`: a `torch.distributed` group, NCCL on the card
  (int8 `reduce_scatter_tensor` and `all_to_all_single` are NCCL-native),
  gloo in the CPU tests;
- `Solo`: world size 1 without a group; every collective is the identity;
- `InProcessGroup`: W lockstep workers in one process, one thread each,
  meeting at a barrier inside every collective. The parity tests drive W
  workers with it; sums run in worker order from zero.

`all_reduce_counted(coll, x)` is the all_reduce_sum of a driver whose
collective traffic is part of its contract (the federated round's one fused
all_reduce): it counts the calls and their operand bytes
(`reduce_counts()`), once per worker, as `ops.launch_counts` counts kernel
launches.

`collectives_for(group)` picks the implementation for what the entry points
accept as `group`: None, a `torch.distributed.ProcessGroup` or a
`Collectives`.

The hierarchical exchange runs over two groups a worker: `ici`, the
workers of its slice (the fast intra-node link), and `dcn`, the workers at
its position in every slice (the scarce link across nodes). Worker r of
n_slices x per_slice sits in slice r // per_slice at position
r % per_slice, the layout of the JAX package's `make_hybrid_mesh`.
`split_group` makes the pair from one `torch.distributed` group;
`InProcessGrid` gives in-process workers theirs. `InProcessMesh` is the
general form: in-process workers over any named axes, laid out row-major
as `parallel.mesh.make_mesh` lays out the ranks of a `torch.distributed`
group (the JAX package's `Mesh(np.reshape(devices, shape))`).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


class Gathered:
    """A collective in flight (an all_gather or a ring hop); `wait()`
    returns its result. On NCCL the wait makes the current CUDA stream wait
    for the collective (the host does not block); a collective that
    completed at once returns it."""

    def __init__(self, out: torch.Tensor, work=None):
        self._out = out
        self._work = [] if work is None else list(work) if isinstance(work, (list, tuple)) else [work]

    def wait(self) -> torch.Tensor:
        for work in self._work:
            work.wait()
        self._work = []
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

    def ring_shift(self, x: torch.Tensor, reverse: bool = False) -> Gathered:
        """Send `x` to worker rank + 1 and receive worker rank - 1's (mod
        W), started now and read at `wait()`; `x` must not change before
        then. `reverse`: send to rank - 1 and receive rank + 1's."""
        raise NotImplementedError

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

    def ring_shift(self, x, reverse=False):
        return Gathered(x)

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

    def ring_shift(self, x, reverse=False):
        # the receive is posted with the send; the caller waits on both
        # before reading (an early read would see stale bytes, no error)
        x = x.contiguous()
        out = torch.empty_like(x)
        W, r, hop = self.world_size, self.rank, -1 if reverse else 1
        peer = lambda w: dist.get_global_rank(self.group, w % W)
        ops = [dist.P2POp(dist.isend, x, peer(r + hop), self.group),
               dist.P2POp(dist.irecv, out, peer(r - hop), self.group)]
        return Gathered(out, dist.batch_isend_irecv(ops))

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
        return _run_threads(self.world_size, self.member, [self], fn, args_per_rank)


def _run_threads(n: int, member, groups, fn, args_per_rank):
    """[fn(member(r), *args[r]) for r < n], one thread a worker; a failing
    worker aborts the barriers of `groups`, and the first exception is
    raised after every thread has stopped."""
    results: List[object] = [None] * n
    errors: List[BaseException] = []

    def body(r):
        try:
            results[r] = fn(member(r), *(a[r] for a in args_per_rank))
        except BaseException as e:  # noqa: BLE001 - re-raised below, after the join
            errors.append(e)
            for g in groups:
                g._barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
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

    def ring_shift(self, x, reverse=False):
        src = self.rank + 1 if reverse else self.rank - 1
        return Gathered(self._group.exchange(self.rank, x)[src % self.world_size])

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


def mesh_lines(axes: Dict[str, int]) -> Dict[str, List[List[int]]]:
    """{axis: its lines}: the ranks 0..prod(sizes) laid out row-major over
    the axes in their given order, and for each axis every line of ranks
    that differ on that axis alone, in increasing rank (so rank
    `line[i]` has index i on the axis), the lines in order of their first
    rank."""
    lines: Dict[str, Dict[tuple, List[int]]] = {a: {} for a in axes}
    for r in range(math.prod(axes.values())):
        at, rest = {}, r
        for a in reversed(list(axes)):
            rest, at[a] = divmod(rest, axes[a])
        for a in axes:
            lines[a].setdefault(tuple(i for b, i in at.items() if b != a), []).append(r)
    return {a: list(by_key.values()) for a, by_key in lines.items()}


class InProcessMesh:
    """Lockstep workers in one process over named axes `{name: size}`,
    one thread each (`run`), laid out as `mesh_lines` lays out ranks:
    `member(r)` is worker r's `{axis: InProcessMember}`, its rank within
    each of its lines, each line a group with its own barrier."""

    def __init__(self, axes: Dict[str, int], timeout: float = 120.0):
        self.axes = dict(axes)
        self.world_size = math.prod(self.axes.values())
        self._groups: List[InProcessGroup] = []
        self._at: List[Dict[str, Tuple[InProcessGroup, int]]] = [{} for _ in range(self.world_size)]
        for a, lines in mesh_lines(self.axes).items():
            for line in lines:
                group = InProcessGroup(len(line), timeout)
                self._groups.append(group)
                for i, r in enumerate(line):
                    self._at[r][a] = (group, i)

    def member(self, rank: int):
        return {a: group.member(i) for a, (group, i) in self._at[rank].items()}

    def run(self, fn, *args_per_rank):
        """[fn(member(r), *args[r]) for r] with one thread per worker."""
        return _run_threads(self.world_size, self.member, self._groups, fn, args_per_rank)


class InProcessGrid:
    """n_slices x per_slice lockstep workers in one process over the
    `InProcessMesh` (dcn, ici) = (n_slices, per_slice): worker r's
    `member(r)` is its (ici, dcn) pair, the `InProcessMember`s of its
    slice's group (rank r % per_slice) and of its position's group (rank
    r // per_slice)."""

    def __init__(self, n_slices: int, per_slice: int, timeout: float = 120.0):
        self.n_slices, self.per_slice = n_slices, per_slice
        self.mesh = InProcessMesh({"dcn": n_slices, "ici": per_slice}, timeout)
        self.world_size = self.mesh.world_size

    def member(self, rank: int) -> Tuple["InProcessMember", "InProcessMember"]:
        m = self.mesh.member(rank)
        return m["ici"], m["dcn"]

    def run(self, fn, *args_per_rank):
        """[fn(member(r), *args[r]) for r] with one thread per worker."""
        return self.mesh.run(lambda m, *args: fn((m["ici"], m["dcn"]), *args), *args_per_rank)


def split_group(group, ici_size: Optional[int]) -> Tuple[Collectives, Collectives]:
    """The (ici, dcn) pair of this worker from what the entry points accept:
    an (ici, dcn) pair itself (whose slice must have `ici_size` workers when
    it is given), or one group of W = n_slices * ici_size workers (None: one
    worker), split as `parallel.mesh.make_hybrid_mesh` lays the workers
    out (a `torch.distributed` group with `dist.new_group`, a collective
    call of every rank of the default group)."""
    if isinstance(group, tuple):
        ici, dcn = (collectives_for(g) for g in group)
        if ici_size is not None and ici.world_size != ici_size:
            raise ValueError(f"ici_size={ici_size} contradicts the given slice group of {ici.world_size} workers")
        return ici, dcn
    coll = collectives_for(group)
    W = coll.world_size
    if ici_size is None:
        raise ValueError("hier=True needs this worker's (ici, dcn) pair, or one group and cfg.ici_size to split it")
    if ici_size < 1 or W % ici_size:
        raise ValueError(f"ici_size={ici_size} does not divide the world size {W}")
    if isinstance(coll, Solo):
        return Solo(), Solo()
    if not isinstance(coll, ProcessGroupCollectives):
        raise ValueError("in-process workers take their (ici, dcn) pair from InProcessGrid(n_slices, per_slice)")
    from deepreduce_tpu_torch.parallel.mesh import make_hybrid_mesh

    mesh = make_hybrid_mesh(W // ici_size, ici_size, coll.group)
    return mesh["ici"], mesh["dcn"]


_REDUCE_COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0}
_REDUCE_LOCK = threading.Lock()


def all_reduce_counted(coll: Collectives, x: torch.Tensor) -> torch.Tensor:
    """`coll.all_reduce_sum(x)`, counted in `reduce_counts()`: one call and
    x's bytes, on every worker."""
    with _REDUCE_LOCK:
        _REDUCE_COUNTS["all_reduce"] += 1
        _REDUCE_COUNTS["all_reduce_bytes"] += x.numel() * x.element_size()
    return coll.all_reduce_sum(x)


def reduce_counts() -> dict:
    """The counted all_reduce calls and operand bytes since the last reset."""
    with _REDUCE_LOCK:
        return dict(_REDUCE_COUNTS)


def reset_reduce_counts() -> None:
    with _REDUCE_LOCK:
        for k in _REDUCE_COUNTS:
            _REDUCE_COUNTS[k] = 0


def collectives_for(group) -> Collectives:
    """The `Collectives` of what an entry point was given as `group`."""
    if group is None:
        return Solo()
    if isinstance(group, Collectives):
        return group
    return ProcessGroupCollectives(group)
