"""Differentiable collectives over a `Collectives` group: the
communication of sequence and tensor parallelism as autograd Functions.

The JAX package differentiates through `ppermute`, `all_to_all` and the
collectives GSPMD inserts; here each is a `torch.autograd.Function` whose
backward is the transposed collective:

- `ring_hop`: send to rank + 1, receive from rank - 1; backward the hop
  the other way (ring attention's K/V rotation);
- `all_to_all`: rows `x[W, ...]` exchanged; backward the same exchange,
  which is its own inverse (Ulysses' re-sharding);
- `copy_to_group` / `reduce_from_group`: Megatron's pair, identity forward
  with an all-reduce backward, and an all-reduce forward with an identity
  backward (around column- and row-parallel products);
- `gather_from_group`: the all_gather of column-parallel outputs along a
  dimension; backward takes this rank's slice.

Each Function that communicates sends its input detached and returns a
fresh tensor: an in-process group hands tensors between threads by
reference, and a received tensor must neither alias the sender's storage
nor carry its autograd graph.

**The in-thread backward rule.** Every worker calls each collective in the
same order, the backward's too. On CUDA, autograd runs the backward nodes
of every thread on one device thread, so an in-process worker's backward
hop would block that thread at the group's barrier while the other
workers' backward nodes wait behind it. `backward(loss)` runs the backward
on the calling thread (`torch.autograd.set_multithreading_enabled(False)`,
thread-local), which the in-process workers need and which costs a
one-process-per-card run nothing; `torch.utils.checkpoint`'s recomputation
then runs there too.
"""

from __future__ import annotations

import torch

from deepreduce_tpu_torch.collectives import Collectives


def _fresh(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`out`, copied where it is `x`'s storage (a one-worker group returns
    its input; the in-process all_to_all and sums build new tensors)."""
    return out.clone() if out.data_ptr() == x.data_ptr() else out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        # an in-process hop hands over the sender's tensor itself
        return coll.ring_shift(x.detach()).wait().clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.ring_shift(g.contiguous(), reverse=True).wait().clone(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return _fresh(coll.all_to_all(x.detach()), x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _fresh(ctx.coll.all_to_all(g), g), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return x  # autograd returns it as a view of the input

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _fresh(ctx.coll.all_reduce_sum(g), g), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll):
        x = x.detach().contiguous()
        return _fresh(coll.all_reduce_sum(x), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, dim):
        ctx.coll, ctx.dim = coll, dim
        return torch.cat(coll.all_gather(x.detach().contiguous()).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.coll.world_size, dim=ctx.dim)[ctx.coll.rank].contiguous(), None, None


def ring_hop(x: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """Worker rank - 1's `x`, differentiably."""
    return _RingHop.apply(x, coll)


def all_to_all(x: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """`coll.all_to_all(x)` (x[W, ...]: row j to worker j), differentiably."""
    return _AllToAll.apply(x, coll)


def copy_to_group(x: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group."""
    return _CopyToGroup.apply(x, coll)


def reduce_from_group(x: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """The sum of `x` over the group (worker order); identity backward."""
    return _ReduceFromGroup.apply(x, coll)


def gather_from_group(x: torch.Tensor, coll: Collectives, dim: int = -1) -> torch.Tensor:
    """Every worker's `x` concatenated along `dim` in rank order; the
    backward keeps this worker's slice."""
    return _GatherFromGroup.apply(x, coll, dim)


def backward(loss: torch.Tensor) -> None:
    """`loss.backward()` on the calling thread (the in-thread rule above)."""
    with torch.autograd.set_multithreading_enabled(False):
        loss.backward()
