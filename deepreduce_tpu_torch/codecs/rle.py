"""Run-length index codec over the implicit 0/1 bitmap (lossless), ported
from `deepreduce_tpu/codecs/rle.py`.

The live indices are sorted ascending (a stable sort; the values follow
them), and the runs come straight from the sorted indices: a one-run
starts wherever `idx[j] != idx[j-1] + 1`, so the d-length bitmap is never
built and no loop runs. The alternating lengths [z0, o0, z1, o1, ..., z_last]
(a zero-run before each one-run, then the trailing zero-run) fill a static
budget of 2k + 2 slots and are bit-packed (`codecs.packing`) at the width
of the longest run; the run count 2 n_runs + 1 and the width travel
in-band as the packed stream's (count, width) words, so neither is read on
the host. The words, count and width are bitwise equal to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deepreduce_tpu_torch.codecs import packing
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class RLEMeta:
    k: int
    d: int

    @property
    def run_budget(self) -> int:
        return 2 * self.k + 2

    @property
    def max_width(self) -> int:
        # == max(1, ceil(log2(d + 1))), exactly
        return max(1, int(self.d).bit_length())

    @property
    def n_words(self) -> int:
        return packing.budget_words(self.run_budget, self.max_width)


@dataclasses.dataclass(frozen=True)
class RLEPayload:
    values: torch.Tensor  # f32[k] in ascending-index order (f32[0] once stripped in 'both' mode)
    runs: packing.PackedInts
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """Wire leaves in the JAX pytree's flatten order."""
        return (self.values,) + self.runs.leaves() + (self.nnz,)

    @staticmethod
    def from_leaves(leaves) -> "RLEPayload":
        values, words, count, width, nnz = leaves
        return RLEPayload(values=values, runs=packing.PackedInts(words, count, width), nnz=nnz)


def encode(sp: SparseGrad, meta: RLEMeta) -> RLEPayload:
    k, d = meta.k, meta.d
    dev = sp.values.device
    slots = torch.arange(k, device=dev)
    live = slots < sp.nnz
    order = torch.sort(torch.where(live, sp.indices, d), stable=True).indices
    idx = sp.indices[order].to(torch.int64)
    vals = torch.where(live, sp.values[order], torch.zeros((), dtype=sp.values.dtype, device=dev))

    prev = torch.cat([torch.full((1,), -2, dtype=torch.int64, device=dev), idx[:-1]])
    run_start = live & (idx != prev + 1)
    run_id = torch.cumsum(run_start.to(torch.int64), 0) - 1  # the one-run of each slot
    n_runs = torch.clamp(run_start.sum(), min=1)
    # the run's length and start; dead slots (and a run id of -1) park past k
    ones_len = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    ones_len.index_add_(0, torch.where(live, run_id, k), live.to(torch.int64))
    ones_len = ones_len[:k]
    starts = torch.zeros(2 * k, dtype=torch.int64, device=dev)
    starts[torch.where(run_start, run_id, k + slots)] = torch.where(run_start, idx, 0)
    starts = starts[:k]
    ends = starts + ones_len
    prev_end = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), ends[:-1]])
    zeros_len = starts - prev_end  # the zero-run before each one-run

    # [z0, o0, z1, o1, ...] for the runs in use, then the trailing zero-run at 2 n_runs
    in_use = slots < n_runs
    pairs = torch.stack([torch.where(in_use, zeros_len, 0), torch.where(in_use, ones_len, 0)], dim=1).reshape(-1)
    arr = torch.cat([pairs, torch.zeros(2, dtype=torch.int64, device=dev)])
    last_end = ends.index_select(0, (n_runs - 1).reshape(1))
    arr = torch.where(torch.arange(meta.run_budget, device=dev) == 2 * n_runs, d - last_end, arr)
    width = packing.bits_needed(arr.max())
    packed = packing.pack(arr, width, max_width=meta.max_width)
    packed = dataclasses.replace(packed, count=(2 * n_runs + 1).to(torch.int32))
    return RLEPayload(values=vals, runs=packed, nnz=sp.nnz.to(torch.int32))


def decode(payload: RLEPayload, meta: RLEMeta, shape: Tuple[int, ...]) -> SparseGrad:
    k = meta.k
    arr = packing.unpack(payload.runs, meta.run_budget)
    dev = arr.device
    n_runs = (payload.runs.count.to(torch.int64) - 1) // 2
    zeros_len = arr[0 : 2 * k : 2][:k]
    j = torch.arange(k, device=dev)
    ones_len = torch.where(j < n_runs, arr[1 : 2 * k + 1 : 2][:k], 0)
    bounds = torch.cumsum(zeros_len + ones_len, 0)  # the end of each one-run
    starts = bounds - ones_len
    ones_prefix = torch.cumsum(ones_len, 0)  # slots used up to each run's end
    run_of = torch.clamp(torch.searchsorted(ones_prefix, j, right=True), 0, k - 1)
    before = torch.where(run_of > 0, ones_prefix[torch.clamp(run_of - 1, min=0)], 0)
    idx = starts[run_of] + (j - before)
    live = j < payload.nnz
    zero = torch.zeros((), dtype=payload.values.dtype, device=dev)
    return SparseGrad(
        values=torch.where(live, payload.values, zero),
        indices=torch.where(live, idx, 0).to(torch.int32),
        nnz=payload.nnz,
        shape=shape,
    )


def wire_bits(payload: RLEPayload, meta: RLEMeta) -> torch.Tensor:
    return packing.wire_bits(payload.runs).to(torch.float32)
