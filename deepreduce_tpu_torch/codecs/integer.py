"""Delta + bit-packed integer index codec, ported from
`deepreduce_tpu/codecs/integer.py`.

The live indices are sorted ascending (a stable sort, like `jnp.argsort`),
delta-coded (the first delta is the absolute index, dead slots 0) and
packed at the width of the largest delta into the static budget of
`max_width = ceil(log2(d + 1))` bits per slot. The words, count and width
are bitwise equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch import sparse
from deepreduce_tpu_torch.codecs import packing
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class IntegerMeta:
    k: int
    d: int

    @property
    def max_width(self) -> int:
        # == max(1, ceil(log2(d + 1))), exactly
        return max(1, int(self.d).bit_length())

    @property
    def n_words(self) -> int:
        return packing.budget_words(self.k, self.max_width)


@dataclasses.dataclass(frozen=True)
class IntegerPayload:
    values: torch.Tensor  # f32[k] in ascending-index order (f32[0] once stripped in 'both' mode)
    deltas: packing.PackedInts
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """Wire leaves in the JAX pytree's flatten order."""
        return (self.values,) + self.deltas.leaves() + (self.nnz,)

    @staticmethod
    def from_leaves(leaves) -> "IntegerPayload":
        values, words, count, width, nnz = leaves
        return IntegerPayload(values=values, deltas=packing.PackedInts(words, count, width), nnz=nnz)


def encode(sp: SparseGrad, meta: IntegerMeta) -> IntegerPayload:
    k, d = meta.k, meta.d
    dev = sp.values.device
    live = torch.arange(k, device=dev) < sp.nnz
    order = torch.sort(torch.where(live, sp.indices, d), stable=True).indices
    idx = torch.where(live, sp.indices[order], 0)
    vals = torch.where(live, sp.values[order], torch.zeros((), dtype=sp.values.dtype, device=dev))
    prev = torch.cat([torch.zeros(1, dtype=idx.dtype, device=dev), idx[:-1]])
    deltas = torch.where(live, idx - prev, 0)
    width = packing.bits_needed(deltas.max())
    packed = packing.pack(deltas, width, max_width=meta.max_width)
    packed = dataclasses.replace(packed, count=sp.nnz.to(torch.int32))
    return IntegerPayload(values=vals, deltas=packed, nnz=sp.nnz.to(torch.int32))


def decode(payload: IntegerPayload, meta: IntegerMeta, shape: Tuple[int, ...]) -> SparseGrad:
    deltas = packing.unpack(payload.deltas, meta.k)
    idx = torch.cumsum(deltas, 0)
    live = torch.arange(meta.k, device=idx.device) < payload.nnz
    zero = torch.zeros((), dtype=payload.values.dtype, device=idx.device)
    return SparseGrad(
        values=torch.where(live, payload.values, zero),
        indices=torch.where(live, idx, 0).to(torch.int32),
        nnz=payload.nnz,
        shape=shape,
    )


def decode_dense(
    payload: IntegerPayload,
    meta: IntegerMeta,
    shape: Tuple[int, ...],
    *,
    values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Straight to the dense tensor: the cumsum of the deltas (clipped into
    [0, d-1]) places slot s, one scatter. `values` overrides the payload's
    values ('both' mode passes the value codec's output, in the same
    ascending-index order)."""
    k, d = meta.k, meta.d
    idx = torch.clamp(torch.cumsum(packing.unpack(payload.deltas, k), 0), 0, d - 1)
    vals = payload.values if values is None else values
    n_v = vals.shape[0]
    vals = sparse.fit_length(vals, k)
    nnz = torch.clamp(payload.nnz, max=min(k, n_v))
    return sparse.scatter_ascending(vals, idx, nnz, d).reshape(shape)


def wire_bits(payload: IntegerPayload, meta: IntegerMeta) -> torch.Tensor:
    return packing.wire_bits(payload.deltas).to(torch.float32)
