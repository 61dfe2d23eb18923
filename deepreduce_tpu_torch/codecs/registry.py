"""Codec adapters binding static geometry, ported from
`deepreduce_tpu/codecs/registry.py` for the ported codecs: the bloom and
the delta-bitpacked integer index codecs, and the QSGD and PolyFit value
codecs.

An index codec's payload carries a value table (`value_slots` long) that
the wrapper's 'both' mode hands to the value codec, and a selected count
(`selected`); `payload_specs` / `payload_from_leaves` give a payload's wire
leaves in the JAX pytree's flatten order.

A value codec in 'both' mode runs over that table with arange indices. Its
`indices` (the order it put the values in: the `mapping`) are stripped by
`strip_for_both`, bit-packed by the wrapper at
ceil(log2(both_mapping_max + 1)) bits and put back by `restore_for_both`
before decode. An order-preserving codec (QSGD) elides the mapping."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepreduce_tpu_torch.codecs import bloom, integer, polyfit, qsgd
from deepreduce_tpu_torch.sparse import SparseGrad

Specs = List[Tuple[Tuple[int, ...], torch.dtype]]


class Codec:
    """Base adapter: static (k, d) geometry plus encode/decode and the
    split index/value wire accounting."""

    order_preserving: bool = False

    def __init__(self, k: int, d: int, params: Optional[Dict[str, Any]] = None):
        self.k = k
        self.d = d
        self.params = dict(params or {})

    # -- 'both'-mode hooks (value codecs) -------------------------------- #

    def both_mapping_max(self) -> int:
        """Static largest value of the stripped mapping; 0 = no mapping."""
        return self.k - 1

    def strip_for_both(self, payload) -> Tuple[Any, Optional[torch.Tensor], int]:
        """(payload without its indices, the mapping as int64 or None,
        `both_mapping_max`)."""
        empty = torch.zeros(0, dtype=torch.int32, device=payload.indices.device)
        return dataclasses.replace(payload, indices=empty), payload.indices.to(torch.int64), self.both_mapping_max()

    def restore_for_both(self, stripped, mapping: Optional[torch.Tensor]):
        """The payload with its indices back: the unpacked mapping, or the
        identity when the mapping was elided."""
        if mapping is None:
            idx = torch.arange(self.k, dtype=torch.int32, device=stripped.indices.device)
        else:
            idx = mapping.to(torch.int32)
        return dataclasses.replace(stripped, indices=idx)


class BloomCodec(Codec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.threshold_insert = bool(self.params.get("bloom_threshold_insert", False))
        try:
            self.meta = bloom.BloomMeta.create(
                k,
                d,
                fpr=self.params.get("fpr"),
                policy=self.params.get("policy", "leftmost"),
                blocked=self.params.get("bloom_blocked", False),
                threshold_insert=self.threshold_insert,
            )
        except ValueError as e:
            prefix = "bloom_threshold_insert: " if self.threshold_insert and "policy" not in str(e) else ""
            raise ValueError(f"{prefix}{e}") from e

    @property
    def value_slots(self) -> int:
        return self.meta.budget

    def encode(self, sp: SparseGrad, dense: torch.Tensor) -> bloom.BloomPayload:
        return bloom.encode(sp, dense, self.meta, threshold_insert=self.threshold_insert)

    def encode_direct(self, dense: torch.Tensor, *, sample_size: int, undershoot: float) -> bloom.BloomPayload:
        """Sparsifier-free encode (`bloom.encode_dense_direct`): the filter
        is the selection, so no top-k is materialized."""
        return bloom.encode_dense_direct(dense, self.meta, sample_size=sample_size, undershoot=undershoot)

    def decode_dense(self, payload, shape, *, values=None) -> torch.Tensor:
        return bloom.decode_dense(payload, self.meta, shape, values=values)

    def selected(self, payload) -> torch.Tensor:
        return payload.nsel

    def saturated(self, payload) -> torch.Tensor:
        return bloom.saturated(payload, self.meta)

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((n_values,), torch.float32), ((self.meta.n_words,), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> bloom.BloomPayload:
        return bloom.BloomPayload(*leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        # filled on the device: a tensor copied from the host would wait for it
        return torch.full((), 64.0 + self.meta.m_bits, dtype=torch.float32, device=payload.words.device)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return payload.nsel.to(torch.float32) * 32


class IntegerCodec(Codec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = integer.IntegerMeta(k=k, d=d)

    @property
    def value_slots(self) -> int:
        return self.k

    def encode(self, sp: SparseGrad, dense: torch.Tensor) -> integer.IntegerPayload:
        return integer.encode(sp, self.meta)

    def decode_dense(self, payload, shape, *, values=None) -> torch.Tensor:
        return integer.decode_dense(payload, self.meta, shape, values=values)

    def selected(self, payload) -> torch.Tensor:
        return payload.nnz

    def saturated(self, payload) -> torch.Tensor:
        # no budget to fill: the selection is the sparsifier's own
        return torch.zeros((), dtype=torch.bool, device=payload.nnz.device)

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((n_values,), torch.float32), ((self.meta.n_words,), i32), ((), i32), ((), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> integer.IntegerPayload:
        return integer.IntegerPayload.from_leaves(leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        return integer.wire_bits(payload, self.meta)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return payload.nnz.to(torch.float32) * 32


class QSGDCodec(Codec):
    # the mapping is the identity and is elided; the wire rows are written
    # by the grouped kernel launch (`TensorCodec.value_segment`)
    order_preserving = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = qsgd.QSGDMeta(
            k=k,
            quantum_num=int(self.params.get("quantum_num", 127)),
            bucket_size=int(self.params.get("bucket_size", 512)),
        )

    def decode(self, payload, shape) -> SparseGrad:
        return qsgd.decode(payload, self.meta, shape)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return qsgd.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        return [((self.meta.payload_len,), torch.int8), ((n_indices,), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> qsgd.QSGDPayload:
        return qsgd.QSGDPayload(*leaves)


class PolyFitCodec(Codec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = polyfit.PolyFitMeta(
            k=k,
            degree=int(self.params.get("poly_degree", 5)),
            sort=bool(self.params.get("sort", False)),
        )

    def encode(self, sp: SparseGrad) -> polyfit.PolyFitPayload:
        return polyfit.encode(sp, self.meta)

    def decode(self, payload, shape) -> SparseGrad:
        return polyfit.decode(payload, self.meta, shape)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return polyfit.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        return [((self.meta.num_segments, self.meta.degree + 1), torch.float32), ((), i32), ((n_indices,), i32)]

    def payload_from_leaves(self, leaves) -> polyfit.PolyFitPayload:
        return polyfit.PolyFitPayload(*leaves)


INDEX_CODECS: Dict[str, type] = {"bloom": BloomCodec, "integer": IntegerCodec}
VALUE_CODECS: Dict[str, type] = {"qsgd": QSGDCodec, "polyfit": PolyFitCodec}


def get_codec(name: str, kind: str) -> type:
    table = INDEX_CODECS if kind == "index" else VALUE_CODECS
    if name not in table:
        raise KeyError(f"unknown or unported {kind} codec {name!r}; have {sorted(table)}")
    return table[name]
