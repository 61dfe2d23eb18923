"""Codec adapters binding static geometry, ported from
`deepreduce_tpu/codecs/registry.py` for the on-device codecs: the bloom,
the delta-bitpacked integer and the run-length index codecs, and the
QSGD, PolyFit, Fit-DExp, PolySeg and count-sketch value codecs.

An index codec's payload carries a value table (`value_slots` long) that
the wrapper's 'both' mode hands to the value codec, and a selected count
(`selected`); `payload_specs` / `payload_from_leaves` give a payload's wire
leaves in the JAX pytree's flatten order. An index codec with
`decodes_dense` places a value table straight into the dense tensor
(`decode_dense`); the others (RLE) decode to a selection list, as in the
JAX package.

A value codec in 'both' mode runs over that table with arange indices. Its
`indices` (the order it put the values in: the `mapping`; the signed
indices shifted by k for Fit-DExp and PolySeg) are stripped by
`strip_for_both`, bit-packed by the wrapper at
ceil(log2(both_mapping_max + 1)) bits and put back by `restore_for_both`
before decode. An order-preserving codec (QSGD, count sketch) elides the
mapping. In value-only mode the indices travel raw: `index_wire_bits` is
32 bits per slot."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepreduce_tpu_torch.codecs import bloom, countsketch, doubleexp, integer, polyfit, polyseg, qsgd, rle
from deepreduce_tpu_torch.sparse import SparseGrad

Specs = List[Tuple[Tuple[int, ...], torch.dtype]]


class Codec:
    """Base adapter: static (k, d) geometry plus encode/decode and the
    split index/value wire accounting."""

    order_preserving: bool = False
    decodes_dense: bool = True  # index codecs: has `decode_dense`

    def __init__(self, k: int, d: int, params: Optional[Dict[str, Any]] = None):
        self.k = k
        self.d = d
        self.params = dict(params or {})

    def index_wire_bits(self, payload) -> torch.Tensor:
        """A value codec in value-only mode: the k indices travel raw."""
        return torch.full((), float(self.k * 32), dtype=torch.float32, device=payload.leaves()[0].device)

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
        self.seed = int(self.params.get("seed", 0))

    @property
    def value_slots(self) -> int:
        return self.meta.budget

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> bloom.BloomPayload:
        return bloom.encode(sp, dense, self.meta, step=step, seed=self.seed, threshold_insert=self.threshold_insert)

    def encode_direct(self, dense: torch.Tensor, *, sample_size: int, undershoot: float) -> bloom.BloomPayload:
        """Sparsifier-free encode (`bloom.encode_dense_direct`): the filter
        is the selection, so no top-k is materialized."""
        return bloom.encode_dense_direct(dense, self.meta, sample_size=sample_size, undershoot=undershoot)

    def decode(self, payload, shape, *, step: int = 0) -> SparseGrad:
        return bloom.decode(payload, self.meta, shape, step=step, seed=self.seed)

    def decode_dense(self, payload, shape, *, step: int = 0, values=None) -> torch.Tensor:
        return bloom.decode_dense(payload, self.meta, shape, step=step, seed=self.seed, values=values)

    def selected(self, payload) -> torch.Tensor:
        return payload.nsel

    def saturated(self, payload) -> torch.Tensor:
        return bloom.saturated(payload, self.meta)

    def fp_stats(self, payload) -> Tuple[torch.Tensor, torch.Tensor]:
        return bloom.fp_stats(payload, self.meta)

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

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> integer.IntegerPayload:
        return integer.encode(sp, self.meta)

    def decode_dense(self, payload, shape, *, step: int = 0, values=None) -> torch.Tensor:
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


class RLECodec(Codec):
    decodes_dense = False

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = rle.RLEMeta(k=k, d=d)

    @property
    def value_slots(self) -> int:
        return self.k

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> rle.RLEPayload:
        return rle.encode(sp, self.meta)

    def decode(self, payload, shape, *, step: int = 0) -> SparseGrad:
        return rle.decode(payload, self.meta, shape)

    def selected(self, payload) -> torch.Tensor:
        return payload.nnz

    def saturated(self, payload) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=payload.nnz.device)

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((n_values,), torch.float32), ((self.meta.n_words,), i32), ((), i32), ((), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> rle.RLEPayload:
        return rle.RLEPayload.from_leaves(leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        return rle.wire_bits(payload, self.meta)

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

    def both_mapping_max(self) -> int:
        return 0

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


class _SignedIndexCodec(Codec):
    """A value codec whose payload carries `signed_indices` ((idx + 1) *
    sign) instead of indices: in 'both' mode they travel as the mapping,
    shifted by k into [0, 2k]."""

    def both_mapping_max(self) -> int:
        return 2 * self.k

    def strip_for_both(self, payload):
        empty = torch.zeros(0, dtype=torch.int32, device=payload.signed_indices.device)
        mapping = payload.signed_indices.to(torch.int64) + self.k
        return dataclasses.replace(payload, signed_indices=empty), mapping, self.both_mapping_max()

    def restore_for_both(self, stripped, mapping: Optional[torch.Tensor]):
        if mapping is None:
            signed = torch.arange(1, self.k + 1, dtype=torch.int32, device=stripped.signed_indices.device)
        else:
            signed = (mapping - self.k).to(torch.int32)
        return dataclasses.replace(stripped, signed_indices=signed)


class DoubleExpCodec(_SignedIndexCodec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = doubleexp.DoubleExpMeta(k=k)

    def encode(self, sp: SparseGrad) -> doubleexp.DoubleExpPayload:
        return doubleexp.encode(sp, self.meta)

    def decode(self, payload, shape) -> SparseGrad:
        return doubleexp.decode(payload, self.meta, shape)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return doubleexp.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        return [((4,), torch.float32), ((n_indices,), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> doubleexp.DoubleExpPayload:
        return doubleexp.DoubleExpPayload(*leaves)


class PolySegCodec(_SignedIndexCodec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = polyseg.PolySegMeta(k=k, degree=int(self.params.get("poly_degree", 5)))

    def encode(self, sp: SparseGrad) -> polyseg.PolySegPayload:
        return polyseg.encode(sp, self.meta)

    def decode(self, payload, shape) -> SparseGrad:
        return polyseg.decode(payload, self.meta, shape)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return polyseg.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        s = self.meta.segments
        return [((s, self.meta.degree + 1), torch.float32), ((s + 1,), i32), ((n_indices,), i32)]

    def payload_from_leaves(self, leaves) -> polyseg.PolySegPayload:
        return polyseg.PolySegPayload(*leaves)


class CountSketchCodec(Codec):
    """Summable and order-preserving (the mapping is elided). The table has
    the JAX package's default geometry: 5 rows of max(256, ceil(2k / 5))
    columns."""

    order_preserving = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        rows = 5
        cols = max(256, -(-2 * k // rows))
        self.meta = countsketch.CountSketchMeta(k=k, rows=rows, cols=cols, seed=int(self.params.get("seed", 0)))

    def both_mapping_max(self) -> int:
        return 0

    def encode(self, sp: SparseGrad) -> countsketch.CountSketchPayload:
        return countsketch.encode(sp, self.meta)

    def decode(self, payload, shape) -> SparseGrad:
        return countsketch.decode(payload, self.meta, shape)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return countsketch.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        return [((self.meta.rows, self.meta.cols), torch.float32), ((n_indices,), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> countsketch.CountSketchPayload:
        return countsketch.CountSketchPayload(*leaves)


INDEX_CODECS: Dict[str, type] = {"bloom": BloomCodec, "integer": IntegerCodec, "rle": RLECodec}
VALUE_CODECS: Dict[str, type] = {
    "qsgd": QSGDCodec,
    "polyfit": PolyFitCodec,
    "doubleexp": DoubleExpCodec,
    "polyseg": PolySegCodec,
    "countsketch": CountSketchCodec,
}


def get_codec(name: str, kind: str) -> type:
    table = INDEX_CODECS if kind == "index" else VALUE_CODECS
    if name not in table:
        raise KeyError(f"unknown or unported {kind} codec {name!r}; have {sorted(table)}")
    return table[name]
