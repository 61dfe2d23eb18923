"""Codec adapters binding static geometry, ported from
`deepreduce_tpu/codecs/registry.py`: the on-device codecs (the bloom, the
delta-bitpacked integer and the run-length index codecs, and the QSGD,
PolyFit, Fit-DExp, PolySeg and count-sketch value codecs) and the host
codecs (the Huffman index, the C++ library's bloom and integer-family
indices, and the Deflate and searched-knot PolyFit value codecs; their
`host` flag is set, and their decode takes the payload's leaves already
copied to the host, `host_payload`, where the caller has them).

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

import numpy as np
import torch

from deepreduce_tpu_torch import native
from deepreduce_tpu_torch.codecs import (
    bloom,
    bloom_native,
    countsketch,
    doubleexp,
    gzip_codec,
    host,
    huffman,
    integer,
    polyfit,
    polyfit_host,
    polyseg,
    qsgd,
    rle,
)
from deepreduce_tpu_torch.sparse import SparseGrad

Specs = List[Tuple[Tuple[int, ...], torch.dtype]]


class Codec:
    """Base adapter: static (k, d) geometry plus encode/decode and the
    split index/value wire accounting."""

    order_preserving: bool = False
    # False marks a codec whose meaningful size varies per worker (the
    # reference's tensors_size_are_same contract); every payload is static
    fixed_size: bool = True
    decodes_dense: bool = True  # index codecs: has `decode_dense`
    host: bool = False  # encodes and decodes on the host (`codecs.host`)

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
    fixed_size = False

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
    fixed_size = False

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


class HuffmanCodec(Codec):
    """The canonical Huffman index over the indices' int32 bytes (host)."""

    order_preserving = True
    fixed_size = False
    decodes_dense = False
    host = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = huffman.HuffmanMeta(k=k, d=d)

    @property
    def value_slots(self) -> int:
        return self.k

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> huffman.HuffmanPayload:
        return huffman.encode(sp, self.meta)

    def decode(self, payload, shape, *, step: int = 0, host_payload=None) -> SparseGrad:
        return huffman.decode(payload, self.meta, shape, host_payload)

    def selected(self, payload) -> torch.Tensor:
        return payload.nnz

    def saturated(self, payload) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=payload.nnz.device)

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((n_values,), torch.float32), ((self.meta.budget_bytes,), torch.uint8), ((), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> huffman.HuffmanPayload:
        return huffman.HuffmanPayload(*leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        return huffman.wire_bits(payload, self.meta)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return payload.nnz.to(torch.float32) * 32


class BloomNativeCodec(Codec):
    """The C++ library's bloom index (`codecs.bloom_native`, host), the only
    route to the exact P2 policy `conflict_sets`. Index-only: its wire
    carries the values in band, so a value codec on top would send them
    twice."""

    fixed_size = False  # the live wire length rides the in-band nbytes word
    decodes_dense = False
    host = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = bloom_native.BloomNativeMeta.create(
            k, d, fpr=self.params.get("fpr"), policy=self.params.get("policy", "leftmost")
        )

    @property
    def value_slots(self) -> int:
        return self.meta.budget

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> bloom_native.BloomNativePayload:
        return bloom_native.encode(sp, dense, self.meta, step=step)

    def decode(self, payload, shape, *, step: int = 0, host_payload=None) -> SparseGrad:
        return bloom_native.decode(payload, self.meta, shape, step=step, host_payload=host_payload)

    def selected(self, payload) -> torch.Tensor:
        return payload.nsel

    def saturated(self, payload) -> torch.Tensor:
        return payload.nsel >= self.meta.budget

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((self.meta.wire_budget,), torch.int8), ((), i32), ((n_values,), torch.float32), ((), i32)]

    def payload_from_leaves(self, leaves) -> bloom_native.BloomNativePayload:
        return bloom_native.BloomNativePayload(*leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        # the wire minus its embedded values: header and bit-array
        return bloom_native.wire_bits(payload, self.meta) - self.value_wire_bits(payload)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return payload.nsel.to(torch.float32) * 32

    def strip_for_both(self, payload):
        raise NotImplementedError(
            "bloom_native is index-mode only: its C++ wire format already carries the values in band"
        )


@dataclasses.dataclass(frozen=True)
class IntegerNativePayload:
    values: torch.Tensor  # f32[k] in ascending-index order; f32[0] in 'both' mode
    wire: torch.Tensor  # int32[budget_words]: the named codec's uint32 words, zero-padded
    nwords: torch.Tensor  # i32[]: the live wire words
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.values, self.wire, self.nwords, self.nnz)


class IntegerNativeCodec(Codec):
    """The C++ FastPFor-role integer family behind name-keyed selection (the
    reference's IntegerCompressorOp with its string attr `code`,
    integer_compression.cc:20-42,62): `fbp` (frame bit packing), `varint`
    (VByte) or `pfor` (PFor128 with patched exceptions), over the indices
    sorted ascending on the host (host), into the family's worst-case word
    budget with the live word count in band."""

    fixed_size = False
    decodes_dense = False
    host = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.code = str(self.params.get("code", "fbp"))
        if self.code not in native.INT_CODEC_NAMES:
            raise KeyError(f"unknown integer codec {self.code!r}; have {native.INT_CODEC_NAMES}")
        self.budget_words = native.int_cap_words(k)

    @property
    def value_slots(self) -> int:
        return self.k

    def encode(self, sp: SparseGrad, dense: torch.Tensor, *, step: int = 0) -> IntegerNativePayload:
        dev = sp.values.device
        with host.span(f"integer_native.{self.code}.encode"):
            idx, vals = host.to_host(sp.indices), host.to_host(sp.values)
            n = int(host.to_host(sp.nnz))
            enc, _ = native.int_codec_from_name(self.code)
            order = np.argsort(idx[:n], kind="stable")
            words = enc(idx[:n][order])
            out_w = np.zeros(self.budget_words, np.uint32)
            out_w[: len(words)] = words
            out_v = np.zeros(self.k, np.float32)
            out_v[:n] = vals[:n][order]
        return IntegerNativePayload(values=host.to_device(out_v, dev), wire=host.to_device(out_w, dev),
                                    nwords=host.scalar(len(words), dev), nnz=sp.nnz)

    def decode(self, payload, shape, *, step: int = 0, host_payload=None) -> SparseGrad:
        dev = payload.wire.device
        with host.span(f"integer_native.{self.code}.decode"):
            src = payload if host_payload is None else host_payload
            wire, nwords, nnz = (host.to_host(t) for t in (src.wire, src.nwords, src.nnz))
            _, dec = native.int_codec_from_name(self.code)
            idx = dec(wire.view(np.uint32)[: int(nwords)], int(nnz))
            out = np.zeros(self.k, np.int32)
            out[: len(idx)] = idx.astype(np.int32)
        live = torch.arange(self.k, device=dev) < payload.nnz
        return SparseGrad(
            values=torch.where(live, payload.values, 0.0),
            indices=torch.where(live, host.to_device(out, dev), 0),
            nnz=payload.nnz,
            shape=shape,
        )

    def selected(self, payload) -> torch.Tensor:
        return payload.nnz

    def saturated(self, payload) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=payload.nnz.device)

    def payload_specs(self, n_values: int) -> Specs:
        i32 = torch.int32
        return [((n_values,), torch.float32), ((self.budget_words,), i32), ((), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> IntegerNativePayload:
        return IntegerNativePayload(*leaves)

    def index_wire_bits(self, payload) -> torch.Tensor:
        return payload.nwords.to(torch.float32) * 32

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


class GzipCodec(Codec):
    """Deflate over the float32 values (host); order-preserving, so 'both'
    mode elides the mapping."""

    order_preserving = True
    fixed_size = False
    host = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = gzip_codec.GzipMeta(k=k)

    def both_mapping_max(self) -> int:
        return 0

    def encode(self, sp: SparseGrad) -> gzip_codec.GzipPayload:
        return gzip_codec.encode(sp, self.meta)

    def decode(self, payload, shape, host_payload=None) -> SparseGrad:
        return gzip_codec.decode(payload, self.meta, shape, host_payload)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return gzip_codec.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        return [((self.meta.budget_bytes,), torch.uint8), ((), i32), ((n_indices,), i32), ((), i32)]

    def payload_from_leaves(self, leaves) -> gzip_codec.GzipPayload:
        return gzip_codec.GzipPayload(*leaves)


class PolyFitHostCodec(Codec):
    """The reference's PolyFitCPU (host): searched knots, transmitted
    breaks; in 'both' mode its value-sorted order is the mapping."""

    fixed_size = False  # the break count varies (the reference returns a tuple)
    host = True

    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = polyfit_host.PolyFitHostMeta(k=k, degree=int(self.params.get("poly_degree", 5)))

    def encode(self, sp: SparseGrad) -> polyfit_host.PolyFitHostPayload:
        return polyfit_host.encode(sp, self.meta)

    def decode(self, payload, shape, host_payload=None) -> SparseGrad:
        return polyfit_host.decode(payload, self.meta, shape, host_payload)

    def value_wire_bits(self, payload) -> torch.Tensor:
        return polyfit_host.wire_bits(payload, self.meta)

    def payload_specs(self, n_indices: int) -> Specs:
        i32 = torch.int32
        s = self.meta.max_segments
        return [((s, self.meta.degree + 1), torch.float32), ((s + 1,), i32), ((), i32), ((n_indices,), i32)]

    def payload_from_leaves(self, leaves) -> polyfit_host.PolyFitHostPayload:
        return polyfit_host.PolyFitHostPayload(*leaves)


INDEX_CODECS: Dict[str, type] = {
    "bloom": BloomCodec,
    "bloom_native": BloomNativeCodec,
    "integer_native": IntegerNativeCodec,
    "rle": RLECodec,
    "integer": IntegerCodec,
    "huffman": HuffmanCodec,
}
VALUE_CODECS: Dict[str, type] = {
    "polyfit": PolyFitCodec,
    "polyfit_host": PolyFitHostCodec,
    "polyseg": PolySegCodec,
    "doubleexp": DoubleExpCodec,
    "qsgd": QSGDCodec,
    "gzip": GzipCodec,
    "countsketch": CountSketchCodec,
}


def get_codec(name: str, kind: str) -> type:
    table = INDEX_CODECS if kind == "index" else VALUE_CODECS
    if name not in table:
        raise KeyError(f"unknown {kind} codec {name!r}; have {sorted(table)}")
    return table[name]
