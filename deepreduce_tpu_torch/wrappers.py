"""Composition layer: the DeepReduce wrapper over a sparsifier, ported
from `deepreduce_tpu/wrappers.py` for `deepreduce in (None, 'index', 'both')`.

- Sparsifiers: exact `topk`, sampled `topk_sampled`, and `none` (every
  element; such a leaf is never sparsified and ships dense).
- A tensor with at most `min_compress_size` elements (default 1000) is
  sparsified but not codec-compressed: its wire payload is the sparse
  (values, indices, nnz) triple. On the full-width WordLSTM the five biases
  of width 670 and 96 take this path.
- `dense_fallback`: an uncompressed tensor that is never sparsified
  (compressor 'none') or whose sparse pair would cost at least the raw
  tensor (k*64 >= d*32 bits) ships the raw tensor instead.
- `'index'`: the index codec's payload alone (bloom: the FP-aware values
  re-read from the dense tensor; integer: the values in ascending-index
  order).
- `'both'`: the index codec first, then the value codec over its value
  table with arange indices. The value codec's slot count is the index
  codec's `value_slots` (bloom: its budget; integer: k), and the selected
  count is the index payload's. QSGD preserves order, so its mapping is
  elided, and its wire rows are written by the fused kernel
  (`ops.qsgd_encode_rows`; the exchange groups every leaf of a step into
  one launch). PolyFit reorders the values: the order it put them in (the
  `mapping`) is bit-packed at ceil(log2 k) bits (`codecs.packing`), and
  decode puts the evaluated values back in slot order before the index
  codec places them.
- `direct_bloom`: sampled top-k with the threshold insert under a prefix
  policy builds the bloom filter straight from the dense tensor
  (`bloom.encode_dense_direct`); no top-k runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from deepreduce_tpu_torch import sparse
from deepreduce_tpu_torch.codecs import packing, polyfit, qsgd
from deepreduce_tpu_torch.codecs.registry import get_codec
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.ops import EncodeSegment, qsgd_encode_rows
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class DensePayload:
    """Raw-tensor payload of an uncompressed leaf that is never sparsified
    or whose sparse pair would cost at least the raw tensor."""

    tensor: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.tensor,)


@dataclasses.dataclass(frozen=True)
class BothPayload:
    """'both' wire format: index payload (values stripped), value payload
    (indices stripped), the packed mapping (None, and no leaf, when the
    value codec preserves order) and the selected count."""

    index_payload: Any
    value_payload: Any
    mapping: Optional[packing.PackedInts]
    nsel: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        mapping = () if self.mapping is None else self.mapping.leaves()
        return self.index_payload.leaves() + self.value_payload.leaves() + mapping + (self.nsel,)


class TensorCodec:
    """Per-tensor compressor bound to a static shape and a device."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        cfg: DeepReduceConfig,
        name: str = "",
        *,
        slots: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        """`slots` overrides the k = num_slots(d, ratio) budget of the
        sparsifier and the index codec: the bucketed exchange passes the sum
        of its member leaves' budgets (`sparse.bucket_num_slots`). Ignored
        for compressor='none' (k is the whole tensor)."""
        self.device = resolve_device(device)
        self.shape = tuple(int(s) for s in shape)
        self.cfg = cfg
        self.name = name
        self.d = int(math.prod(self.shape)) if self.shape else 1
        min_size = 1000 if cfg.min_compress_size is None else cfg.min_compress_size
        self.compressed = cfg.deepreduce is not None and self.d > min_size
        if cfg.compressor == "none":
            self.k = self.d
        elif slots is not None:
            self.k = int(slots)
        else:
            self.k = sparse.num_slots(self.d, cfg.compress_ratio)
        if self.k > self.d:
            raise ValueError(f"slot budget k={self.k} exceeds the tensor size d={self.d}")
        if (
            cfg.bloom_threshold_insert
            and cfg.index == "bloom"
            and cfg.deepreduce in ("index", "both")
            and cfg.compressor not in ("topk", "topk_sampled")
        ):
            raise ValueError(
                "bloom_threshold_insert rebuilds the selection as a magnitude "
                f"threshold — incompatible with compressor={cfg.compressor!r} "
                "(its selection is not a magnitude set); use topk or topk_sampled"
            )
        params = cfg.codec_params()
        self.idx_codec = None
        self.val_codec = None
        # index of the QSGD wire rows among a 'both' payload's leaves
        self.rows_leaf: Optional[int] = None
        # bits per mapping entry of a reordering value codec
        self.map_width: Optional[int] = None
        if self.compressed:
            self.idx_codec = get_codec(cfg.index, "index")(self.k, self.d, params)
            if cfg.deepreduce == "both":
                # the value codec sees the index codec's value table
                self.val_codec = get_codec(cfg.value, "value")(self.idx_codec.value_slots, self.d, params)
                if cfg.value == "qsgd":
                    self.rows_leaf = len(self.idx_codec.payload_specs(0))
                if not self.val_codec.order_preserving:
                    self.map_width = max(1, math.ceil(math.log2(max(2, self.val_codec.both_mapping_max() + 1))))
                if cfg.value == "polyfit":
                    polyfit.ratios_on(self.device)  # its one host copy, outside every step
        self.dense_fallback = not self.compressed and (cfg.compressor == "none" or self.k * 64 >= self.d * 32)
        # the sparsifier-free route: spelled out in full, as in the JAX
        # package, rather than relying on a constructor to reject the rest
        self.direct_bloom = (
            self.compressed
            and cfg.index == "bloom"
            and cfg.compressor == "topk_sampled"
            and cfg.bloom_threshold_insert
            and cfg.bloom_blocked == "mod"
            and cfg.policy in ("leftmost", "p0")
        )

    def sparsify(self, tensor: torch.Tensor) -> SparseGrad:
        cfg = self.cfg
        if cfg.compressor == "topk":
            return sparse.topk(tensor, cfg.compress_ratio, k=self.k)
        if cfg.compressor == "topk_sampled":
            return sparse.topk_sampled(
                tensor, cfg.compress_ratio, sample_size=cfg.topk_sample_size,
                undershoot=cfg.topk_undershoot, k=self.k,
            )
        return sparse.none_sparsifier(tensor)

    # ------------------------------------------------------------------ #

    def encode(
        self,
        tensor: torch.Tensor,
        *,
        step: int = 0,
        worker: int = 0,
        uniforms: Optional[torch.Tensor] = None,
    ) -> Any:
        """tensor -> payload: the index stage, then in 'both' mode the value
        stage: a one-segment fused QSGD encode, or `encode_values`.
        `uniforms` (CPU only) replaces the QSGD Philox draws; see
        `codecs.qsgd.encode`."""
        ipay = self.encode_index(tensor)
        if self.val_codec is None:
            return ipay
        if self.rows_leaf is None:
            return self.encode_values(ipay)
        data = torch.empty(self.val_codec.meta.payload_len, dtype=torch.int8, device=tensor.device)
        seg = self.value_segment(ipay, 0, step=step, worker=worker, uniforms=uniforms)
        meta = self.val_codec.meta
        qsgd_encode_rows([seg], data, quantum_num=meta.quantum_num, bucket_size=meta.bucket_size, device=self.device)
        return self.both_payload(ipay, data)

    def encode_index(self, tensor: torch.Tensor) -> Any:
        """The index stage. A compressed leaf gives its index codec's payload
        (the sparsifier then the codec, or the direct bloom encode), whose
        value table the value stage quantizes in 'both' mode; any other leaf
        gives its whole payload."""
        check_on(tensor, self.device, f"tensor {self.name!r}")
        if self.dense_fallback:
            return DensePayload(tensor=tensor)
        if self.direct_bloom:
            cfg = self.cfg
            return self.idx_codec.encode_direct(
                tensor, sample_size=cfg.topk_sample_size, undershoot=cfg.topk_undershoot
            )
        sp = self.sparsify(tensor)
        if not self.compressed:
            return sp
        return self.idx_codec.encode(sp, dense=tensor)

    def encode_values(self, ipay: Any) -> BothPayload:
        """The value stage of a reordering value codec (PolyFit): encode the
        index payload's value table with arange indices, strip the order it
        chose and bit-pack it as the mapping."""
        vals = ipay.values
        dev = vals.device
        vk = vals.shape[0]
        nsel = self.idx_codec.selected(ipay)
        inner = SparseGrad(values=vals, indices=torch.arange(vk, dtype=torch.int32, device=dev), nnz=nsel, shape=(vk,))
        vpay, mapping, _ = self.val_codec.strip_for_both(self.val_codec.encode(inner))
        width = torch.full((), self.map_width, dtype=torch.int32, device=dev)
        return BothPayload(
            index_payload=dataclasses.replace(ipay, values=torch.zeros(0, dtype=torch.float32, device=dev)),
            value_payload=vpay,
            mapping=packing.pack(mapping, width, max_width=self.map_width),
            nsel=nsel,
        )

    def value_segment(
        self,
        ipay: Any,
        out_offset: int,
        *,
        step: int,
        worker: int,
        uniforms: Optional[torch.Tensor] = None,
    ) -> EncodeSegment:
        """The value stage of a compressed leaf as one segment of a fused
        QSGD encode: the index stage's values, the wire rows' byte offset in
        the caller's buffer, and this leaf's Philox stream at (step, worker)."""
        seed, offset = sparse.per_tensor_stream(self.cfg.seed, self.name, step, worker)
        return EncodeSegment(values=ipay.values, out_offset=out_offset, seed=seed, offset=offset, uniforms=uniforms)

    def both_payload(self, ipay: Any, data: torch.Tensor) -> BothPayload:
        """The 'both' payload from the index stage and the QSGD wire rows
        (int8[payload_len]); the value payload's indices are stripped, since
        QSGD preserves order and the mapping is elided."""
        empty = torch.zeros(0, dtype=torch.float32, device=data.device)
        nsel = self.idx_codec.selected(ipay)
        return BothPayload(
            index_payload=dataclasses.replace(ipay, values=empty),
            value_payload=qsgd.QSGDPayload(
                data=data, indices=torch.zeros(0, dtype=torch.int32, device=data.device), nnz=nsel
            ),
            mapping=None,
            nsel=nsel,
        )

    def decode(self, payload: Any) -> torch.Tensor:
        """payload -> dense tensor."""
        if self.dense_fallback:
            return payload.tensor.reshape(self.shape)
        if not self.compressed:
            return payload.to_dense()
        if self.val_codec is None:
            return self.idx_codec.decode_dense(payload, self.shape)
        vk = self.val_codec.k
        mapping = None if payload.mapping is None else packing.unpack(payload.mapping, vk)
        vpay = self.val_codec.restore_for_both(payload.value_payload, mapping)
        vsp = self.val_codec.decode(vpay, self.shape)  # values in the codec's order
        table = vsp.values
        if mapping is not None:
            # the slot-ordered table: value i goes to slot indices[i]; a
            # target out of range is dropped, not clipped onto a live slot
            slots = torch.arange(vk, device=table.device)
            idx = vsp.indices.long()
            tgt = torch.where((idx >= 0) & (idx < vk), idx, vk + slots)
            out = torch.zeros(2 * vk, dtype=table.dtype, device=table.device)
            out[tgt] = table
            table = out[:vk]
        return self.idx_codec.decode_dense(payload.index_payload, self.shape, values=table)

    # -- the static wire layout ----------------------------------------- #

    def payload_specs(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each payload leaf, in the JAX pytree's flatten
        order — what the fused buffer's byte layout is built from."""
        i32 = torch.int32
        if self.dense_fallback:
            return [(self.shape, torch.float32)]
        if not self.compressed:
            return [((self.k,), torch.float32), ((self.k,), i32), ((), i32)]
        if self.val_codec is None:
            return self.idx_codec.payload_specs(self.idx_codec.value_slots)
        specs = self.idx_codec.payload_specs(0) + self.val_codec.payload_specs(0)
        if self.map_width is not None:
            words = packing.budget_words(self.val_codec.k, self.map_width)
            specs += [((words,), i32), ((), i32), ((), i32)]
        return specs + [((), i32)]

    def payload_from_leaves(self, leaves: List[torch.Tensor]) -> Any:
        if self.dense_fallback:
            return DensePayload(tensor=leaves[0])
        if not self.compressed:
            return SparseGrad(values=leaves[0], indices=leaves[1], nnz=leaves[2], shape=self.shape)
        if self.val_codec is None:
            return self.idx_codec.payload_from_leaves(leaves)
        r = len(self.idx_codec.payload_specs(0))
        return BothPayload(
            index_payload=self.idx_codec.payload_from_leaves(leaves[:r]),
            value_payload=self.val_codec.payload_from_leaves(leaves[r : r + 3]),
            mapping=None if self.map_width is None else packing.PackedInts(*leaves[r + 3 : r + 6]),
            nsel=leaves[-1],
        )

    # ------------------------------------------------------------------ #

    def wire_stats(self, payload: Any) -> WireStats:
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        # static counts are filled on the device: a tensor copied from the
        # host would wait for the device's queue to drain
        dense_bits = torch.full((), float(self.d * 32), **f32)
        saturated = torch.zeros((), **f32)
        if self.dense_fallback:
            idx_bits = torch.zeros((), **f32)
            val_bits = dense_bits
        elif not self.compressed:
            nnz = payload.nnz.to(torch.float32)
            idx_bits = nnz * 32
            val_bits = nnz * 32
        else:
            ipay = payload if self.val_codec is None else payload.index_payload
            idx_bits = self.idx_codec.index_wire_bits(ipay).to(torch.float32)
            if self.val_codec is None:
                val_bits = self.idx_codec.value_wire_bits(ipay)
            else:
                if payload.mapping is not None:
                    idx_bits = idx_bits + packing.wire_bits(payload.mapping).to(torch.float32)
                val_bits = self.val_codec.value_wire_bits(payload.value_payload)
            saturated = self.idx_codec.saturated(ipay).to(torch.float32)
        return WireStats(
            index_bits=idx_bits, value_bits=val_bits, dense_bits=dense_bits, saturated=saturated
        )
