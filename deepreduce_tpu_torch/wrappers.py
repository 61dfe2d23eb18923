"""Composition layer: the DeepReduce wrapper over a sparsifier, ported
from `deepreduce_tpu/wrappers.py`.

- Sparsifiers: exact `topk`, sampled `topk_sampled`, `randomk` (priorities
  from the leaf's Philox stream at (step, worker), the stream its QSGD
  values draw from too, as the JAX package shares one key between them),
  the magnitude `threshold` (`threshold_val`; 0.0 keeps the nonzeros) and
  `none` (every element; such a leaf is never sparsified and ships dense).
- A tensor with at most `min_compress_size` elements (default 1000, 9000
  for the Fit-DExp value codec) is sparsified but not codec-compressed: its
  wire payload is the sparse (values, indices, nnz) triple. On the
  full-width WordLSTM the five biases of width 670 and 96 take this path.
  A tensor whose name `layer_pattern` does not match (default '(?i)conv'
  for PolySeg) ships dense, not even sparsified.
- `dense_fallback`: an uncompressed tensor that is never sparsified
  (compressor 'none', or excluded by the pattern) or whose sparse pair
  would cost at least the raw tensor (k*64 >= d*32 bits) ships the raw
  tensor instead.
- `'value'`: the value codec over the sparsifier's output; the indices
  travel raw in its payload. QSGD's wire rows are written by the fused
  kernel, grouped with every other leaf of the step as in 'both'.
- `'index'`: the index codec's payload alone (bloom: the FP-aware values
  re-read from the dense tensor; integer and RLE: the values in
  ascending-index order).
- `'both'`: the index codec first, then the value codec over its value
  table with arange indices. The value codec's slot count is the index
  codec's `value_slots` (bloom: its budget; integer and RLE: k), and the
  selected count is the index payload's. QSGD and the count sketch
  preserve order, so their mapping is elided; QSGD's wire rows are written
  by the fused kernel (`ops.qsgd_encode_rows`; the exchange groups every
  leaf of a step into one launch). A reordering codec (PolyFit, Fit-DExp,
  PolySeg) has its order (the `mapping`) bit-packed at
  ceil(log2(both_mapping_max + 1)) bits (`codecs.packing`), and decode puts
  the evaluated values back in slot order before the index codec places
  them.
- `direct_bloom`: sampled top-k with the threshold insert under a prefix
  policy builds the bloom filter straight from the dense tensor
  (`bloom.encode_dense_direct`); no top-k runs.

The bloom codec's random policies are keyed by `step` (encode and decode
alike), the stochastic sparsifier and QSGD by (step, worker).

The host codecs (Huffman, the C++ library's bloom and integer family,
Deflate, the searched-knot PolyFit; `codecs.host`) take the same place in
these modes: the selection stays on the device, the codec copies to the
host the tensors the JAX package's `pure_callback` receives, and its
static-shape payload returns to the device. `decode` takes the payload's
leaves already on the host (`host_payload`, the exchange's one copy of a
gathered row); without them a host codec copies what it reads.
`micro_benchmark` is the reference's 'micro-benchmark' mode.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deepreduce_tpu_torch import sparse
from deepreduce_tpu_torch.codecs import packing, polyfit, qsgd
from deepreduce_tpu_torch.codecs.registry import get_codec
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.ops import EncodeSegment, qsgd_encode_rows
from deepreduce_tpu_torch.sparse import SparseGrad
from deepreduce_tpu_torch.telemetry.spans import span

EncodeUnit = Tuple[Any, "TensorCodec", torch.Tensor, int]


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
        # the per-codec gates, when their knobs are left unset: Fit-DExp
        # compresses only above 9000 elements, PolySeg only conv layers
        uses_value = cfg.deepreduce in ("value", "both")
        min_size = cfg.min_compress_size
        if min_size is None:
            min_size = 9000 if uses_value and cfg.value == "doubleexp" else 1000
        pattern = cfg.layer_pattern
        if uses_value and cfg.value == "polyseg" and pattern is None:
            pattern = r"(?i)conv"
        self.min_compress_size = min_size
        self.layer_pattern = pattern
        self.pattern_excluded = pattern is not None and re.search(pattern, name) is None
        self.compressed = cfg.deepreduce is not None and self.d > min_size and not self.pattern_excluded
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
            and cfg.compressor not in ("topk", "topk_sampled", "threshold")
        ):
            raise ValueError(
                "bloom_threshold_insert rebuilds the selection as a magnitude "
                f"threshold — incompatible with compressor={cfg.compressor!r} "
                "(randomk/none selections are not magnitude sets); use topk, topk_sampled or threshold"
            )
        params = cfg.codec_params()
        self.idx_codec = None
        self.val_codec = None
        # index of the QSGD wire rows among a compressed payload's leaves
        self.rows_leaf: Optional[int] = None
        # bits per mapping entry of a reordering value codec in 'both' mode
        self.map_width: Optional[int] = None
        if self.compressed:
            if cfg.deepreduce in ("index", "both"):
                self.idx_codec = get_codec(cfg.index, "index")(self.k, self.d, params)
            if cfg.deepreduce == "value":
                self.val_codec = get_codec(cfg.value, "value")(self.k, self.d, params)
                if cfg.value == "qsgd":
                    self.rows_leaf = 0
            elif cfg.deepreduce == "both":
                # the value codec sees the index codec's value table
                self.val_codec = get_codec(cfg.value, "value")(self.idx_codec.value_slots, self.d, params)
                if cfg.value == "qsgd":
                    self.rows_leaf = len(self.idx_codec.payload_specs(0))
                if not self.val_codec.order_preserving:
                    self.map_width = max(1, math.ceil(math.log2(max(2, self.val_codec.both_mapping_max() + 1))))
            if cfg.value == "polyfit" and self.val_codec is not None:
                polyfit.ratios_on(self.device)  # its one host copy, outside every step
        never_sparse = cfg.compressor == "none" or self.pattern_excluded
        self.dense_fallback = not self.compressed and (never_sparse or self.k * 64 >= self.d * 32)
        # the sparsifier-free route: spelled out in full, as in the JAX
        # package, rather than relying on a constructor to reject the rest
        self.direct_bloom = (
            self.compressed
            and cfg.deepreduce in ("index", "both")
            and cfg.index == "bloom"
            and cfg.compressor == "topk_sampled"
            and cfg.bloom_threshold_insert
            and cfg.bloom_blocked == "mod"
            and cfg.policy in ("leftmost", "p0")
        )

    def sparsify(
        self, tensor: torch.Tensor, *, step: int = 0, worker: int = 0, uniforms: Optional[torch.Tensor] = None
    ) -> SparseGrad:
        """The configured sparsifier at k slots. `uniforms` (CPU only)
        replaces random-k's priorities (the parity tests' hook)."""
        cfg = self.cfg
        if self.pattern_excluded or cfg.compressor == "none":
            return sparse.none_sparsifier(tensor)
        if cfg.compressor == "topk":
            return sparse.topk(tensor, cfg.compress_ratio, approx=cfg.approx_topk, k=self.k)
        if cfg.compressor == "topk_sampled":
            return sparse.topk_sampled(
                tensor, cfg.compress_ratio, sample_size=cfg.topk_sample_size,
                undershoot=cfg.topk_undershoot, k=self.k,
            )
        if cfg.compressor == "randomk":
            stream = sparse.per_tensor_stream(cfg.seed, self.name, step, worker)
            return sparse.randomk(tensor, cfg.compress_ratio, stream, k=self.k, uniforms=uniforms)
        return sparse.threshold(tensor, cfg.threshold_val, budget_ratio=cfg.compress_ratio, k=self.k)

    # ------------------------------------------------------------------ #

    def encode(
        self,
        tensor: torch.Tensor,
        *,
        step: int = 0,
        worker: int = 0,
        uniforms: Optional[torch.Tensor] = None,
    ) -> Any:
        """tensor -> payload: the index stage, then the value stage in
        'value' and 'both' mode: a one-segment fused QSGD encode, or
        `encode_values`. `uniforms` (CPU only) replaces the QSGD Philox
        draws; see `codecs.qsgd.encode`."""
        rows = None
        if self.rows_leaf is not None:
            rows = torch.empty(self.val_codec.meta.payload_len, dtype=torch.int8, device=tensor.device)
        payloads, _ = encode_group([(0, self, tensor, 0)], rows, step=step, worker=worker,
                                   uniforms=None if uniforms is None else {0: uniforms})
        return payloads[0]

    def encode_index(self, tensor: torch.Tensor, *, step: int = 0, worker: int = 0) -> Any:
        """The index stage. A compressed leaf gives its index codec's payload
        (the sparsifier then the codec, or the direct bloom encode), whose
        value table the value stage encodes in 'both' mode, or in 'value'
        mode the sparsifier's output; any other leaf gives its whole
        payload."""
        check_on(tensor, self.device, f"tensor {self.name!r}")
        if self.dense_fallback:
            return DensePayload(tensor=tensor)
        if self.direct_bloom:
            cfg = self.cfg
            with span("exchange/encode/index"):
                return self.idx_codec.encode_direct(
                    tensor, sample_size=cfg.topk_sample_size, undershoot=cfg.topk_undershoot
                )
        with span("exchange/encode/sparsify"):
            sp = self.sparsify(tensor, step=step, worker=worker)
        if not self.compressed or self.idx_codec is None:
            return sp
        with span("exchange/encode/index"):
            return self.idx_codec.encode(sp, dense=tensor, step=step)

    def encode_values(self, ipay: Any) -> Any:
        """The value stage of a value codec other than QSGD. In 'value' mode
        its payload over the sparsifier's output. In 'both' mode the index
        payload's value table with arange indices, the order the codec chose
        stripped and bit-packed as the mapping (none for an
        order-preserving codec)."""
        if self.idx_codec is None:
            return self.val_codec.encode(ipay)
        vals = ipay.values
        dev = vals.device
        vk = vals.shape[0]
        nsel = self.idx_codec.selected(ipay)
        inner = SparseGrad(values=vals, indices=torch.arange(vk, dtype=torch.int32, device=dev), nnz=nsel, shape=(vk,))
        vpay, mapping, _ = self.val_codec.strip_for_both(self.val_codec.encode(inner))
        packed = None
        if self.map_width is not None:
            width = torch.full((), self.map_width, dtype=torch.int32, device=dev)
            packed = packing.pack(mapping, width, max_width=self.map_width)
        return BothPayload(
            index_payload=dataclasses.replace(ipay, values=torch.zeros(0, dtype=torch.float32, device=dev)),
            value_payload=vpay,
            mapping=packed,
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
        """The QSGD value stage of a compressed leaf as one segment of a
        fused encode: the index stage's values (the sparsifier's in 'value'
        mode), the wire rows' byte offset in the caller's buffer, and this
        leaf's Philox stream at (step, worker)."""
        seed, offset = sparse.per_tensor_stream(self.cfg.seed, self.name, step, worker)
        return EncodeSegment(values=ipay.values, out_offset=out_offset, seed=seed, offset=offset, uniforms=uniforms)

    def rows_payload(self, ipay: Any, data: torch.Tensor) -> Any:
        """The payload from the index stage and the QSGD wire rows
        (int8[payload_len]): in 'value' mode the QSGD payload with the
        sparsifier's indices; in 'both' mode the 'both' payload, whose value
        payload's indices are stripped (QSGD preserves order, the mapping is
        elided)."""
        if self.idx_codec is None:
            return qsgd.QSGDPayload(data=data, indices=ipay.indices, nnz=ipay.nnz)
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

    @property
    def decode_batches(self) -> bool:
        """True when a group of payloads decodes in one call (the vmap
        decode's batch): a raw dense tensor, whose decode is a view. Every
        other decode runs row by row."""
        return self.dense_fallback

    @property
    def host(self) -> bool:
        """True when a codec of this tensor runs on the host."""
        return any(c is not None and c.host for c in (self.idx_codec, self.val_codec))

    def decode(
        self, payload: Any, *, step: int = 0, host_payload: Any = None, values: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """payload -> dense tensor. `host_payload`: the same payload with its
        leaves on the host, read by a host codec's decode (None: it copies
        what it reads). `values`: the QSGD rows' `qsgd.decode_values`, when
        the caller decoded them (the batched cohort does, outside vmap)."""
        if self.dense_fallback:
            return payload.tensor.reshape(self.shape)
        if not self.compressed:
            with span("exchange/decode/sparse"):
                return payload.to_dense()

        def host_kw(codec, part):
            return {"host_payload": part} if codec.host else {}

        if values is not None:
            if self.rows_leaf is None:
                raise ValueError("values= carries decoded QSGD rows; this tensor's value codec is not QSGD")
            if self.idx_codec is None:
                with span("exchange/decode/values"):
                    return qsgd.decode(payload, self.val_codec.meta, self.shape, values=values).to_dense()
        if self.idx_codec is None:
            with span("exchange/decode/values"):
                return self.val_codec.decode(payload, self.shape, **host_kw(self.val_codec, host_payload)).to_dense()
        if self.val_codec is None:
            with span("exchange/decode/index"):
                if self.idx_codec.decodes_dense:
                    return self.idx_codec.decode_dense(payload, self.shape, step=step)
                kw = host_kw(self.idx_codec, host_payload)
                return self.idx_codec.decode(payload, self.shape, step=step, **kw).to_dense()
        vk = self.val_codec.k
        host_parts = (None, None) if host_payload is None else (host_payload.index_payload, host_payload.value_payload)
        with span("exchange/decode/values"):
            mapping = None if payload.mapping is None else packing.unpack(payload.mapping, vk)
            vpay = self.val_codec.restore_for_both(payload.value_payload, mapping)
            # values in the codec's order
            if values is not None:
                vsp = qsgd.decode(vpay, self.val_codec.meta, self.shape, values=values)
            else:
                vsp = self.val_codec.decode(vpay, self.shape, **host_kw(self.val_codec, host_parts[1]))
            table = vsp.values
            if mapping is not None and self.idx_codec.decodes_dense:
                # the slot-ordered table: value i goes to slot indices[i]; a
                # target out of range is dropped, not clipped onto a live slot
                slots = torch.arange(vk, device=table.device)
                idx = vsp.indices.long()
                tgt = torch.where((idx >= 0) & (idx < vk), idx, vk + slots)
                out = torch.zeros(2 * vk, dtype=table.dtype, device=table.device)
                out[tgt] = table
                table = out[:vk]
        with span("exchange/decode/index"):
            if self.idx_codec.decodes_dense:
                return self.idx_codec.decode_dense(payload.index_payload, self.shape, step=step, values=table)
            # the selection list in slot order, paired with the codec's order
            # through its indices (the JAX package's generic 'both' decode)
            ipay = dataclasses.replace(
                payload.index_payload, values=torch.zeros(vk, dtype=torch.float32, device=vsp.values.device)
            )
            isp = self.idx_codec.decode(ipay, self.shape, step=step, **host_kw(self.idx_codec, host_parts[0]))
            idxs = isp.indices[torch.clamp(vsp.indices.long(), 0, vk - 1)]
            return SparseGrad(values=vsp.values, indices=idxs, nnz=payload.nsel, shape=self.shape).to_dense()

    # -- the static wire layout ----------------------------------------- #

    def payload_specs(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each payload leaf, in the JAX pytree's flatten
        order — what the fused buffer's byte layout is built from."""
        i32 = torch.int32
        if self.dense_fallback:
            return [(self.shape, torch.float32)]
        if not self.compressed:
            return [((self.k,), torch.float32), ((self.k,), i32), ((), i32)]
        if self.idx_codec is None:
            return self.val_codec.payload_specs(self.k)
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
        if self.idx_codec is None:
            return self.val_codec.payload_from_leaves(leaves)
        if self.val_codec is None:
            return self.idx_codec.payload_from_leaves(leaves)
        r = len(self.idx_codec.payload_specs(0))
        v = r + len(self.val_codec.payload_specs(0))
        return BothPayload(
            index_payload=self.idx_codec.payload_from_leaves(leaves[:r]),
            value_payload=self.val_codec.payload_from_leaves(leaves[r:v]),
            mapping=None if self.map_width is None else packing.PackedInts(*leaves[v : v + 3]),
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
        elif self.idx_codec is None:
            # value-only: the indices travel raw (none when every element is sent)
            idx_bits = torch.zeros((), **f32) if self.cfg.compressor == "none" else self.val_codec.index_wire_bits(payload)
            val_bits = self.val_codec.value_wire_bits(payload)
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

    def micro_benchmark(self, tensor: torch.Tensor, *, iters: int = 5) -> dict:
        """The reference's 'micro-benchmark' mode (pytorch/deepreduce.py:70-76,
        255-257): the fastest of `iters` wall times (s) of encode and of
        decode, each from a synchronised start to a synchronised end
        (`torch.cuda.synchronize` on the card, nothing to wait for on the
        CPU), and the payload's relative index, value and total volumes.
        Printed as `key:value` lines when `cfg.micro_benchmark` is set."""

        def sync() -> None:
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)

        def timed(fn) -> float:
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            return time.perf_counter() - t0

        payload = self.encode(tensor, step=0)
        self.decode(payload, step=0)
        t_enc = min(timed(lambda: self.encode(tensor, step=1)) for _ in range(iters))
        t_dec = min(timed(lambda: self.decode(payload, step=1)) for _ in range(iters))
        stats = self.wire_stats(payload)
        out = {
            "compression_time": t_enc,
            "decompression_time": t_dec,
            "idx_relative_volume": float(stats.idx_rel_volume()),
            "val_relative_volume": float(stats.val_rel_volume()),
            "relative_volume": float(stats.rel_volume()),
        }
        if self.cfg.micro_benchmark:
            for key, val in out.items():
                print(f"{key}:{val}")
        return out

    def fp_stats(self, payload: Any) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The index filter's measured false positives: (positives beyond
        the selected count, the not-selected universe) as 0-d float32, or
        None when the leaf has no bloom index."""
        if self.dense_fallback or not self.compressed or not hasattr(self.idx_codec, "fp_stats"):
            return None
        ipay = payload.index_payload if isinstance(payload, BothPayload) else payload
        return self.idx_codec.fp_stats(ipay)


def encode_group(
    units: Sequence[EncodeUnit],
    rows: Optional[torch.Tensor],
    *,
    step: int,
    worker: int,
    uniforms: Optional[Dict[Any, torch.Tensor]] = None,
) -> Tuple[Dict[Any, Any], List[EncodeSegment]]:
    """Encode several codec units with one launch of the grouped QSGD
    kernel: every unit's index stage (and its value stage where the value
    codec is not QSGD), then the QSGD wire rows of every unit that has them
    in one `qsgd_encode_rows` launch, each on its unit's own stream at
    (step, worker).

    `units` holds `(key, codec, tensor, rows_lo)`: `rows_lo` is the byte
    offset of the unit's rows in `rows` (unused where it has none).
    `uniforms` (key -> f32, CPU only) replaces the QSGD draws of the named
    units. Returns the payloads by key, a QSGD unit's rows a view of
    `rows`, and the launch's segment table (empty: no launch)."""
    payloads: Dict[Any, Any] = {}
    segments: List[EncodeSegment] = []
    geometry = None
    for key, codec, tensor, rows_lo in units:
        payload = codec.encode_index(tensor, step=step, worker=worker)
        if codec.rows_leaf is not None:
            meta = codec.val_codec.meta
            if geometry not in (None, (meta.quantum_num, meta.bucket_size)):
                raise ValueError("one grouped QSGD launch takes one quantum_num and one bucket_size")
            geometry = (meta.quantum_num, meta.bucket_size)
            u = None if uniforms is None else uniforms.get(key)
            with span("exchange/encode/qsgd"):
                segments.append(codec.value_segment(payload, rows_lo, step=step, worker=worker, uniforms=u))
                payload = codec.rows_payload(payload, rows[rows_lo : rows_lo + meta.payload_len].view(torch.int8))
        elif codec.val_codec is not None:
            with span("exchange/encode/values"):
                payload = codec.encode_values(payload)
        payloads[key] = payload
    if segments:
        with span("exchange/encode/qsgd"):
            qsgd_encode_rows(segments, rows, quantum_num=geometry[0], bucket_size=geometry[1], device=rows.device)
    return payloads, segments
