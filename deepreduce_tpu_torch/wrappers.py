"""Composition layer: the DeepReduce wrapper over the top-k sparsifier,
ported from `deepreduce_tpu/wrappers.py` for `deepreduce in (None, 'both')`.

- A tensor with at most `min_compress_size` elements (default 1000) is
  sparsified but not codec-compressed: its wire payload is the sparse
  (values, indices, nnz) triple. On the full-width WordLSTM the five biases
  of width 670 and 96 take this path.
- `dense_fallback`: an uncompressed tensor whose sparse pair would cost at
  least the raw tensor (k*64 >= d*32 bits) ships the raw tensor instead.
- `'both'`: bloom index codec first (FP-aware), then QSGD over the selected
  values in rank order. QSGD preserves order, so the mapping is elided.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from deepreduce_tpu_torch import sparse
from deepreduce_tpu_torch.codecs import bloom, qsgd
from deepreduce_tpu_torch.codecs.registry import get_codec
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.ops import EncodeSegment, qsgd_encode_rows
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class DensePayload:
    """Raw-tensor payload of an uncompressed leaf whose sparse pair would
    cost at least the raw tensor."""

    tensor: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.tensor,)


@dataclasses.dataclass(frozen=True)
class BothPayload:
    """'both' wire format: index payload (values stripped), value payload
    (indices stripped) and the selected count. The mapping is always elided
    (QSGD preserves order), so it contributes no leaf."""

    index_payload: bloom.BloomPayload
    value_payload: qsgd.QSGDPayload
    nsel: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return self.index_payload.leaves() + self.value_payload.leaves() + (self.nsel,)


# index of the QSGD wire rows among a compressed payload's leaves
# (`TensorCodec.payload_specs`)
ROWS_LEAF = 3


class TensorCodec:
    """Per-tensor compressor bound to a static shape and a device."""

    def __init__(
        self,
        shape: Tuple[int, ...],
        cfg: DeepReduceConfig,
        name: str = "",
        *,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.shape = tuple(int(s) for s in shape)
        self.cfg = cfg
        self.name = name
        self.d = int(math.prod(self.shape)) if self.shape else 1
        min_size = 1000 if cfg.min_compress_size is None else cfg.min_compress_size
        self.compressed = cfg.deepreduce is not None and self.d > min_size
        self.k = sparse.num_slots(self.d, cfg.compress_ratio)
        params = cfg.codec_params()
        self.idx_codec = None
        self.val_codec = None
        if self.compressed:
            self.idx_codec = get_codec(cfg.index, "index")(self.k, self.d, params)
            # the value codec sees the index codec's selection: its slot
            # count is the index codec's budget
            self.val_codec = get_codec(cfg.value, "value")(self.idx_codec.meta.budget, self.d, params)
        self.dense_fallback = not self.compressed and self.k * 64 >= self.d * 32

    # ------------------------------------------------------------------ #

    def encode(
        self,
        tensor: torch.Tensor,
        *,
        step: int = 0,
        worker: int = 0,
        uniforms: Optional[torch.Tensor] = None,
    ) -> Any:
        """tensor -> payload: the index stage, then the value stage as a
        one-segment fused QSGD encode. `uniforms` (CPU only) replaces the
        QSGD Philox draws; see `codecs.qsgd.encode`."""
        ipay = self.encode_index(tensor)
        if not self.compressed:
            return ipay
        data = torch.empty(self.val_codec.meta.payload_len, dtype=torch.int8, device=tensor.device)
        seg = self.value_segment(ipay, 0, step=step, worker=worker, uniforms=uniforms)
        meta = self.val_codec.meta
        qsgd_encode_rows([seg], data, quantum_num=meta.quantum_num, bucket_size=meta.bucket_size, device=self.device)
        return self.both_payload(ipay, data)

    def encode_index(self, tensor: torch.Tensor) -> Any:
        """The index stage. A compressed leaf gives its bloom payload (top-k,
        then `bloom.encode`: f32[budget] values in rank order, words, nsel),
        whose values the value stage quantizes; any other leaf gives its
        whole payload."""
        check_on(tensor, self.device, f"tensor {self.name!r}")
        if self.dense_fallback:
            return DensePayload(tensor=tensor)
        sp = sparse.topk(tensor, self.cfg.compress_ratio, k=self.k)
        if not self.compressed:
            return sp
        return self.idx_codec.encode(sp, dense=tensor)

    def value_segment(
        self,
        ipay: bloom.BloomPayload,
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

    def both_payload(self, ipay: bloom.BloomPayload, data: torch.Tensor) -> BothPayload:
        """The 'both' payload from the index stage and the QSGD wire rows
        (int8[payload_len]); the value payload's indices are stripped, since
        QSGD preserves order and the mapping is elided."""
        empty = torch.zeros(0, dtype=torch.float32, device=data.device)
        return BothPayload(
            index_payload=dataclasses.replace(ipay, values=empty),
            value_payload=qsgd.QSGDPayload(
                data=data, indices=torch.zeros(0, dtype=torch.int32, device=data.device), nnz=ipay.nsel
            ),
            nsel=ipay.nsel,
        )

    def decode(self, payload: Any) -> torch.Tensor:
        """payload -> dense tensor."""
        if self.dense_fallback:
            return payload.tensor.reshape(self.shape)
        if not self.compressed:
            return payload.to_dense()
        vsp = self.val_codec.decode(payload.value_payload, self.shape)  # rank-order values
        return self.idx_codec.decode_dense(payload.index_payload, self.shape, values=vsp.values)

    # -- the static wire layout ----------------------------------------- #

    def payload_specs(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each payload leaf, in the JAX pytree's flatten
        order — what the fused buffer's byte layout is built from."""
        i32 = torch.int32
        if self.dense_fallback:
            return [(self.shape, torch.float32)]
        if not self.compressed:
            return [((self.k,), torch.float32), ((self.k,), i32), ((), i32)]
        return [
            ((0,), torch.float32),
            ((self.idx_codec.meta.n_words,), i32),
            ((), i32),
            ((self.val_codec.meta.payload_len,), torch.int8),
            ((0,), i32),
            ((), i32),
            ((), i32),
        ]

    def payload_from_leaves(self, leaves: List[torch.Tensor]) -> Any:
        if self.dense_fallback:
            return DensePayload(tensor=leaves[0])
        if not self.compressed:
            return SparseGrad(values=leaves[0], indices=leaves[1], nnz=leaves[2], shape=self.shape)
        return BothPayload(
            index_payload=bloom.BloomPayload(values=leaves[0], words=leaves[1], nsel=leaves[2]),
            value_payload=qsgd.QSGDPayload(data=leaves[3], indices=leaves[4], nnz=leaves[5]),
            nsel=leaves[6],
        )

    # ------------------------------------------------------------------ #

    def wire_stats(self, payload: Any) -> WireStats:
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        dense_bits = torch.tensor(float(self.d * 32), **f32)
        saturated = torch.zeros((), **f32)
        if self.dense_fallback:
            idx_bits = torch.zeros((), **f32)
            val_bits = dense_bits
        elif not self.compressed:
            nnz = payload.nnz.to(torch.float32)
            idx_bits = nnz * 32
            val_bits = nnz * 32
        else:
            idx_bits = torch.tensor(self.idx_codec.index_wire_bits(payload.index_payload), **f32)
            val_bits = self.val_codec.value_wire_bits(payload.value_payload)
            saturated = bloom.saturated(payload.index_payload, self.idx_codec.meta).to(torch.float32)
        return WireStats(
            index_bits=idx_bits, value_bits=val_bits, dense_bits=dense_bits, saturated=saturated
        )
