"""QSGD bucketed stochastic quantizer (order-preserving, lossy), ported from
`deepreduce_tpu/codecs/qsgd.py`.

Wire layout ``[bucket_size int8 levels | 4 norm bytes] x B``: the norm is
the bucket's float32 L2 norm as its little-endian bit pattern. Values are
zero-padded to whole buckets; padding quantizes to level 0.

`encode` writes the rows with the fused kernel `ops.qsgd_encode_rows` (a
one-segment table; the exchange groups every leaf of a step into one
launch). The bucket norm is summed in float64 in one fixed order
(`ops.bucket_norms_ordered`) and rounded once to float32, so the CPU and
the card derive the same norm bit for bit, and the scale `q / norm` is one
IEEE divide, as in the JAX package. The JAX package sums in float32, so
norms agree with it to float32 rounding, not bitwise. `decode` multiplies
by the norm times the float32 reciprocal of q, the arithmetic XLA compiles
the JAX package's `norms / q * levels` to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch.numerics import reciprocal_f32
from deepreduce_tpu_torch.ops import EncodeSegment, bucket_norms_ordered, qsgd_encode_rows, scale_from_norms
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class QSGDMeta:
    k: int
    quantum_num: int = 127
    bucket_size: int = 512

    @property
    def num_buckets(self) -> int:
        return (self.k + self.bucket_size - 1) // self.bucket_size

    @property
    def padded_len(self) -> int:
        return self.num_buckets * self.bucket_size

    @property
    def level_bits(self) -> int:
        """Meaningful bits per level: sign + magnitude at the width of q."""
        return 1 + max(1, int(self.quantum_num).bit_length())

    @property
    def payload_len(self) -> int:
        return self.num_buckets * (self.bucket_size + 4)


@dataclasses.dataclass(frozen=True)
class QSGDPayload:
    data: torch.Tensor  # int8[B*(bucket+4)] — levels with in-band norm bytes
    indices: torch.Tensor  # i32[k] (i32[0] once stripped in 'both' mode)
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.data, self.indices, self.nnz)


def bucket_scale(flat: torch.Tensor, quantum_num: int, bucket_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale f32[n], norms f32[n/bucket]) with the zero-norm guard, exactly
    as the fused kernel derives them; `flat` length must be a multiple of
    bucket_size. The scale is what `ops.quantize_levels` takes."""
    norms = bucket_norms_ordered(flat, bucket_size)
    # contiguous: with one bucket the reshape is a stride-0 view, which the
    # kernel's wrapper refuses
    scale = scale_from_norms(norms, quantum_num)[:, None].expand(-1, bucket_size).reshape(-1).contiguous()
    return scale, norms


def encode(
    sp: SparseGrad,
    meta: QSGDMeta,
    seed: int,
    offset: int,
    *,
    uniforms: Optional[torch.Tensor] = None,
) -> QSGDPayload:
    """Quantize `sp.values` (f32[meta.k]) with the Philox stream (seed,
    offset) into fresh wire rows.

    `uniforms` (f32[B*bucket], CPU only) replaces the stream with given
    draws: the parity tests feed the uniforms JAX draws, to hold the port's
    bytes against the JAX package's. On a CUDA tensor it raises, so a run
    on the card always goes through the kernel."""
    if sp.values.shape != (meta.k,):
        raise ValueError(f"values have shape {tuple(sp.values.shape)}, the codec expects ({meta.k},)")
    dev = sp.values.device
    data = torch.empty(meta.payload_len, dtype=torch.int8, device=dev)
    seg = EncodeSegment(values=sp.values.contiguous(), out_offset=0, seed=seed, offset=offset, uniforms=uniforms)
    qsgd_encode_rows([seg], data, quantum_num=meta.quantum_num, bucket_size=meta.bucket_size, device=dev)
    return QSGDPayload(data=data, indices=sp.indices, nnz=sp.nnz)


def decode_values(data: torch.Tensor, meta: QSGDMeta) -> torch.Tensor:
    """f32[..., k] decoded values of wire rows int8[..., payload_len], any
    leading dimensions (a batch of clients' rows at once: the norms' dtype
    view has no `torch.func.vmap` rule, so a batched decode reads them here,
    outside vmap)."""
    b, bs, q = meta.num_buckets, meta.bucket_size, meta.quantum_num
    lead = tuple(data.shape[:-1])
    rows = data.reshape(lead + (b, bs + 4))
    levels = rows[..., :bs].to(torch.float32)
    norms = rows[..., bs:].contiguous().view(torch.float32).reshape(lead + (b,))
    # the JAX package's `norms / q * levels`, compiled: (norms * fl(1/q)) * levels
    return (levels * (norms * reciprocal_f32(q))[..., None]).reshape(lead + (-1,))[..., : meta.k]


def decode(
    payload: QSGDPayload, meta: QSGDMeta, shape: Tuple[int, ...], *, values: Optional[torch.Tensor] = None
) -> SparseGrad:
    """The payload's sparse tensor; `values` are its rows' `decode_values`
    when the caller has them."""
    vals = decode_values(payload.data, meta) if values is None else values
    return SparseGrad(values=vals, indices=payload.indices, nnz=payload.nnz, shape=shape)


def wire_bits(payload: QSGDPayload, meta: QSGDMeta) -> torch.Tensor:
    """`level_bits` per level + 32 bits of norm per live bucket."""
    nnz = payload.nnz.to(torch.float32)
    full_buckets = torch.floor((nnz + meta.bucket_size - 1) / meta.bucket_size)
    return nnz * meta.level_bits + full_buckets * 32
