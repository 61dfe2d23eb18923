"""QSGD bucketed stochastic quantizer (order-preserving, lossy), ported from
`deepreduce_tpu/codecs/qsgd.py`.

Wire layout ``[bucket_size int8 levels | 4 norm bytes] x B``: the norm is
the bucket's float32 L2 norm as its little-endian bit pattern. Values are
zero-padded to whole buckets; padding quantizes to level 0.

The bucket norm is accumulated in float64 and rounded once to float32, so
the CPU and the card derive the same norm (a float32 sum would round in a
device-dependent order) and therefore the same scale; the JAX package sums
in float32, so norms agree with it to float32 rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch.ops import quantize_levels, quantize_levels_plain
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
    """(scale f32[n], norms f32[n/bucket]) with the zero-norm guard; `flat`
    length must be a multiple of bucket_size."""
    buckets = flat.reshape(-1, bucket_size)
    norms = buckets.double().square().sum(dim=1).sqrt().float()
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    scale = (quantum_num / safe)[:, None].expand(buckets.shape).reshape(-1)
    return scale, norms


def encode(
    sp: SparseGrad,
    meta: QSGDMeta,
    seed: int,
    offset: int,
    *,
    uniforms: Optional[torch.Tensor] = None,
) -> QSGDPayload:
    """Quantize `sp.values` with the Philox stream (seed, offset).

    `uniforms` (f32[B*bucket], CPU only) replaces the stream with given
    draws: the parity tests feed the uniforms JAX draws, to hold the port's
    bytes against the JAX package's. On a CUDA tensor it raises, so a run
    on the card always goes through the kernel."""
    b, bs, q = meta.num_buckets, meta.bucket_size, meta.quantum_num
    dev = sp.values.device
    padded = torch.zeros(b * bs, dtype=torch.float32, device=dev)
    padded[: meta.k] = sp.values
    scale, norms = bucket_scale(padded, q, bs)
    if uniforms is None:
        levels = quantize_levels(padded, scale.contiguous(), seed, offset, device=dev)
    else:
        if dev.type != "cpu":
            raise ValueError("injected uniforms are a CPU parity hook; on CUDA the kernel draws them")
        levels = quantize_levels_plain(padded, scale, uniforms)
    norm_bytes = norms.view(torch.int8).reshape(b, 4)
    data = torch.cat([levels.reshape(b, bs), norm_bytes], dim=1).reshape(-1)
    return QSGDPayload(data=data, indices=sp.indices, nnz=sp.nnz)


def decode(payload: QSGDPayload, meta: QSGDMeta, shape: Tuple[int, ...]) -> SparseGrad:
    b, bs, q = meta.num_buckets, meta.bucket_size, meta.quantum_num
    rows = payload.data.reshape(b, bs + 4)
    levels = rows[:, :bs].to(torch.float32)
    norms = rows[:, bs:].contiguous().view(torch.float32).reshape(b)
    vals = (norms[:, None] / q * levels).reshape(-1)[: meta.k]
    return SparseGrad(values=vals, indices=payload.indices, nnz=payload.nnz, shape=shape)


def wire_bits(payload: QSGDPayload, meta: QSGDMeta) -> torch.Tensor:
    """`level_bits` per level + 32 bits of norm per live bucket."""
    nnz = payload.nnz.to(torch.float32)
    full_buckets = torch.floor((nnz + meta.bucket_size - 1) / meta.bucket_size)
    return nnz * meta.level_bits + full_buckets * 32
