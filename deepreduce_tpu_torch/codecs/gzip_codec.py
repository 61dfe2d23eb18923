"""Deflate value codec (host path, lossless, order-preserving), ported from
`deepreduce_tpu/codecs/gzip_codec.py`.

The reference's zlib round trip over the float32 values
(pytorch/deepreduce.py:742-764): the stdlib's `zlib.compress` at its
default level on the little-endian float32 bytes, on the host
(`codecs.host`), into a static budget of 4k + (4k // 16384 + 1) * 5 + 64
bytes with the live length in band (int32, as the JAX package's callback
returns it).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.codecs import host
from deepreduce_tpu_torch.sparse import SparseGrad


@dataclasses.dataclass(frozen=True)
class GzipMeta:
    k: int

    @property
    def budget_bytes(self) -> int:
        # zlib's worst case is the input + 5 bytes per 16 KB block + 6
        n = 4 * self.k
        return n + (n // 16384 + 1) * 5 + 64


@dataclasses.dataclass(frozen=True)
class GzipPayload:
    stream: torch.Tensor  # uint8[budget_bytes]
    nbytes: torch.Tensor  # i32[]: the stream's live bytes
    indices: torch.Tensor  # i32[k], untouched; i32[0] in 'both' mode
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.stream, self.nbytes, self.indices, self.nnz)


def encode(sp: SparseGrad, meta: GzipMeta) -> GzipPayload:
    dev = sp.values.device
    with host.span("gzip.encode"):
        vals = host.to_host(sp.values)
        packed = zlib.compress(np.ascontiguousarray(vals.astype("<f4")).tobytes())
        out = np.zeros(meta.budget_bytes, np.uint8)
        out[: len(packed)] = np.frombuffer(packed, np.uint8)
    return GzipPayload(stream=host.to_device(out, dev), nbytes=host.scalar(len(packed), dev), indices=sp.indices,
                       nnz=sp.nnz)


def decode(payload: GzipPayload, meta: GzipMeta, shape: Tuple[int, ...],
           host_payload: Optional[GzipPayload] = None) -> SparseGrad:
    """`host_payload`: the same payload's leaves on the host, if the caller
    has copied them already."""
    dev = payload.stream.device
    with host.span("gzip.decode"):
        src = payload if host_payload is None else host_payload
        stream, nbytes = host.to_host(src.stream), host.to_host(src.nbytes)
        raw = zlib.decompress(stream[: int(nbytes)].tobytes())
        vals = np.frombuffer(raw, "<f4").astype(np.float32)
    return SparseGrad(values=host.to_device(vals, dev), indices=payload.indices, nnz=payload.nnz, shape=shape)


def wire_bits(payload: GzipPayload, meta: GzipMeta) -> torch.Tensor:
    return payload.nbytes.to(torch.float32) * 8 + 64
