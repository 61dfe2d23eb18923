"""The C++ library's bloom index codec (the reference's `BloomCPU` slot,
pytorch/deepreduce.py:696-736), ported from
`deepreduce_tpu/codecs/bloom_native.py`.

The host library (`native/`, the reference's bloom_filter_compression.cc
role) inserts the selection into a classic filter, queries the universe,
selects by policy (leftmost, random, p0, or the exact P2 `conflict_sets`,
which only this codec runs, as in the reference) and assembles its own
wire: `[int32 m_bytes | int32 h | int32 count | count x f32 values | m/8
bytes bit-array]`, padded to the static `wire_budget` with the live length
in band. The random policies are keyed by the step. Index-only: the wire
carries the values in band. Encode takes the selected values out of the
assembled wire (as the JAX package's FFI route does; its callback route
decompresses the same bytes); decode re-runs the query and the selection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch import native
from deepreduce_tpu_torch.codecs import bloom, host
from deepreduce_tpu_torch.sparse import SparseGrad

POLICIES = ("leftmost", "random", "p0", "conflict_sets")


@dataclasses.dataclass(frozen=True)
class BloomNativeMeta:
    k: int
    d: int
    m_bits: int
    num_hash: int
    fpr: float
    policy: str
    budget: int  # the selected-index cap (p0: the Lemma-6 bound)

    @classmethod
    def create(cls, k: int, d: int, fpr: Optional[float], policy: str) -> "BloomNativeMeta":
        if policy not in POLICIES:
            raise ValueError(f"unknown bloom_native policy {policy!r}; have {list(POLICIES)}")
        m_bits, num_hash, fpr_eff = bloom.bloom_config(k, d, fpr)
        return cls(k=k, d=d, m_bits=m_bits, num_hash=num_hash, fpr=fpr_eff, policy=policy,
                   budget=bloom.policy_budget(policy, k, d, fpr_eff))

    @property
    def wire_budget(self) -> int:
        return 12 + self.budget * 4 + self.m_bits // 8


@dataclasses.dataclass(frozen=True)
class BloomNativePayload:
    wire: torch.Tensor  # int8[wire_budget]: the C++ wire bytes, zero-padded
    nbytes: torch.Tensor  # i32[]: the live wire length
    values: torch.Tensor  # f32[budget]: the selected values (also inside the wire)
    nsel: torch.Tensor  # i32[]: the live selected count

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.wire, self.nbytes, self.values, self.nsel)


def encode(sp: SparseGrad, dense: torch.Tensor, meta: BloomNativeMeta, *, step: int = 0) -> BloomNativePayload:
    dev = dense.device
    with host.span("bloom_native.encode"):
        dense_np = host.to_host(dense.reshape(-1))
        idx = host.to_host(sp.indices)[: int(host.to_host(sp.nnz))]
        wire = native.bloom_compress(dense_np, idx, meta.m_bits, meta.num_hash, meta.policy, int(step), meta.budget)
        nsel = int(wire[8:12].view("<i4")[0])
        out_wire = np.zeros(meta.wire_budget, np.int8)
        out_wire[: len(wire)] = wire
        out_vals = np.zeros(meta.budget, np.float32)
        out_vals[:nsel] = wire[12 : 12 + 4 * nsel].view("<f4")
    return BloomNativePayload(wire=host.to_device(out_wire, dev), nbytes=host.scalar(len(wire), dev),
                              values=host.to_device(out_vals, dev), nsel=host.scalar(nsel, dev))


def decode(payload: BloomNativePayload, meta: BloomNativeMeta, shape: Tuple[int, ...], *, step: int = 0,
           host_payload: Optional[BloomNativePayload] = None) -> SparseGrad:
    """`host_payload`: the same payload's leaves on the host, if the caller
    has copied them already."""
    dev = payload.wire.device
    with host.span("bloom_native.decode"):
        src = payload if host_payload is None else host_payload
        wire = host.to_host(src.wire)[: int(host.to_host(src.nbytes))]
        vals, idxs = native.bloom_decompress(wire, meta.d, meta.k, meta.policy, int(step), meta.budget)
        out_v = np.zeros(meta.budget, np.float32)
        out_i = np.zeros(meta.budget, np.int32)
        out_v[: len(vals)] = vals
        out_i[: len(idxs)] = idxs
    return SparseGrad(values=host.to_device(out_v, dev), indices=host.to_device(out_i, dev),
                      nnz=host.scalar(len(idxs), dev), shape=shape)


def wire_bits(payload: BloomNativePayload, meta: BloomNativeMeta) -> torch.Tensor:
    return payload.nbytes.to(torch.float32) * 8.0
