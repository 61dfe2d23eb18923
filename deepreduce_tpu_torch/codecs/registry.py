"""Codec adapters binding static geometry, ported from
`deepreduce_tpu/codecs/registry.py` for the two codecs of the main path:
the bloom index codec and the QSGD value codec."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deepreduce_tpu_torch.codecs import bloom, qsgd
from deepreduce_tpu_torch.sparse import SparseGrad


class Codec:
    """Base adapter: static (k, d) geometry plus encode/decode and the
    split index/value wire accounting."""

    def __init__(self, k: int, d: int, params: Optional[Dict[str, Any]] = None):
        self.k = k
        self.d = d
        self.params = dict(params or {})


class BloomCodec(Codec):
    def __init__(self, k, d, params=None):
        super().__init__(k, d, params)
        self.meta = bloom.BloomMeta.create(
            k,
            d,
            fpr=self.params.get("fpr"),
            policy=self.params.get("policy", "leftmost"),
            blocked=self.params.get("bloom_blocked", "mod"),
        )

    def encode(self, sp: SparseGrad, dense: torch.Tensor) -> bloom.BloomPayload:
        return bloom.encode(sp, dense, self.meta)

    def decode_dense(self, payload, shape, *, values=None) -> torch.Tensor:
        return bloom.decode_dense(payload, self.meta, shape, values=values)

    def index_wire_bits(self, payload) -> float:
        return 64.0 + self.meta.m_bits


class QSGDCodec(Codec):
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


INDEX_CODECS: Dict[str, type] = {"bloom": BloomCodec}
VALUE_CODECS: Dict[str, type] = {"qsgd": QSGDCodec}


def get_codec(name: str, kind: str) -> type:
    table = INDEX_CODECS if kind == "index" else VALUE_CODECS
    if name not in table:
        raise KeyError(f"unknown or unported {kind} codec {name!r}; have {sorted(table)}")
    return table[name]
