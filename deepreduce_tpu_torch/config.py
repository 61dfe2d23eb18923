"""DeepReduce configuration for the port: the knobs of the ported arms.

A copy of the knobs of `deepreduce_tpu/config.py` that the ported slices
run (the Table-4 arms of `bench.py`: dense allreduce, Top-r, DRQSGD with a
delta-bitpacked or a bloom index, sampled top-k, the sparsifier-free direct
bloom encode, bloom index-only; and the README quick start: the classic
bloom index with the PolyFit value codec), with the same names and
defaults. A value the port does not implement raises `ConfigError` naming
the knob, so that no run quietly takes another path than the one it asked
for (for instance `approx_topk=True`: torch has no `approx_max_k`, and
exact top-k in its place would be a silent substitute).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


class ConfigError(ValueError):
    """A rejected configuration; `.knob` names the offending field."""

    def __init__(self, knob: str, message: str):
        super().__init__(f"{message} [knob={knob}]")
        self.knob = knob


# knob -> the values the port implements
_SUPPORTED = {
    "compressor": ("topk", "topk_sampled", "none"),
    "approx_topk": (False,),
    "memory": ("residual", "none"),
    "communicator": ("allgather", "allreduce"),
    "deepreduce": (None, "index", "both"),
    "fused": (True,),
    "decode_strategy": ("loop",),
}
# codec knobs, read only when a codec runs (deepreduce is not None)
_SUPPORTED_CODEC = {
    "index": ("bloom", "integer"),
    "value": ("qsgd", "polyfit"),
    "policy": ("p0", "leftmost"),
    "bloom_blocked": ("mod", True, False),
}


@dataclasses.dataclass(frozen=True)
class DeepReduceConfig:
    compressor: str = "topk"
    compress_ratio: float = 0.01
    approx_topk: bool = False
    topk_sample_size: int = 1 << 15
    topk_undershoot: float = 0.9
    memory: str = "residual"
    beta: float = 1.0
    gamma: float = 1.0
    communicator: str = "allgather"
    deepreduce: Optional[str] = None
    value: str = "polyfit"
    index: str = "bloom"
    fpr: Optional[float] = None
    policy: str = "leftmost"
    bloom_blocked: Any = False
    bloom_threshold_insert: bool = False
    poly_degree: int = 5
    quantum_num: int = 127
    bucket_size: int = 512
    sort: bool = False
    seed: int = 0
    fused: bool = True
    decode_strategy: str = "loop"
    min_compress_size: Optional[int] = None

    def __post_init__(self):
        checked = dict(_SUPPORTED, **(_SUPPORTED_CODEC if self.deepreduce is not None else {}))
        for knob, allowed in checked.items():
            val = getattr(self, knob)
            # `is` for the booleans: 1 == True would let 1 through
            if not any(val is a or (type(val) is type(a) and val == a) for a in allowed):
                raise ConfigError(
                    knob,
                    f"{knob}={val!r} is not ported to deepreduce_tpu_torch yet "
                    f"(supported: {list(allowed)})",
                )
        if not 0.0 < self.compress_ratio <= 1.0:
            raise ConfigError("compress_ratio", "compress_ratio must lie in (0, 1]")
        if self.fpr is not None and not 0.0 < self.fpr < 1.0:
            raise ConfigError("fpr", "fpr must lie in (0, 1)")
        if not 0 < self.quantum_num <= 127:
            raise ConfigError("quantum_num", "quantum_num must lie in [1, 127] (int8 levels)")
        if self.bucket_size <= 0:
            raise ConfigError("bucket_size", "bucket_size must be positive")
        if self.topk_sample_size <= 0:
            raise ConfigError("topk_sample_size", "topk_sample_size must be positive")
        if not self.topk_undershoot > 0.0:
            raise ConfigError("topk_undershoot", "topk_undershoot must be positive")
        if not isinstance(self.bloom_threshold_insert, bool):
            raise ConfigError("bloom_threshold_insert", "bloom_threshold_insert must be a bool")
        if not isinstance(self.sort, bool):
            raise ConfigError("sort", "sort must be a bool")
        if self.poly_degree < 0:
            raise ConfigError("poly_degree", "poly_degree must be non-negative")

    def codec_params(self) -> Dict[str, Any]:
        return {
            "fpr": self.fpr,
            "policy": self.policy,
            "bloom_blocked": self.bloom_blocked,
            "bloom_threshold_insert": self.bloom_threshold_insert,
            "poly_degree": self.poly_degree,
            "quantum_num": self.quantum_num,
            "bucket_size": self.bucket_size,
            "sort": self.sort,
            "seed": self.seed,
        }


def from_params(params: Dict[str, Any]) -> DeepReduceConfig:
    """Build a config from a reference-style params dict. Unlike the JAX
    package's lenient default, every key must be a knob of the port: a key
    that would be dropped raises `ConfigError` naming it."""
    fields = {f.name for f in dataclasses.fields(DeepReduceConfig)}
    for key in params:
        if key not in fields:
            raise ConfigError(
                key, f"{key!r} is not a knob of deepreduce_tpu_torch (known: {sorted(fields)})"
            )
    return DeepReduceConfig(**params)
