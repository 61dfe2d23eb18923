"""DeepReduce configuration for the port: the knobs of the ported arms.

A copy of the knobs of `deepreduce_tpu/config.py` that the ported slices
run (the Table-4 arms of `bench.py`: dense allreduce, Top-r, DRQSGD with a
delta-bitpacked or a bloom index, sampled top-k, the sparsifier-free direct
bloom encode, bloom index-only; the README quick start: the classic bloom
index with the PolyFit value codec; the in-collective communicators: the
int8 quantized allreduce `qar` and the `sparse_rs` reduce-scatter routes
sparse, adaptive, quantized and oktopk; the bucketed exchange with its
pipelined, barrier and backprop-streamed schedules; and every on-device
codec, policy, layout, wrapper mode and sparsifier: random-k and the
magnitude threshold, the value-only mode, the RLE index, the Fit-DExp,
PolySeg and count-sketch value codecs, the bloom P1 (random) and
approximate P2 policies and its hash-blocked layout), with the same names
and defaults.
A value the port does not implement raises `ConfigError` naming
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
    "compressor": ("topk", "topk_sampled", "randomk", "threshold", "none"),
    "approx_topk": (False,),
    "memory": ("residual", "none"),
    "communicator": ("allgather", "allreduce", "qar", "sparse_rs"),
    # 'sketch' needs the count-sketch codec, 'auto' the cost model's
    # select_rs_mode: neither is ported
    "rs_mode": ("sparse", "adaptive", "quantized", "oktopk"),
    "deepreduce": (None, "value", "index", "both"),
    "fused": (True,),
    "decode_strategy": ("loop",),
}
BUCKET_ORDERS = ("trace", "reverse")
# codec knobs, read only when a codec runs (deepreduce is not None). The
# JAX package's other values run on the host (huffman, gzip, polyfit_host,
# the *_native codecs through its C++ library, the exact conflict_sets
# policy) and are not ported
_SUPPORTED_CODEC = {
    "index": ("bloom", "integer", "rle"),
    "value": ("qsgd", "polyfit", "doubleexp", "polyseg", "countsketch"),
    "policy": ("p0", "leftmost", "random", "conflict_sets_approx"),
    "bloom_blocked": ("mod", "hash", True, False),
}
# reference-style aliases of `from_params` (the JAX package's _KEY_MAP)
_KEY_MAP = {"threshold": "threshold_val"}


@dataclasses.dataclass(frozen=True)
class DeepReduceConfig:
    compressor: str = "topk"
    compress_ratio: float = 0.01
    # the `threshold` sparsifier's cut (0.0: every nonzero, natural sparsity)
    threshold_val: float = 0.0
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
    # None: 1000, or 9000 when value='doubleexp' (the per-codec gates)
    min_compress_size: Optional[int] = None
    # regex on the tensor's name: a leaf it does not match ships dense, not
    # even sparsified (None: every leaf, or '(?i)conv' when value='polyseg')
    layer_pattern: Optional[str] = None
    # sparse_rs (see sparse_rs.py): phase-1 per-shard budget and phase-2
    # output budget multipliers over k/W, the route, the int8 block of the
    # adaptive dense rows and the quantized route, the adaptive switch point
    # (1.0 = never dense), and the oktopk histogram bins and per-(worker,
    # shard) capacity multiplier over k/W**2
    rs_headroom: float = 2.0
    rs_out_headroom: float = 1.0
    rs_mode: str = "sparse"
    rs_block_size: int = 256
    rs_density_threshold: float = 1.0
    rs_oktopk_bins: int = 4096
    rs_oktopk_cap_headroom: float = 2.0
    # the bucketed exchange (comm_bucket.py): buckets of at most
    # bucket_bytes dense float32 bytes, one codec and one all_gather each
    # (None: one codec per leaf); bucket b+1's gather started before bucket
    # b's decode (False: gather every bucket, then decode); the partition's
    # order ('reverse': backward-completion order, for streaming); and the
    # exchange streamed out of the backward pass (comm_stream.py)
    bucket_bytes: Optional[int] = None
    bucket_pipeline: bool = True
    bucket_order: str = "trace"
    stream_exchange: bool = False

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

        self._check_in_collective()
        self._check_buckets()

    def _check_in_collective(self) -> None:
        """The sparse_rs knobs' ranges and the fences of the in-collective
        communicators (the JAX package's reason codes name the fences; it
        raises the codec-stack ones when the exchanger is built)."""
        if self.rs_mode != "sparse" and self.communicator != "sparse_rs":
            raise ConfigError(
                "rs-mode-needs-sparse-rs",
                f"rs_mode={self.rs_mode!r} selects a sparse_rs route and would be silently ignored "
                f"with communicator={self.communicator!r}: use communicator='sparse_rs'",
            )
        if self.rs_block_size < 4 or self.rs_block_size % 4:
            raise ConfigError(
                "rs_block_size",
                f"rs_block_size must be a positive multiple of 4 (int8 levels ride 4 per f32 lane), "
                f"got {self.rs_block_size}",
            )
        if not 0.0 <= self.rs_density_threshold <= 1.0:
            raise ConfigError("rs_density_threshold", "rs_density_threshold must lie in [0, 1]")
        b = self.rs_oktopk_bins
        if b < 64 or b > (1 << 24) or b & (b - 1):
            raise ConfigError("rs_oktopk_bins", f"rs_oktopk_bins must be a power of two in [64, 2**24], got {b}")
        if not self.rs_oktopk_cap_headroom > 0.0:
            raise ConfigError("rs_oktopk_cap_headroom", "rs_oktopk_cap_headroom must be positive")
        if self.communicator == "qar" and (
            self.deepreduce is not None or self.compressor != "none" or self.memory == "residual"
        ):
            raise ConfigError(
                "build-qar-codec-stack",
                "communicator='qar' quantizes the dense gradient inside the collective and runs no "
                f"sparsifier, codec or error feedback: compressor={self.compressor!r}, "
                f"deepreduce={self.deepreduce!r} and memory={self.memory!r} would be silently ignored; "
                "use compressor='none', deepreduce=None, memory='none'",
            )
        if self.communicator == "sparse_rs" and (self.deepreduce is not None or self.compressor != "topk"):
            raise ConfigError(
                "build-sparse-rs-codec-stack",
                "communicator='sparse_rs' top-k-sparsifies and routes the entries itself: "
                f"deepreduce={self.deepreduce!r} and compressor={self.compressor!r} would be silently "
                "ignored; use compressor='topk', deepreduce=None",
            )

    def _check_buckets(self) -> None:
        """The bucketed and streamed exchange's fences, under the JAX
        package's reason codes (`deepreduce_tpu/config.py`); the exchanger
        raises the codec-stack ones when it is built (`comm.py`)."""
        if self.bucket_bytes is not None and self.bucket_bytes < 4:
            raise ConfigError(
                "bucket-bytes-range",
                f"bucket_bytes must be >= 4 (one f32 element) or None, got {self.bucket_bytes}",
            )
        if self.bucket_order not in BUCKET_ORDERS:
            raise ConfigError("enum-bucket_order", f"bucket_order must be one of {BUCKET_ORDERS}, got {self.bucket_order!r}")
        if self.bucket_order != "trace" and self.bucket_bytes is None:
            raise ConfigError(
                "bucket-order-needs-buckets",
                f"bucket_order={self.bucket_order!r} orders the bucketed exchange's partition and would be "
                "silently ignored with bucket_bytes=None: set bucket_bytes (or drop bucket_order)",
            )
        if self.stream_exchange and self.bucket_bytes is None:
            raise ConfigError(
                "stream-needs-buckets",
                "stream_exchange=True streams the bucketed exchange out of the backward pass (one hook per "
                "bucket): with bucket_bytes=None there is no partition to stream; set bucket_bytes",
            )

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
    """Build a config from a reference-style params dict (`threshold` is an
    alias of `threshold_val`). Unlike the JAX package's lenient default,
    every key must be a knob of the port: a key that would be dropped raises
    `ConfigError` naming it."""
    fields = {f.name for f in dataclasses.fields(DeepReduceConfig)}
    kwargs = {}
    for key, val in params.items():
        key = _KEY_MAP.get(key, key)
        if key not in fields:
            raise ConfigError(
                key, f"{key!r} is not a knob of deepreduce_tpu_torch (known: {sorted(fields)})"
            )
        kwargs[key] = val
    return DeepReduceConfig(**kwargs)
