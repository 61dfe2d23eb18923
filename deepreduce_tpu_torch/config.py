"""DeepReduce configuration for the port: the knobs of the ported arms.

A copy of the knobs of `deepreduce_tpu/config.py` that the ported slices
run (the Table-4 arms of `bench.py`: dense allreduce, Top-r, DRQSGD with a
delta-bitpacked or a bloom index, sampled top-k, the sparsifier-free direct
bloom encode, bloom index-only; the README quick start: the classic bloom
index with the PolyFit value codec; the in-collective communicators: the
int8 quantized allreduce `qar` and every `sparse_rs` reduce-scatter route:
sparse, adaptive, quantized, sketch, oktopk and the cost model's pick
`auto`, with its machine `profile`; the two-tier exchange `hier` (a slice
mean over the intra-node group, then the compressed exchange across
slices); the bucketed exchange with its
pipelined, barrier and backprop-streamed schedules; and every on-device
codec, policy, layout, wrapper mode and sparsifier: random-k and the
magnitude threshold, the value-only mode, the RLE index, the Fit-DExp,
PolySeg and count-sketch value codecs, the bloom P1 (random) and
approximate P2 policies and its hash-blocked layout; and the host codecs:
the Huffman index, the C++ library's bloom index with the exact P2 policy
`conflict_sets` and its integer family under `code`, the Deflate and the
searched-knot PolyFit value codecs; the unfused exchange, the vmap and ring
decodes and the resilience subsystem; the federated simulation's knobs
`fed*`, `fed_async*`, `fed_tenants` / `fed_mt_*`, `pop_*` and `slo_*`;
`telemetry` / `telemetry_every` and the adaptive controller's `ctrl*`),
with the same names and defaults. Of the JAX package's fields only
`use_pallas` is missing: it picks the TPU kernel's Pallas route, and the
port runs its CUDA kernels on the card.
`approx_topk=True` runs, and the port computes it exactly, as XLA
computes `jax.lax.approx_max_k` on the CPU and the GPU: the same selection
as exact top-k, ties and order included. It does not reproduce the TPU's
recall below 1 (about 0.95). As in the JAX package, `rs_mode='oktopk'`
refuses it.
A value the port does not implement raises `ConfigError` naming
the knob, so that no run quietly takes another path than the one it asked
for. Every rejection carries a registered reason code, the JAX package's
where it makes the same rejection.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# The machine-readable rejection codes, a copy of the JAX package's
# registry (`deepreduce_tpu/config.py`, which imports jax through its
# package): every fence the port shares with it raises the same code.
REASON_CODES: Dict[str, str] = {
    # enum membership (config.check): one code per enumerated field
    "enum-compressor": "compressor not in COMPRESSORS",
    "enum-memory": "memory not in MEMORIES",
    "enum-communicator": "communicator not in COMMUNICATORS",
    "enum-deepreduce": "deepreduce not in DEEPREDUCE_MODES",
    "enum-policy": "policy not in POLICIES",
    "enum-value": "value not in VALUE_CODECS",
    "enum-index": "index not in INDEX_CODECS",
    "enum-bloom_blocked": "bloom_blocked not in BLOOM_BLOCKED",
    "enum-rs_mode": "rs_mode not in RS_MODES",
    "enum-bucket_order": "bucket_order not in BUCKET_ORDERS",
    "enum-hier_ici": "hier_ici not in HIER_ICI_LEGS",
    "enum-hier_dcn": "hier_dcn not in HIER_DCN_MODES",
    "enum-decode_strategy": "decode_strategy not in ('loop', 'vmap', 'ring')",
    # scalar range checks
    "rs-block-size-range": "rs_block_size must be a positive multiple of 4",
    "rs-density-threshold-range": "rs_density_threshold outside [0, 1]",
    "rs-sketch-rows-range": "rs_sketch_rows < 1",
    "rs-sketch-cols-range": "rs_sketch_cols < 0",
    "rs-oktopk-bins-range":
        "rs_oktopk_bins not a power of two in [64, 2**24]",
    "rs-oktopk-cap-headroom-range": "rs_oktopk_cap_headroom <= 0",
    "decode-batch-range": "decode_batch < 1",
    "telemetry-every-range": "telemetry_every < 1",
    "bucket-bytes-range": "bucket_bytes < 4 (one f32 element)",
    "ici-size-range": "ici_size < 1",
    "resilience-rate-range": "a drop/chaos rate outside [0, 1]",
    "ctrl-target-range": "ctrl_target_err_cos outside (0, 1]",
    "ctrl-headroom-range": "ctrl_headroom < 0",
    "ctrl-saturation-range": "ctrl_saturation_ceiling < 0",
    "ctrl-hysteresis-range": "ctrl_hysteresis < 1",
    "fed-population-range": "fed_num_clients <= 0 with fed=True",
    "fed-cohort-range": "fed_clients_per_round <= 0 with fed=True",
    "fed-cohort-exceeds-population": "cohort larger than the population",
    "fed-local-steps-range": "fed_local_steps <= 0",
    "fed-server-lr-range": "fed_server_lr <= 0",
    "fed-client-chunk-range": "fed_client_chunk < 0",
    "fed-chunk-divides-cohort": "fed_client_chunk does not divide the cohort",
    # feature-exclusion constraints (the legality matrix proper)
    "rs-mode-needs-sparse-rs": "rs_mode set without communicator='sparse_rs'",
    "bucket-order-needs-buckets": "bucket_order set without bucket_bytes",
    "stream-needs-buckets": "stream_exchange without bucket_bytes",
    "stream-vs-resilience": "stream_exchange cannot thread resilience state",
    "stream-vs-hier":
        "stream_exchange composes over the dense-ICI hier leg only "
        "(allgather, loop/vmap decode, no ctrl/fed)",
    "stream-vs-fed": "stream_exchange hooks a path the fed round never runs",
    "resilience-knobs-disengaged": "resilience knob(s) without resilience=True",
    "resilience-vs-owner-communicator":
        "participation mask cannot re-own this communicator's shards "
        "(qar; sparse_rs adaptive/sketch routes)",
    "chaos-needs-checksum": "chaos injection without payload_checksum",
    "checksum-needs-fused-allgather":
        "payload_checksum outside the fused allgather wire format",
    "hier-knobs-disengaged": "hier knob(s) without hier=True",
    "hier-vs-ring": "ring hop schedule addresses ici replicas under hier",
    "hier-vs-resilience": "per-worker mask cannot mask a slice-mean psum",
    "hier-dcn-auto-needs-topk":
        "hier_dcn='auto' rewrites among plain top-k routes only",
    "rs-oktopk-vs-approx-topk":
        "approximate candidates break the oktopk threshold-count containment",
    "fed-knobs-disengaged": "fed_* knob(s) without fed=True",
    "fed-vs-hier": "the fed round ignores the hierarchical exchange",
    "fed-vs-communicator":
        "the fed round aggregates via ONE fused psum; communicator unused",
    "fed-vs-buckets": "the fed round's TreeCodec path ignores bucket_bytes",
    "fed-vs-decode-strategy":
        "the fed round has no gathered-worker decode to restructure",
    "fed-vs-trainer": "Trainer runs the data-parallel exchange, not fed rounds",
    "fed-async-needs-fed": "fed_async=True without the fed round geometry",
    "fed-async-knobs-disengaged": "fed_async_* knob(s) without fed_async=True",
    "fed-async-k-range": "fed_async_k < 1 with fed_async=True",
    "fed-async-alpha-range": "fed_async_alpha < 0",
    "fed-async-latency-syntax": "fed_async_latency failed parse_latency",
    "fed-mt-needs-fed": "fed_tenants > 0 without the fed round geometry",
    "fed-mt-tenants-range": "fed_tenants < 0",
    "fed-mt-knobs-disengaged": "fed_mt_* knob(s) without fed_tenants >= 1",
    "fed-mt-async-knobs":
        "per-tenant K/alpha/latency knob(s) without fed_async=True",
    "fed-mt-k-syntax": "fed_mt_k failed the per-tenant list parse or has K < 1",
    "fed-mt-alpha-syntax":
        "fed_mt_alpha failed the per-tenant list parse or has alpha < 0",
    "fed-mt-latency-syntax": "fed_mt_latency failed parse_tenant_latency",
    "fed-mt-cohort-syntax":
        "fed_mt_cohort failed the per-tenant list parse or has a size "
        "outside [1, fed_clients_per_round]",
    "pop-needs-fed": "pop_spec without the federated serving path",
    "pop-knobs-disengaged":
        "pop_* knob(s) (or per-class latency rows) without their consumer",
    "pop-vs-mt":
        "pop_spec with fed_tenants >= 1 (per-class and per-tenant "
        "heterogeneity do not compose yet)",
    "pop-labels-range": "pop_labels/num_labels outside its legal range",
    # population spec-file rejections (population/spec.py): the spec
    # parser raises these so a typo'd population spec fails loudly instead
    # of silently serving an IID population
    "pop-spec-syntax": "population spec failed PopulationSpec parse",
    "pop-spec-range": "population spec value outside its legal range",
    "pop-latency-syntax": "a per-class latency row failed parse_latency",
    "slo-needs-fed": "slo_spec without the federated serving path",
    "slo-knobs-disengaged": "slo_* override knob(s) without slo_spec",
    "slo-window-range": "slo_window < 0",
    "slo-hysteresis-range": "slo_hysteresis < 0",
    # SLO spec-file rejections (slo/spec.py): the spec parser raises these
    # so a typo'd slo.json fails loudly instead of silently monitoring
    # nothing
    "slo-spec-syntax": "SLO spec file failed SLOSpec parse",
    "slo-spec-unknown-target": "SLO spec target not in slo.spec.TARGET_KEYS",
    "slo-spec-target-range": "SLO spec target value outside its legal range",
    "slo-spec-window-range": "SLO spec window/hysteresis tick count invalid",
    "slo-spec-tenant-override": "SLO spec per-tenant override malformed",
    "ctrl-knobs-disengaged": "ctrl_* knob(s) without ctrl=True",
    "ctrl-needs-telemetry": "ctrl=True without telemetry=True",
    "ctrl-needs-compressor": "ctrl=True with compressor='none'",
    "ctrl-vs-hier-fed": "ctrl drives the flat exchanger only",
    "profile-needs-auto-selector": "profile without any 'auto' selector",
    "profile-vs-ctrl": "profile and ctrl both own the operating point",
    # syntax checks delegated to the owning subsystem's parser
    "fault-plan-syntax": "fault_plan failed FaultPlan.parse",
    "ctrl-ladder-syntax": "ctrl_ladder failed Ladder.parse",
    # exchanger-construction rejections (comm.py): combos the config cannot
    # see alone (they need the fused/bucketed build context)
    "build-qar-codec-stack":
        "qar quantizes in-collective; codec/memory stack would be ignored",
    "build-sparse-rs-codec-stack":
        "sparse_rs routes its own top-k; codec stack would be ignored",
    "build-rs-auto-needs-workers": "rs_mode='auto' needs the static mesh size",
    "build-buckets-need-fused-allgather":
        "bucket_bytes outside the fused allgather exchange",
    "build-buckets-vs-ring": "bucket_bytes would nest two pipelines under ring",
    "build-buckets-need-compression": "bucket_bytes on the dense psum baseline",
    "build-buckets-vs-layer-pattern": "fused buckets dissolve leaf identity",
    "build-bucket-points-need-buckets": "bucket_points without bucket_bytes",
    "build-decode-strategy-needs-fused-allgather":
        "vmap/ring decode outside the fused allgather exchange",
}

# codes of the port's own rejections, which the JAX package does not make
PORT_REASON_CODES: Dict[str, str] = {
    "not-ported": "a knob value the port does not implement (or no value of the knob at all)",
    "unknown-knob": "a from_params key that is not a knob of the port",
    "knob-range": "a knob outside its range where the JAX package checks it without a code",
    "codec-pairing": "a codec pairing the JAX package refuses when it builds the codec",
}
REASON_CODES.update(PORT_REASON_CODES)


class ConfigError(ValueError):
    """A rejected configuration, tagged with a registered reason code.

    `.reason_code` is the JAX package's code where it makes the same
    rejection (else one of `PORT_REASON_CODES`); `.knob` names the offending
    field where the code does not (a range or a value not ported), and is
    the reason code otherwise."""

    def __init__(self, reason_code: str, message: str, *, knob: Optional[str] = None):
        if reason_code not in REASON_CODES:
            raise AssertionError(f"unregistered reason_code {reason_code!r}: add it to config.REASON_CODES")
        super().__init__(f"{message} [reason_code={reason_code}]")
        self.reason_code = reason_code
        self.knob = knob or reason_code


def reason_code_of(exc: BaseException) -> Optional[str]:
    """The rejection code of a config or build error, or None."""
    return getattr(exc, "reason_code", None)


# knob -> the values the port implements
_SUPPORTED = {
    "compressor": ("topk", "topk_sampled", "randomk", "threshold", "none"),
    "approx_topk": (False, True),
    "memory": ("residual", "none"),
    "communicator": ("allgather", "allreduce", "qar", "sparse_rs"),
    "rs_mode": ("sparse", "adaptive", "quantized", "sketch", "oktopk", "auto"),
    "deepreduce": (None, "value", "index", "both"),
    "fused": (True, False),
}
DECODE_STRATEGIES = ("loop", "vmap", "ring")
HIER_ICI_LEGS = ("dense", "qar", "auto")
HIER_DCN_MODES = ("config", "auto")
BUCKET_ORDERS = ("trace", "reverse")
# codec knobs, read only when a codec runs (deepreduce is not None): every
# codec of the JAX package. huffman, gzip, polyfit_host and the *_native
# codecs (through the C++ host library, `native/`) run on the host, and
# the exact conflict_sets policy only under index='bloom_native', as there
_SUPPORTED_CODEC = {
    "index": ("bloom", "integer", "rle", "huffman", "bloom_native", "integer_native"),
    "value": ("qsgd", "polyfit", "doubleexp", "polyseg", "countsketch", "gzip", "polyfit_host"),
    "policy": ("p0", "leftmost", "random", "conflict_sets_approx", "conflict_sets"),
    "bloom_blocked": ("mod", "hash", True, False),
    "code": ("fbp", "varint", "pfor"),
}
# the resilience knobs with their disengaged values, in the JAX package's order
_RESILIENCE_KNOBS = (
    ("drop_rate", 0.0),
    ("fault_plan", None),
    ("payload_checksum", False),
    ("chaos_drop_rate", 0.0),
    ("chaos_corrupt_rate", 0.0),
    ("chaos_truncate_rate", 0.0),
)
# reference-style aliases of `from_params` (the JAX package's _KEY_MAP)
_KEY_MAP = {"threshold": "threshold_val", "micro-benchmark": "micro_benchmark"}


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
    # the C++ integer family member of index='integer_native' (the
    # reference op's string attr `code`, integer_compression.cc:62)
    code: str = "fbp"
    poly_degree: int = 5
    quantum_num: int = 127
    bucket_size: int = 512
    sort: bool = False
    seed: int = 0
    # one uint8 buffer and one all_gather for every tensor of a step (False:
    # one all_gather per tensor, the reference's shape)
    fused: bool = True
    # how the W gathered payloads become one aggregate: 'loop' decodes them
    # in worker order, 'vmap' in groups of `decode_batch` rows, 'ring'
    # passes the buffer W - 1 hops around the workers, decoding each chunk
    # while the next one travels (comm_ring.py)
    decode_strategy: str = "loop"
    decode_batch: int = 4
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
    # the count sketch of rs_mode='sketch': rows of the table, and its
    # columns (0: about 2k / rows, `costmodel.sketch_cols`)
    rs_sketch_rows: int = 5
    rs_sketch_cols: int = 0
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
    # the reference's 'micro-benchmark' mode: `TensorCodec.micro_benchmark`
    # prints its per-stage times and relative volumes (observability only)
    micro_benchmark: bool = False
    # telemetry (telemetry/): the Trainer's on-device `MetricAccumulators`
    # (and the FedSim state's), added to every step without a host sync and
    # fetched to the host every `telemetry_every` steps. Off by default:
    # the telemetry-off step runs exactly the ops it runs without the
    # subsystem.
    telemetry: bool = False
    telemetry_every: int = 10
    # the resilience subsystem (resilience/): a participation mask from
    # i.i.d. dropout at `drop_rate` and the `fault_plan` schedule
    # ('worker@start:stop' or 'worker@step', comma-separated), a checksum
    # word after every payload, and chaos at the wire boundary (each
    # payload dropped, byte-corrupted or truncated at these rates). Every
    # knob needs resilience=True, chaos needs the checksum.
    resilience: bool = False
    drop_rate: float = 0.0
    fault_plan: Optional[str] = None
    payload_checksum: bool = False
    chaos_drop_rate: float = 0.0
    chaos_corrupt_rate: float = 0.0
    chaos_truncate_rate: float = 0.0
    # the two-tier exchange (parallel/hierarchical.py): the slice mean over
    # the fast intra-node group first ('dense': a float32 all_reduce; 'qar':
    # the int8 quantized allreduce; 'auto': the cost model's pick), then the
    # exchange this config describes across slices only ('config'), or the
    # cross-slice route the cost model picks ('auto'). `ici_size` is the
    # workers a slice, with which the Trainer splits one group in two.
    hier: bool = False
    ici_size: Optional[int] = None
    hier_ici: str = "dense"
    hier_dcn: str = "config"
    # a machine profile (`costmodel.MachineProfile` JSON) the 'auto'
    # selectors price their choice with instead of the static constants
    profile: Optional[str] = None
    # the federated simulation (fedsim/): population-scale rounds over a
    # residual bank of `fed_num_clients` clients, `fed_clients_per_round`
    # sampled a round, each `fed_local_steps` local SGD steps; the server
    # step `fed_server_lr` times the live mean; the batched cohort in blocks
    # of `fed_client_chunk` clients (0: one block). Off by default.
    fed: bool = False
    fed_num_clients: int = 0
    fed_clients_per_round: int = 0
    fed_local_steps: int = 1
    fed_server_lr: float = 1.0
    fed_client_chunk: int = 0
    # asynchronous buffered aggregation (FedBuff-style): an ingest tick that
    # buffers staleness-weighted deltas, applying once `fed_async_k` live
    # contributions arrived; 1/(1+tau)^alpha weighting; the latency
    # distribution over tau = 0, 1, ... ("0.6,0.3,0.1"; "" = zero latency)
    fed_async: bool = False
    fed_async_k: int = 0
    fed_async_alpha: float = 0.0
    fed_async_latency: str = ""
    # multi-tenant serving: T populations stacked through the one tick (0 =
    # the single-tenant driver), with per-tenant K / alpha / latency rows
    # (';'-separated) / effective cohorts ("" = the global value)
    fed_tenants: int = 0
    fed_mt_k: str = ""
    fed_mt_alpha: str = ""
    fed_mt_latency: str = ""
    fed_mt_cohort: str = ""
    # the heterogeneous population (population/): a `PopulationSpec` file
    # path or inline JSON object, and its label-universe override (0 keeps
    # the spec's)
    pop_spec: Optional[str] = None
    pop_labels: int = 0
    # the SLO health monitor (slo/): an `SLOSpec` JSON path, and its window
    # and hysteresis overrides (0 keeps the spec's)
    slo_spec: Optional[str] = None
    slo_window: int = 0
    slo_hysteresis: int = 0
    # the adaptive compression controller (controller/): every
    # `telemetry_every` steps the Trainer hands the fetched accumulators'
    # window to a host-side controller that moves compress_ratio / fpr one
    # rung along `ctrl_ladder` ('ratio' or 'ratio@fpr' entries, strictly
    # increasing ratios). It votes up below `ctrl_target_err_cos` or above
    # `ctrl_saturation_ceiling` saturated payloads a step, down above the
    # target plus `ctrl_headroom`, and moves after `ctrl_hysteresis`
    # consecutive votes one way. One exchanger per rung visited. Needs
    # telemetry=True; off by default.
    ctrl: bool = False
    ctrl_ladder: str = "0.005,0.01,0.02,0.05"
    ctrl_target_err_cos: float = 0.97
    ctrl_headroom: float = 0.015
    ctrl_saturation_ceiling: float = 1e9
    ctrl_hysteresis: int = 2

    def __post_init__(self):
        checked = dict(_SUPPORTED, **(_SUPPORTED_CODEC if self.deepreduce is not None else {}))
        for knob, allowed in checked.items():
            val = getattr(self, knob)
            # `is` for the booleans: 1 == True would let 1 through
            if not any(val is a or (type(val) is type(a) and val == a) for a in allowed):
                raise ConfigError(
                    "not-ported",
                    f"{knob}={val!r} is not ported to deepreduce_tpu_torch yet (supported: {list(allowed)})",
                    knob=knob,
                )
        for knob, ok, what in (
            ("compress_ratio", 0.0 < self.compress_ratio <= 1.0, "must lie in (0, 1]"),
            ("fpr", self.fpr is None or 0.0 < self.fpr < 1.0, "must lie in (0, 1)"),
            ("quantum_num", 0 < self.quantum_num <= 127, "must lie in [1, 127] (int8 levels)"),
            ("bucket_size", self.bucket_size > 0, "must be positive"),
            ("topk_sample_size", self.topk_sample_size > 0, "must be positive"),
            ("topk_undershoot", self.topk_undershoot > 0.0, "must be positive"),
            ("bloom_threshold_insert", isinstance(self.bloom_threshold_insert, bool), "must be a bool"),
            ("sort", isinstance(self.sort, bool), "must be a bool"),
            ("poly_degree", self.poly_degree >= 0, "must be non-negative"),
            ("micro_benchmark", isinstance(self.micro_benchmark, bool), "must be a bool"),
        ):
            if not ok:
                raise ConfigError("knob-range", f"{knob} {what}, got {getattr(self, knob)!r}", knob=knob)
        if self.deepreduce is not None:
            self._check_host_codecs()

        self._check_in_collective()
        self._check_decode()
        self._check_buckets()
        self._check_resilience()
        self._check_hier()
        self._check_fed()
        self._check_ctrl()
        if self.profile is not None:
            if "auto" not in (self.rs_mode, self.hier_ici, self.hier_dcn):
                raise ConfigError(
                    "profile-needs-auto-selector",
                    f"profile={self.profile!r} prices the 'auto' selections and would be silently ignored with "
                    "every selector explicit: set rs_mode='auto' or hier_ici/hier_dcn='auto' (or drop profile)",
                )
            if self.ctrl:
                raise ConfigError(
                    "profile-vs-ctrl",
                    "profile and ctrl=True both own the operating point: the controller moves compress_ratio "
                    "along its ladder while the profile re-prices the 'auto' route choice at that ratio, so "
                    "the two would fight — use one or the other",
                )

    def _check_host_codecs(self) -> None:
        """The pairings the JAX package refuses: the exact P2 policy off the
        C++ library (`codecs/bloom.py`'s BloomMeta) and bloom_native in
        'both' mode (`wrappers.py`'s TensorCodec)."""
        if self.policy == "conflict_sets" and self.index != "bloom_native" and self.deepreduce in ("index", "both"):
            raise ConfigError(
                "codec-pairing",
                "exact conflict_sets (P2) is native-only, as in the reference (policies.hpp:43-146): use "
                "index='bloom_native', or policy='conflict_sets_approx' for the in-graph parallel redesign",
                knob="policy",
            )
        if self.deepreduce == "both" and self.index == "bloom_native":
            raise ConfigError(
                "codec-pairing",
                "bloom_native is index-mode only: its C++ wire format carries values in-band, so a value codec "
                "on top would transmit them twice — use index='bloom' for 'both' mode",
                knob="index",
            )

    def _check_in_collective(self) -> None:
        """The sparse_rs knobs' ranges and the fences of the in-collective
        communicators (the JAX package raises the codec-stack ones when the
        exchanger is built)."""
        if self.rs_mode != "sparse" and self.communicator != "sparse_rs":
            raise ConfigError(
                "rs-mode-needs-sparse-rs",
                f"rs_mode={self.rs_mode!r} selects a sparse_rs route and would be silently ignored "
                f"with communicator={self.communicator!r}: use communicator='sparse_rs'",
            )
        b = self.rs_oktopk_bins
        for code, knob, ok, what in (
            ("rs-block-size-range", "rs_block_size", self.rs_block_size >= 4 and self.rs_block_size % 4 == 0,
             "must be a positive multiple of 4 (int8 levels ride 4 per f32 lane)"),
            ("rs-density-threshold-range", "rs_density_threshold", 0.0 <= self.rs_density_threshold <= 1.0,
             "must lie in [0, 1]"),
            ("rs-sketch-rows-range", "rs_sketch_rows", self.rs_sketch_rows >= 1, "must be >= 1"),
            ("rs-sketch-cols-range", "rs_sketch_cols", self.rs_sketch_cols >= 0,
             "must be >= 1, or 0 to size it at about 2k / rows"),
            ("rs-oktopk-bins-range", "rs_oktopk_bins", 64 <= b <= (1 << 24) and not b & (b - 1),
             "must be a power of two in [64, 2**24]"),
            ("rs-oktopk-cap-headroom-range", "rs_oktopk_cap_headroom", self.rs_oktopk_cap_headroom > 0.0,
             "must be positive"),
        ):
            if not ok:
                raise ConfigError(code, f"{knob} {what}, got {getattr(self, knob)!r}", knob=knob)
        if self.rs_mode == "oktopk" and self.approx_topk:
            raise ConfigError(
                "rs-oktopk-vs-approx-topk",
                "rs_mode='oktopk' solves its global threshold against the all-reduced candidate histogram, which "
                "is only unbiased when the local candidate set is the exact top-k; approx_topk=True can miss "
                "above-threshold entries and skew the survivor count: use exact top-k with oktopk",
            )
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

    def _check_decode(self) -> None:
        if self.decode_strategy not in DECODE_STRATEGIES:
            raise ConfigError(
                "enum-decode_strategy",
                f"decode_strategy must be one of {DECODE_STRATEGIES}, got {self.decode_strategy!r}",
                knob="decode_strategy",
            )
        if self.decode_batch < 1:
            raise ConfigError("decode-batch-range", f"decode_batch must be >= 1, got {self.decode_batch}")
        if self.telemetry_every < 1:
            raise ConfigError("telemetry-every-range", f"telemetry_every must be >= 1, got {self.telemetry_every}")

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
        if self.stream_exchange and self.resilience:
            raise ConfigError(
                "stream-vs-resilience",
                "stream_exchange=True exchanges each bucket from a backward hook, which does not thread the "
                "resilience subsystem's participation mask, chaos or checksum state: run streaming without "
                "resilience, or the barrier or pipelined schedule with it",
            )
        if self.stream_exchange and self.hier and not (
            self.communicator == "allgather" and self.hier_ici == "dense" and self.hier_dcn == "config"
            and self.decode_strategy in ("loop", "vmap")
            and not self.ctrl and not self.fed and not self.fed_async and self.fed_tenants == 0
        ):
            raise ConfigError(
                "stream-vs-hier",
                "stream_exchange=True over hier=True composes only as the dense slice mean and the config-pinned "
                "bucketed allgather across slices (communicator='allgather', hier_ici='dense', "
                "hier_dcn='config', decode_strategy 'loop' or 'vmap'): this config restructures a leg the "
                "backward hooks run",
            )
        if self.stream_exchange and self.fed:
            raise ConfigError(
                "stream-vs-fed",
                "stream_exchange=True hooks the Trainer's per-step backward pass; the federated round (fed=True) "
                "aggregates client deltas through its own batched path and would silently ignore it — drop one "
                "of the two",
            )

    def _check_resilience(self) -> None:
        """The resilience fences, in the JAX package's order and under its
        codes."""
        for knob in ("drop_rate", "chaos_drop_rate", "chaos_corrupt_rate", "chaos_truncate_rate"):
            rate = getattr(self, knob)
            if not 0.0 <= rate <= 1.0:
                raise ConfigError("resilience-rate-range", f"{knob} must be in [0, 1], got {rate}")
        engaged = [knob for knob, default in _RESILIENCE_KNOBS if getattr(self, knob) != default]
        if engaged and not self.resilience:
            raise ConfigError(
                "resilience-knobs-disengaged",
                f"{', '.join(engaged)} configure the resilience subsystem and would be silently ignored with "
                "resilience=False: set resilience=True (or drop the knob(s))",
            )
        if self.resilience and self.communicator not in ("allgather", "allreduce"):
            # the flat, loop-decoded sparse_rs routes re-own a dropped
            # worker's shard (sparse_rs.owner_permutation); qar sums every
            # worker's levels in one reduce-scatter and the adaptive lanes
            # are per-worker wire state no deputy can serve
            reowned = (
                self.communicator == "sparse_rs"
                and self.rs_mode in ("sparse", "quantized", "oktopk", "auto")
                and not self.hier
                and not self.stream_exchange
                and self.decode_strategy == "loop"
                and self.bucket_bytes is None
                and not self.fed
                and not self.fed_async
                and self.fed_tenants == 0
            )
            if not reowned:
                raise ConfigError(
                    "resilience-vs-owner-communicator",
                    "resilience=True threads a participation mask through the exchange, which the allgather "
                    "and allreduce communicators and the flat loop-decoded sparse_rs routes (sparse, quantized, "
                    f"oktopk) support: communicator={self.communicator!r} with this shape makes every worker a "
                    "shard owner with no re-ownership path, so a dropped worker would black-hole its shard",
                )
        chaos_on = self.chaos_drop_rate > 0 or self.chaos_corrupt_rate > 0 or self.chaos_truncate_rate > 0
        if chaos_on and not self.payload_checksum:
            raise ConfigError(
                "chaos-needs-checksum",
                "chaos_*_rate perturbs payloads at the wire boundary; without payload_checksum=True the damage "
                "decodes silently instead of degrading to a counted zero contribution: enable payload_checksum",
            )
        if self.payload_checksum and not (self.fused and self.communicator == "allgather"):
            raise ConfigError(
                "checksum-needs-fused-allgather",
                "payload_checksum appends a checksum word to the fused buffer's wire format and would be "
                f"silently ignored here (communicator={self.communicator!r}, fused={self.fused}): use "
                "fused=True with communicator='allgather'",
            )
        if self.fault_plan is not None:
            from deepreduce_tpu_torch.resilience.faults import FaultPlan

            try:
                FaultPlan.parse(self.fault_plan)
            except ValueError as e:
                raise ConfigError("fault-plan-syntax", str(e)) from e

    def _check_hier(self) -> None:
        """The hierarchical exchange's fences, in the JAX package's order and
        under its codes."""
        for knob, allowed in (("hier_ici", HIER_ICI_LEGS), ("hier_dcn", HIER_DCN_MODES)):
            if getattr(self, knob) not in allowed:
                raise ConfigError(f"enum-{knob}", f"{knob} must be one of {allowed}, got {getattr(self, knob)!r}")
        if self.ici_size is not None and self.ici_size < 1:
            raise ConfigError("ici-size-range", f"ici_size must be >= 1 or None, got {self.ici_size}")
        engaged = [knob for knob, default in (("ici_size", None), ("hier_ici", "dense"), ("hier_dcn", "config"))
                   if getattr(self, knob) != default]
        if engaged and not self.hier:
            raise ConfigError(
                "hier-knobs-disengaged",
                f"{', '.join(engaged)} configure the hierarchical exchange and would be silently ignored with "
                "hier=False: set hier=True (or drop the knob(s))",
            )
        if self.hier and self.decode_strategy == "ring":
            raise ConfigError(
                "hier-vs-ring",
                "hier=True cannot use decode_strategy='ring': the ring's hops are sized from the flat worker "
                "count, but the cross-slice leg runs over the slices only, so a hop would address a replica of "
                "the same slice: use 'loop' or 'vmap'",
            )
        if self.hier and self.resilience:
            raise ConfigError(
                "hier-vs-resilience",
                "resilience=True threads a per-worker participation mask through the exchange, but hier=True "
                "exchanges per slice: the slice mean is an unmasked all_reduce, so a dropped worker would poison "
                "its slice's mean instead of degrading gracefully",
            )
        if self.hier and self.hier_dcn == "auto" and (self.deepreduce is not None or self.compressor != "topk"):
            raise ConfigError(
                "hier-dcn-auto-needs-topk",
                "hier_dcn='auto' rewrites the cross-slice route among the plain top-k fused allgather and the "
                "sparse_rs routes, which need compressor='topk' and no deepreduce wrapper: got "
                f"compressor={self.compressor!r}, deepreduce={self.deepreduce!r}; use hier_dcn='config' to run "
                "this codec stack across slices as it is",
            )

    def _check_fed(self) -> None:
        """The federated simulation's fences, in the JAX package's order and
        under its codes: the round geometry, the knobs the round would
        silently ignore, the async, multi-tenant, population and SLO knobs."""
        fed_engaged = [
            name for name, default in (("fed_num_clients", 0), ("fed_clients_per_round", 0), ("fed_local_steps", 1),
                                       ("fed_server_lr", 1.0), ("fed_client_chunk", 0))
            if getattr(self, name) != default
        ]
        if fed_engaged and not self.fed:
            raise ConfigError(
                "fed-knobs-disengaged",
                f"{', '.join(fed_engaged)} configure the federated simulation subsystem and would be silently "
                "ignored with fed=False — set fed=True (or drop the knob(s))",
            )
        if self.fed:
            for code, ok, msg in (
                ("fed-population-range", self.fed_num_clients > 0,
                 f"fed=True requires a positive fed_num_clients population, got {self.fed_num_clients}"),
                ("fed-cohort-range", self.fed_clients_per_round > 0,
                 f"fed=True requires a positive fed_clients_per_round cohort, got {self.fed_clients_per_round}"),
                ("fed-cohort-exceeds-population", self.fed_clients_per_round <= self.fed_num_clients,
                 f"fed_clients_per_round={self.fed_clients_per_round} exceeds fed_num_clients="
                 f"{self.fed_num_clients} — cohorts are sampled without replacement"),
                ("fed-local-steps-range", self.fed_local_steps > 0,
                 f"fed_local_steps must be positive, got {self.fed_local_steps}"),
                ("fed-server-lr-range", self.fed_server_lr > 0,
                 f"fed_server_lr must be positive, got {self.fed_server_lr}"),
                ("fed-client-chunk-range", self.fed_client_chunk >= 0,
                 f"fed_client_chunk must be >= 0 (0 = one batched block), got {self.fed_client_chunk}"),
                ("fed-chunk-divides-cohort",
                 not (self.fed_client_chunk > 0 and self.fed_clients_per_round % self.fed_client_chunk),
                 f"fed_client_chunk={self.fed_client_chunk} must divide fed_clients_per_round="
                 f"{self.fed_clients_per_round} (the chunked cohort needs equal blocks)"),
                ("fed-vs-hier", not self.hier,
                 "fed=True aggregates client deltas through the fedsim round's single fused all_reduce; the "
                 "hierarchical two-leg exchange (hier=True) would be silently ignored — drop one of the two"),
                ("fed-vs-communicator", self.communicator == "allgather",
                 f"communicator={self.communicator!r} selects a gathered-worker exchange the federated round "
                 "never runs (its aggregate is ONE fused all_reduce; compression is the TreeCodec pair) — keep "
                 "the default communicator='allgather' with fed=True"),
                ("fed-vs-buckets", self.bucket_bytes is None,
                 "bucket_bytes partitions the fused gathered-worker exchange; the federated round compresses per "
                 "leaf through the path-keyed TreeCodec and would silently ignore it — use bucket_bytes=None "
                 "with fed=True"),
                ("fed-vs-decode-strategy", self.decode_strategy == "loop",
                 f"decode_strategy={self.decode_strategy!r} restructures the gathered-worker decode of the flat "
                 "exchange; the federated round decodes one summed TreeCodec payload and would silently ignore "
                 "it — keep the default 'loop' with fed=True"),
            ):
                if not ok:
                    raise ConfigError(code, msg)
        from deepreduce_tpu_torch.fedsim.round import (
            parse_class_latency,
            parse_latency,
            parse_tenant_floats,
            parse_tenant_latency,
        )

        async_engaged = [name for name, default in (("fed_async_k", 0), ("fed_async_alpha", 0.0),
                                                    ("fed_async_latency", "")) if getattr(self, name) != default]
        if async_engaged and not self.fed_async:
            raise ConfigError(
                "fed-async-knobs-disengaged",
                f"{', '.join(async_engaged)} configure the asynchronous buffered aggregation and would be silently "
                "ignored with fed_async=False — set fed_async=True (or drop the knob(s))",
            )
        if self.fed_async:
            if not self.fed:
                raise ConfigError(
                    "fed-async-needs-fed",
                    "fed_async=True buffers the federated round's client deltas across ingest ticks — there is no "
                    "round to buffer without fed=True (set the fed_* geometry too)",
                )
            if self.fed_async_k < 1:
                raise ConfigError("fed-async-k-range",
                                  f"fed_async=True requires a positive apply threshold fed_async_k, got {self.fed_async_k}")
            if self.fed_async_alpha < 0:
                raise ConfigError(
                    "fed-async-alpha-range",
                    f"fed_async_alpha is a down-weighting exponent 1/(1+tau)^alpha and must be >= 0, got "
                    f"{self.fed_async_alpha}",
                )
            try:
                parse_latency(self.fed_async_latency)
            except ValueError as e:
                raise ConfigError("fed-async-latency-syntax", str(e)) from e
        if self.fed_tenants < 0:
            raise ConfigError("fed-mt-tenants-range",
                              f"fed_tenants must be >= 0 (0 = single-tenant driver), got {self.fed_tenants}")
        mt_engaged = [n for n in ("fed_mt_k", "fed_mt_alpha", "fed_mt_latency", "fed_mt_cohort") if getattr(self, n) != ""]
        if mt_engaged and self.fed_tenants < 1:
            raise ConfigError(
                "fed-mt-knobs-disengaged",
                f"{', '.join(mt_engaged)} configure per-tenant knobs of the multi-tenant federated driver and would "
                "be silently ignored with fed_tenants=0 — set fed_tenants >= 1 (or drop the knob(s))",
            )
        if self.fed_tenants >= 1:
            if not self.fed:
                raise ConfigError(
                    "fed-mt-needs-fed",
                    "fed_tenants >= 1 stacks T federated populations through the one round tick — there is no round "
                    "to stack without fed=True (set the fed_* geometry too)",
                )
            async_knobs = [n for n in ("fed_mt_k", "fed_mt_alpha", "fed_mt_latency") if getattr(self, n) != ""]
            if async_knobs and not self.fed_async:
                raise ConfigError(
                    "fed-mt-async-knobs",
                    f"{', '.join(async_knobs)} configure the per-tenant buffered-async knobs (K / alpha / latency) "
                    "and would be silently ignored with fed_async=False — set fed_async=True (or drop the knob(s))",
                )
            T = self.fed_tenants
            try:
                ks = parse_tenant_floats(self.fed_mt_k, T, "fed_mt_k", float(self.fed_async_k))
            except ValueError as e:
                raise ConfigError("fed-mt-k-syntax", str(e)) from e
            if self.fed_async and any(k < 1 for k in ks):
                raise ConfigError("fed-mt-k-syntax",
                                  f"fed_mt_k={self.fed_mt_k!r}: every per-tenant apply threshold must be >= 1")
            try:
                alphas = parse_tenant_floats(self.fed_mt_alpha, T, "fed_mt_alpha", self.fed_async_alpha)
            except ValueError as e:
                raise ConfigError("fed-mt-alpha-syntax", str(e)) from e
            if any(a < 0 for a in alphas):
                raise ConfigError("fed-mt-alpha-syntax",
                                  f"fed_mt_alpha={self.fed_mt_alpha!r}: every per-tenant staleness exponent must be >= 0")
            try:
                parse_tenant_latency(self.fed_mt_latency, T, self.fed_async_latency)
            except ValueError as e:
                raise ConfigError("fed-mt-latency-syntax", str(e)) from e
            try:
                cohorts = parse_tenant_floats(self.fed_mt_cohort, T, "fed_mt_cohort", float(self.fed_clients_per_round))
            except ValueError as e:
                raise ConfigError("fed-mt-cohort-syntax", str(e)) from e
            if any(c < 1 or c > self.fed_clients_per_round or c != int(c) for c in cohorts):
                raise ConfigError(
                    "fed-mt-cohort-syntax",
                    f"fed_mt_cohort={self.fed_mt_cohort!r}: every per-tenant effective cohort must be an integer in "
                    f"[1, fed_clients_per_round={self.fed_clients_per_round}]",
                )
        if self.pop_labels != 0 and self.pop_spec is None:
            raise ConfigError(
                "pop-knobs-disengaged",
                f"pop_labels={self.pop_labels} overrides the population spec's label universe and would be "
                "silently ignored with pop_spec=None — set pop_spec (or drop the knob)",
            )
        if self.pop_spec is not None:
            if not self.fed:
                raise ConfigError(
                    "pop-needs-fed",
                    "pop_spec assigns the federated client population to heterogeneity classes — there is no "
                    "population to classify with fed=False (set the fed_* geometry too)",
                )
            if self.fed_tenants >= 1:
                raise ConfigError(
                    "pop-vs-mt",
                    "pop_spec with fed_tenants >= 1: per-class and per-tenant heterogeneity do not compose yet — "
                    "the class-id vector is sharded with the single-tenant residual bank. Run populations "
                    "single-tenant (or drop pop_spec)",
                )
            if self.pop_labels < 0 or self.pop_labels == 1:
                raise ConfigError("pop-labels-range",
                                  f"pop_labels must be 0 (keep the spec value) or >= 2, got {self.pop_labels}")
            from deepreduce_tpu_torch.population.spec import PopulationSpec

            spec = PopulationSpec.load_any(self.pop_spec)
            if spec.latency_on and not self.fed_async:
                raise ConfigError(
                    "pop-knobs-disengaged",
                    "the population spec carries per-class latency row(s), which configure the async staleness "
                    "draw and would be silently ignored with fed_async=False — set fed_async=True (or drop the "
                    "class latency rows)",
                )
            if spec.latency_on:
                try:
                    parse_class_latency([c.latency for c in spec.classes], self.fed_async_latency)
                except ConfigError:
                    raise
                except ValueError as e:
                    raise ConfigError("pop-latency-syntax", str(e)) from e
        slo_engaged = [n for n in ("slo_window", "slo_hysteresis") if getattr(self, n) != 0]
        if slo_engaged and self.slo_spec is None:
            raise ConfigError(
                "slo-knobs-disengaged",
                f"{', '.join(slo_engaged)} override the SLO spec windows and would be silently ignored with "
                "slo_spec=None — set slo_spec (or drop the knob(s))",
            )
        if self.slo_spec is not None:
            if not self.fed:
                raise ConfigError(
                    "slo-needs-fed",
                    "slo_spec configures the serving health monitor, which consumes the federated tick report "
                    "stream — it has nothing to watch with fed=False",
                )
            if self.slo_window < 0:
                raise ConfigError("slo-window-range",
                                  f"slo_window must be >= 0 (0 keeps the spec value), got {self.slo_window}")
            if self.slo_hysteresis < 0:
                raise ConfigError("slo-hysteresis-range",
                                  f"slo_hysteresis must be >= 0 (0 keeps the spec value), got {self.slo_hysteresis}")

    def _check_ctrl(self) -> None:
        """The adaptive controller's fences, in the JAX package's order and
        under its codes."""
        ctrl_engaged = [
            name for name in ("ctrl_ladder", "ctrl_target_err_cos", "ctrl_headroom", "ctrl_saturation_ceiling",
                              "ctrl_hysteresis")
            if getattr(self, name) != getattr(type(self), name)
        ]
        if ctrl_engaged and not self.ctrl:
            raise ConfigError(
                "ctrl-knobs-disengaged",
                f"{', '.join(ctrl_engaged)} configure the adaptive compression controller and would be silently "
                "ignored with ctrl=False — set ctrl=True (or drop the knob(s))",
            )
        if not self.ctrl:
            return
        if not self.telemetry:
            raise ConfigError(
                "ctrl-needs-telemetry",
                "ctrl=True requires telemetry=True: the controller consumes the MetricAccumulators fetch and adds "
                "no syncs of its own",
            )
        if self.compressor == "none":
            raise ConfigError(
                "ctrl-needs-compressor",
                "ctrl=True has nothing to tune with compressor='none' (no sparsifier budget); pick a sparsifying "
                "compressor",
            )
        if self.hier or self.fed:
            raise ConfigError(
                "ctrl-vs-hier-fed",
                "ctrl=True drives the flat GradientExchanger only — it cannot rebuild the hierarchical or "
                "federated pipelines per rung (hier=False, fed=False required)",
            )
        for code, knob, ok, what in (
            ("ctrl-target-range", "ctrl_target_err_cos", 0.0 < self.ctrl_target_err_cos <= 1.0, "must be in (0, 1]"),
            ("ctrl-headroom-range", "ctrl_headroom", self.ctrl_headroom >= 0.0, "must be >= 0"),
            ("ctrl-saturation-range", "ctrl_saturation_ceiling", self.ctrl_saturation_ceiling >= 0.0,
             "must be >= 0"),
            ("ctrl-hysteresis-range", "ctrl_hysteresis", self.ctrl_hysteresis >= 1, "must be >= 1"),
        ):
            if not ok:
                raise ConfigError(code, f"{knob} {what}, got {getattr(self, knob)}")
        # the ladder's syntax at construction (ladder.py imports this module)
        from deepreduce_tpu_torch.controller.ladder import Ladder

        try:
            Ladder.parse(self.ctrl_ladder)
        except ValueError as e:
            raise ConfigError("ctrl-ladder-syntax", str(e)) from e

    def fed_config(self):
        """The round-geometry view of the fed_* knobs."""
        if not self.fed:
            raise ValueError("fed_config() requires fed=True")
        from deepreduce_tpu_torch.fedsim.round import FedConfig

        return FedConfig(num_clients=self.fed_num_clients, clients_per_round=self.fed_clients_per_round,
                         local_steps=self.fed_local_steps, server_lr=self.fed_server_lr)

    def codec_params(self) -> Dict[str, Any]:
        return {
            "fpr": self.fpr,
            "policy": self.policy,
            "bloom_blocked": self.bloom_blocked,
            "bloom_threshold_insert": self.bloom_threshold_insert,
            "code": self.code,
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
                "unknown-knob", f"{key!r} is not a knob of deepreduce_tpu_torch (known: {sorted(fields)})", knob=key
            )
        kwargs[key] = val
    return DeepReduceConfig(**kwargs)
