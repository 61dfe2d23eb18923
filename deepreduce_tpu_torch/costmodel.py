"""The cost model of the exchange routes, copied from
`deepreduce_tpu/costmodel.py` (all of it: the machine profiles, the
flat and W-aware step-time models, the federated round estimators, the
sparse_rs wire accounting with its `sketch` row, the `rs_mode='auto'`
selector `select_rs_mode`, the two-tier ICI x DCN model with its planner
`select_hier_plan`, and `calibrate` with its span tables, which fits a
profile from a tracking run directory the port's telemetry writes), so
that the port imports nothing of the JAX package. The code below is the
JAX package's, unchanged: every selector picks what the JAX package picks
and every byte count equals its own (`tests/test_torch_costmodel.py` holds
them equal with `==`), a profile the JAX package wrote (`PROFILE_SCHEMA`)
loads here, and `calibrate` fits the record the JAX package fits from the
same run directory (`tests/test_torch_calibrate.py`).

What follows is the JAX module's own description.

Shared wire/compute cost model for exchange-mode selection and bench.

One implementation of the step-time model that bench.py previously
duplicated inline (`T = payload_bytes/BW + t_enc + t_dec` at a 100 Mbps
default link), plus the W-aware extensions the in-collective reduction
sweep and the ``rs_mode="auto"`` selector need.

Two families of estimators live here:

- **Flat (W-independent)** — `exchange_time(m, bw)`: the historical bench
  model. Payload bytes are the per-worker *injection* (what one worker
  puts on the wire), encode/decode measured once. This is what every
  committed BENCH_*.json before r11 reports; it stays byte-for-byte the
  same function so those numbers remain reproducible.
- **W-aware (ring)** — per-collective wire times from standard ring
  algorithm costs, and `fused_step_time` / `rs_step_time` which model what
  actually scales with W: the fused allgather path *receives* W-1 remote
  payloads and runs W decodes per step, while an in-collective route pays
  ~1x decode and ring-bounded wire. This is the model under which the
  ROADMAP target "beat drqsgd_bloom_* at W>=8" is meaningful at all — in
  the flat model W never appears.

Everything here is host-side pure python/float math: it runs at
construction time (mode selection) or in bench drivers, never under
trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

# 100 Mbps in bytes/s — the paper's federated uplink assumption, and the
# default link every committed bench record uses.
BW_100MBPS = 12.5e6

RS_MODES = ("sparse", "adaptive", "quantized", "sketch", "oktopk", "auto")


# ---------------------------------------------------------------------------
# Machine profiles — the calibrated counterpart of the static constants.
#
# Every estimator below accepts an optional ``profile=`` (a MachineProfile):
# wherever a bandwidth/compute default would have come from a hardcoded
# constant, the profile's fitted value is used instead. An explicitly passed
# bw always wins over the profile, and profile=None reproduces the historical
# constants byte-for-byte — so every committed BENCH_*.json stays replayable.
# Profiles are fitted from a tracking run dir by `calibrate()` and serialized
# as a schema-tagged JSON record with NO wall-clock fields, so a profile is
# bitwise-replayable from a committed run dir.
# ---------------------------------------------------------------------------

PROFILE_SCHEMA_V1 = "deepreduce_tpu/machine-profile/v1"
PROFILE_SCHEMA = "deepreduce_tpu/machine-profile/v2"

# the model parameters a profile carries; each is either "fitted" (recovered
# from telemetry) or "fixed" (unidentifiable in that run — held at the
# static constant and recorded as such)
PROFILE_PARAMS = ("bw_dcn", "bw_ici", "t_enc", "t_dec", "compute_time")

# keys every per-route row carries (v2 `routes` table): one encode / one
# decode in seconds plus the number of labeled span events the fit saw
ROUTE_ROW_KEYS = ("t_enc_s", "t_dec_s", "samples")

# routes whose decode runs once per received payload — the fused
# gather-then-decode family pays W decodes per step, so their fitted rows
# divide the per-step decode seconds by W (matching the t_decode_s
# convention measurement rows use). Every other route (the in-collective
# rs family, qar) decodes once per step.
GATHER_DECODE_ROUTES = frozenset({"fused", "bucketed"})


def _route_decodes_per_step(label: str, W: int) -> int:
    return W if label in GATHER_DECODE_ROUTES else 1


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Fitted (or static-default) machine parameters for the cost model.

    bw_* are link bandwidths in bytes/s; t_enc_s / t_dec_s are one encode /
    one decode in seconds (the same units the measurement rows use);
    compute_time_s is the per-step backward compute available to hide wire
    behind. `fitted` / `fixed` partition PROFILE_PARAMS by whether the run's
    telemetry identified the parameter; `source` documents the fit inputs
    (run name, measured step time, apportioned component seconds — and
    deliberately no wall-clock timestamps, so the record is deterministic)."""

    bw_dcn: float = BW_100MBPS
    bw_ici: float = 1.25e9  # == BW_ICI_10GBPS (defined below)
    t_enc_s: float = 0.0
    t_dec_s: float = 0.0
    compute_time_s: float = 0.0
    fitted: Tuple[str, ...] = ()
    fixed: Tuple[str, ...] = PROFILE_PARAMS
    routes: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    source: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        return {
            "schema": PROFILE_SCHEMA,
            "bw_dcn_bytes_per_s": float(self.bw_dcn),
            "bw_ici_bytes_per_s": float(self.bw_ici),
            "t_enc_s": float(self.t_enc_s),
            "t_dec_s": float(self.t_dec_s),
            "compute_time_s": float(self.compute_time_s),
            "fitted": list(self.fitted),
            "fixed": list(self.fixed),
            "routes": {
                label: {
                    "t_enc_s": float(row["t_enc_s"]),
                    "t_dec_s": float(row["t_dec_s"]),
                    "samples": int(row["samples"]),
                }
                for label, row in sorted(self.routes.items())
            },
            "source": dict(self.source),
        }

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "MachineProfile":
        validate_profile(rec)
        # v1 records carry no route table: they load with routes == {} and
        # every estimator/selector output stays byte-identical to r16.
        routes = {
            label: {
                "t_enc_s": float(row["t_enc_s"]),
                "t_dec_s": float(row["t_dec_s"]),
                "samples": int(row["samples"]),
            }
            for label, row in (rec.get("routes") or {}).items()
        }
        return cls(
            bw_dcn=float(rec["bw_dcn_bytes_per_s"]),
            bw_ici=float(rec["bw_ici_bytes_per_s"]),
            t_enc_s=float(rec["t_enc_s"]),
            t_dec_s=float(rec["t_dec_s"]),
            compute_time_s=float(rec["compute_time_s"]),
            fitted=tuple(rec["fitted"]),
            fixed=tuple(rec["fixed"]),
            routes=routes,
            source=dict(rec.get("source", {})),
        )

    def content_hash(self) -> str:
        """Deterministic digest of the full record — the provenance stamp
        bench.py attaches to every record priced under this profile."""
        blob = json.dumps(self.to_record(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_record(), f, indent=2, sort_keys=True)
            f.write("\n")


def static_profile() -> MachineProfile:
    """The profile that encodes exactly the static constants — by contract
    it changes NO selector's pick (pinned by the jx-calib-reselect audit)."""
    return MachineProfile()


def validate_profile(rec: Any) -> None:
    """Raise ValueError unless `rec` is a well-formed machine-profile record
    (the schema the `telemetry calibrate` CLI emits and `load_profile`
    accepts)."""
    if not isinstance(rec, dict):
        raise ValueError(f"profile record must be a dict, got {type(rec).__name__}")
    schema = rec.get("schema")
    if schema not in (PROFILE_SCHEMA, PROFILE_SCHEMA_V1):
        raise ValueError(
            f"profile schema must be {PROFILE_SCHEMA!r} (or legacy "
            f"{PROFILE_SCHEMA_V1!r}), got {schema!r}"
        )
    if schema == PROFILE_SCHEMA_V1 and "routes" in rec:
        raise ValueError("v1 profile records carry no 'routes' table")
    for key, positive in (
        ("bw_dcn_bytes_per_s", True),
        ("bw_ici_bytes_per_s", True),
        ("t_enc_s", False),
        ("t_dec_s", False),
        ("compute_time_s", False),
    ):
        v = rec.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"profile field {key!r} must be a number, got {v!r}")
        if not math.isfinite(float(v)):
            raise ValueError(f"profile field {key!r} must be finite, got {v!r}")
        if positive and float(v) <= 0:
            raise ValueError(f"profile field {key!r} must be > 0, got {v!r}")
        if not positive and float(v) < 0:
            raise ValueError(f"profile field {key!r} must be >= 0, got {v!r}")
    fitted = rec.get("fitted")
    fixed = rec.get("fixed")
    for name, val in (("fitted", fitted), ("fixed", fixed)):
        if not isinstance(val, (list, tuple)) or not all(
            isinstance(p, str) for p in val
        ):
            raise ValueError(f"profile field {name!r} must be a list of strings")
    both = list(fitted) + list(fixed)
    if sorted(both) != sorted(PROFILE_PARAMS):
        raise ValueError(
            "profile fitted+fixed must partition "
            f"{sorted(PROFILE_PARAMS)}, got fitted={list(fitted)} "
            f"fixed={list(fixed)}"
        )
    if "source" in rec and not isinstance(rec["source"], dict):
        raise ValueError("profile field 'source' must be a dict")
    routes = rec.get("routes")
    if schema == PROFILE_SCHEMA and routes is not None:
        if not isinstance(routes, dict):
            raise ValueError(
                f"profile field 'routes' must be a dict, got {type(routes).__name__}"
            )
        for label, row in routes.items():
            if not isinstance(label, str) or not label:
                raise ValueError(f"route label must be a non-empty string, got {label!r}")
            if not isinstance(row, dict):
                raise ValueError(
                    f"route row {label!r} must be a dict, got {type(row).__name__}"
                )
            extra = set(row) - set(ROUTE_ROW_KEYS)
            if extra:
                raise ValueError(
                    f"route row {label!r} has unknown keys {sorted(extra)} "
                    f"(expected exactly {list(ROUTE_ROW_KEYS)})"
                )
            for key in ("t_enc_s", "t_dec_s"):
                v = row.get(key)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise ValueError(
                        f"route row {label!r} field {key!r} must be a number, got {v!r}"
                    )
                if not math.isfinite(float(v)) or float(v) < 0:
                    raise ValueError(
                        f"route row {label!r} field {key!r} must be finite and "
                        f">= 0, got {v!r}"
                    )
            n = row.get("samples")
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise ValueError(
                    f"route row {label!r} field 'samples' must be a positive "
                    f"int, got {n!r}"
                )


def load_profile(path) -> MachineProfile:
    """Read + schema-validate a profile.json written by `MachineProfile.save`
    (or the `telemetry calibrate --out` CLI). Raises ValueError on schema
    violations, OSError on unreadable paths."""
    with open(path) as f:
        rec = json.load(f)
    return MachineProfile.from_record(rec)


def _bw_dcn(bw: Optional[float], profile: Optional[MachineProfile]) -> float:
    """Resolve a DCN bandwidth: explicit bw > profile > static constant."""
    if bw is not None:
        return bw
    if profile is not None:
        return profile.bw_dcn
    return BW_100MBPS


def _bw_ici(bw: Optional[float], profile: Optional[MachineProfile]) -> float:
    """Resolve an ICI bandwidth: explicit bw > profile > static constant."""
    if bw is not None:
        return bw
    if profile is not None:
        return profile.bw_ici
    return BW_ICI_10GBPS


def route_measurement(
    profile: Optional[MachineProfile], label: str
) -> Optional[Dict[str, float]]:
    """The profile's fitted per-route row as a flat measurement fragment
    (``{"t_encode_s", "t_decode_s"}`` — the spelling the measurement-row
    plumbing uses), or None when the profile carries no row for `label`.
    This is the join point between calibrate()'s v2 `routes` table and the
    selectors' existing `measurements` parameter."""
    if profile is None:
        return None
    row = profile.routes.get(label)
    if row is None:
        return None
    return {
        "t_encode_s": float(row["t_enc_s"]),
        "t_decode_s": float(row["t_dec_s"]),
    }


def dense_measurement(d: int) -> Dict[str, float]:
    """The uncompressed f32 baseline row (zero codec compute)."""
    return {
        "payload_bytes": 4.0 * d,
        "rel_volume": 1.0,
        "t_encode_s": 0.0,
        "t_decode_s": 0.0,
    }


def exchange_time(
    m: Dict[str, float],
    bw: Optional[float] = None,
    *,
    profile: Optional[MachineProfile] = None,
) -> float:
    """Flat per-worker step-time model: injection bytes over the link plus
    one encode and one decode. Unchanged from the pre-r11 bench.py inline
    form; every historical BENCH_*.json speedup is computed with this.
    ``profile`` substitutes a calibrated link bandwidth for the 100 Mbps
    constant (an explicit bw still wins); None keeps the historical model."""
    return m["payload_bytes"] / _bw_dcn(bw, profile) + m["t_encode_s"] + m["t_decode_s"]


# ---------------------------------------------------------------------------
# W-aware ring collective wire times (per-worker seconds on one link).
#
# Standard ring costs for message of `size` bytes per worker:
#   all_gather      — each worker receives (W-1) remote payloads
#   all_to_all      — each worker sends/receives (W-1)/W of its buffer
#   psum/allreduce  — reduce-scatter + allgather: 2*(W-1)/W of the buffer
#   psum_scatter    — reduce-scatter half alone: (W-1)/W of the buffer
# ---------------------------------------------------------------------------


def allgather_time(payload_bytes: float, W: int, bw: float = BW_100MBPS) -> float:
    return (W - 1) * payload_bytes / bw


def all_to_all_time(buffer_bytes: float, W: int, bw: float = BW_100MBPS) -> float:
    return (W - 1) / W * buffer_bytes / bw


def allreduce_time(buffer_bytes: float, W: int, bw: float = BW_100MBPS) -> float:
    return 2.0 * (W - 1) / W * buffer_bytes / bw


def reduce_scatter_time(buffer_bytes: float, W: int, bw: float = BW_100MBPS) -> float:
    return (W - 1) / W * buffer_bytes / bw


def fused_step_time(
    m: Dict[str, float],
    W: int,
    bw: Optional[float] = None,
    *,
    profile: Optional[MachineProfile] = None,
) -> float:
    """W-aware model of the fused gather-then-decode exchange: one encode,
    an allgather of the per-worker payload, then W payload decodes (own +
    W-1 remote). `m` is a flat measurement row (t_decode_s = one decode)."""
    return (
        m["t_encode_s"]
        + allgather_time(m["payload_bytes"], W, _bw_dcn(bw, profile))
        + W * m["t_decode_s"]
    )


def overlapped_step_time(
    m: Dict[str, float],
    W: int,
    bw: Optional[float] = None,
    compute_time: Optional[float] = None,
    *,
    profile: Optional[MachineProfile] = None,
) -> float:
    """Step-time model of the backprop-overlapped streaming schedule
    (``cfg.stream_exchange``): each bucket's allgather dispatches while
    backward compute for earlier layers is still running, so up to
    ``compute_time`` seconds of wire hide behind it and only the residual
    exposed tail ``max(0, wire - compute_time)`` is charged serially —
    encode and the W decodes still pay their serial cost. With
    ``compute_time=0`` this is exactly `fused_step_time` (nothing to hide
    behind), so the streamed model can never exceed the r09 pipelined
    schedule's. ``compute_time=None`` takes the profile's fitted per-step
    compute when one is given (else 0.0 — the historical model)."""
    if compute_time is None:
        compute_time = profile.compute_time_s if profile is not None else 0.0
    wire = allgather_time(m["payload_bytes"], W, _bw_dcn(bw, profile))
    exposed = max(0.0, wire - max(0.0, compute_time))
    return m["t_encode_s"] + exposed + W * m["t_decode_s"]


def overlap_fraction(
    m: Dict[str, float],
    W: int,
    bw: Optional[float] = None,
    compute_time: Optional[float] = None,
    *,
    profile: Optional[MachineProfile] = None,
) -> float:
    """Fraction of the allgather wire time hidden behind backward compute
    under the streaming schedule — the modeled counterpart of the measured
    `trace --overlap` report. 1.0 when there is no wire to expose."""
    if compute_time is None:
        compute_time = profile.compute_time_s if profile is not None else 0.0
    wire = allgather_time(m["payload_bytes"], W, _bw_dcn(bw, profile))
    if wire <= 0.0:
        return 1.0
    return min(wire, max(0.0, compute_time)) / wire


# ---------------------------------------------------------------------------
# Federated round-time model (fedsim): the paper's deployment setting is C
# client uplinks per round into one parameter server behind a shared ingest
# link. Client local compute runs in parallel across clients (it bounds the
# first arrival, not the total), so the round wall time is ingest-serialized:
# every live uplink's compressed payload crosses the server's link(s), plus
# the one S2C broadcast going out. This is what makes DeepReduce's uplink
# compression a *clients/sec* multiplier — the serving capacity of one
# server link scales inversely with per-client payload bytes.
# ---------------------------------------------------------------------------


def fed_round_time(
    uplink_bytes_per_client: float,
    clients: int,
    bw: float = BW_100MBPS,
    *,
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
) -> float:
    """Wall seconds of one federated round at `clients` live uplinks.
    `t_client_s` is one client's local-train latency (paid once — clients
    compute concurrently); `server_links` models ingest parallelism."""
    wire = clients * uplink_bytes_per_client + downlink_bytes
    return t_client_s + wire / (bw * max(server_links, 1))


def fed_clients_per_sec(
    uplink_bytes_per_client: float,
    clients: int,
    bw: float = BW_100MBPS,
    *,
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
) -> float:
    """Served clients per second at the modeled round time — the serving
    throughput the ROADMAP's million-user scenario is priced in."""
    t = fed_round_time(
        uplink_bytes_per_client,
        clients,
        bw,
        t_client_s=t_client_s,
        downlink_bytes=downlink_bytes,
        server_links=server_links,
    )
    return clients / max(t, 1e-12)


def expected_staleness(latency_probs=(1.0,)) -> float:
    """Mean staleness E[tau] of a latency distribution (unnormalized
    weights over tau = 0, 1, 2, ... — same spec `parse_latency` accepts)."""
    total = sum(latency_probs)
    if total <= 0:
        return 0.0
    return sum(i * p for i, p in enumerate(latency_probs)) / total


def fed_async_apply_time(
    uplink_bytes_per_client: float,
    k: int,
    bw: float = BW_100MBPS,
    *,
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
    overlap_depth: int = 1,
    latency_probs=(1.0,),
) -> float:
    """Wall seconds between buffered server applies in the asynchronous
    (FedBuff-style) mode. Two pipelined limits, the slower of which gates
    the apply cadence:

    - *ingest*: K live uplinks (plus the one S2C broadcast of the apply)
      must cross the server link(s) — identical shape to the synchronous
      wire term, but sized by the buffer threshold K instead of the cohort.
    - *compute*: clients of up to `overlap_depth` in-flight cohorts train
      concurrently against ring versions of the model, so the K-th delta
      arrives after one client latency *stretched by the mean staleness*
      (a tau-stale cohort started tau applies ago) and *divided by the
      overlap depth* (deeper overlap keeps more deltas perpetually in
      flight — the whole point of leaving rounds for a stream).

    Unlike `fed_round_time`, the client latency is NOT additive with the
    wire: overlapped cohorts hide compute behind ingest, which is exactly
    why the async apply time can beat the synchronous round at equal K."""
    wire = (k * uplink_bytes_per_client + downlink_bytes) / (
        bw * max(server_links, 1)
    )
    depth = max(int(overlap_depth), 1)
    compute = t_client_s * (1.0 + expected_staleness(latency_probs)) / depth
    return max(wire, compute)


def fed_async_clients_per_sec(
    uplink_bytes_per_client: float,
    k: int,
    bw: float = BW_100MBPS,
    *,
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
    overlap_depth: int = 1,
    latency_probs=(1.0,),
) -> float:
    """Served clients per second of the buffered async stream: K
    contributions are absorbed per apply period. With zero client latency
    this upper-bounds `fed_clients_per_sec` (the sync round pays the same
    wire per client, serialized behind the cohort barrier); with a real
    latency distribution the gap is the hidden `t_client_s` term."""
    t = fed_async_apply_time(
        uplink_bytes_per_client,
        k,
        bw,
        t_client_s=t_client_s,
        downlink_bytes=downlink_bytes,
        server_links=server_links,
        overlap_depth=overlap_depth,
        latency_probs=latency_probs,
    )
    return k / max(t, 1e-12)


def _per_tenant(val, tenants: int, name: str) -> list:
    """Broadcast a scalar (or length-1 sequence) to `tenants` entries, or
    validate a per-tenant sequence's length — the costmodel mirror of
    `parse_tenant_floats` for already-typed values."""
    if isinstance(val, (list, tuple)):
        vals = list(val)
        if len(vals) == 1:
            vals = vals * tenants
        if len(vals) != tenants:
            raise ValueError(
                f"{name}: got {len(vals)} per-tenant values for a "
                f"{tenants}-tenant fleet — give 1 (broadcast) or exactly "
                f"{tenants}"
            )
        return vals
    return [val] * tenants


def fed_mt_clients_per_sec(
    tenants: int,
    uplink_bytes_per_client,
    cohort_or_k,
    bw: float = BW_100MBPS,
    *,
    asynchronous: bool = False,
    t_client_s=0.0,
    downlink_bytes=0.0,
    server_links: int = 1,
    overlap_depth=1,
    latency_probs=(1.0,),
) -> float:
    """Aggregate served clients per second of a T-tenant fleet multiplexed
    through ONE server (the multi-tenant tick): every tenant's wire crosses
    the same shared ingest link(s) — wire terms SUM across tenants — while
    client compute runs concurrently across populations — compute terms
    take the fleet MAX. Per-tenant heterogeneity rides as sequences (scalar
    broadcasts), mirroring the fed_mt_* config knobs.

    T=1 collapses EXACTLY (same float expressions, bitwise) to
    `fed_clients_per_sec` (synchronous) / `fed_async_clients_per_sec`
    (asynchronous) — the costmodel half of the T=1 degeneracy contract —
    and the aggregate rate is nondecreasing in T for identical tenants
    (amortizing the fixed compute term is the whole point; once the shared
    link saturates the rate plateaus at link capacity, never drops)."""
    T = int(tenants)
    if T < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    up = _per_tenant(uplink_bytes_per_client, T, "uplink_bytes_per_client")
    n = _per_tenant(cohort_or_k, T, "cohort_or_k")
    dl = _per_tenant(downlink_bytes, T, "downlink_bytes")
    tc = _per_tenant(t_client_s, T, "t_client_s")
    links = bw * max(server_links, 1)
    if not asynchronous:
        # synchronous rounds: one shared link serializes every tenant's
        # cohort ingest + broadcast; cohorts train concurrently so the
        # fleet pays the slowest tenant's client latency once
        wire = sum(c * u + d for c, u, d in zip(n, up, dl))
        t = max(tc) + wire / links
        return sum(n) / max(t, 1e-12)
    depth = _per_tenant(overlap_depth, T, "overlap_depth")
    probs = (
        list(latency_probs)
        if latency_probs and isinstance(latency_probs[0], (list, tuple))
        else [latency_probs] * T
    )
    if len(probs) == 1:
        probs = probs * T
    if len(probs) != T:
        raise ValueError(
            f"latency_probs: got {len(probs)} per-tenant rows for a "
            f"{T}-tenant fleet — give 1 (broadcast) or exactly {T}"
        )
    # buffered async: the fleet's apply cadence is gated by total ingest
    # across tenants vs. the slowest tenant's overlapped compute
    wire = sum(k * u + d for k, u, d in zip(n, up, dl)) / links
    compute = max(
        t * (1.0 + expected_staleness(p)) / max(int(dp), 1)
        for t, p, dp in zip(tc, probs, depth)
    )
    period = max(wire, compute)
    return sum(n) / max(period, 1e-12)


# ---------------------------------------------------------------------------
# Heterogeneous population pricing (the compute-class axis of a
# PopulationSpec). Classes differ in local-step multipliers and latency
# rows; the serving model prices both as population-weighted expectations.
# A uniform population (every multiplier 1.0, no per-class rows) collapses
# EXACTLY — same float expressions — to the population-free estimators,
# the costmodel half of the bitwise IID-degeneracy contract.
# ---------------------------------------------------------------------------


def pop_compute_factor(weights, local_steps_mults) -> float:
    """Population-weighted local-compute stretch: ``Σ w̄_k · mult_k`` over
    the classes, the factor one client's expected local-train latency
    grows by when compute classes are heterogeneous. Returns the EXACT
    literal 1.0 when every multiplier is 1.0 (no ``Σ w̄_k`` rounding), so
    a uniform population prices bitwise like no population at all."""
    if len(weights) != len(local_steps_mults):
        raise ValueError(
            f"pop_compute_factor: {len(weights)} class weights vs "
            f"{len(local_steps_mults)} local-step multipliers"
        )
    if not weights:
        raise ValueError("pop_compute_factor: need at least one class")
    if all(float(m) == 1.0 for m in local_steps_mults):
        return 1.0
    total = float(sum(weights))
    if total <= 0.0:
        raise ValueError(f"pop_compute_factor: weights sum to {total}")
    return sum(
        float(w) / total * float(m)
        for w, m in zip(weights, local_steps_mults)
    )


def pop_expected_staleness(weights, class_latency_rows) -> float:
    """Mixture mean staleness of a heterogeneous population: the
    class-weighted expectation of each class's `expected_staleness` —
    what E[tau] becomes when the latency distribution is per-class."""
    if len(weights) != len(class_latency_rows):
        raise ValueError(
            f"pop_expected_staleness: {len(weights)} class weights vs "
            f"{len(class_latency_rows)} latency rows"
        )
    if not weights:
        raise ValueError("pop_expected_staleness: need at least one class")
    total = float(sum(weights))
    if total <= 0.0:
        raise ValueError(f"pop_expected_staleness: weights sum to {total}")
    return sum(
        float(w) / total * expected_staleness(row)
        for w, row in zip(weights, class_latency_rows)
    )


def fed_pop_clients_per_sec(
    uplink_bytes_per_client: float,
    clients: int,
    bw: float = BW_100MBPS,
    *,
    weights=(1.0,),
    local_steps_mults=(1.0,),
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
) -> float:
    """Population-aware synchronous serving throughput: the cohort barrier
    waits for the SLOWEST compute class's clients, priced as the weighted
    compute stretch on `t_client_s`. Delegates to `fed_clients_per_sec`,
    so a uniform population collapses exactly."""
    factor = pop_compute_factor(weights, local_steps_mults)
    t = t_client_s if factor == 1.0 else t_client_s * factor
    return fed_clients_per_sec(
        uplink_bytes_per_client,
        clients,
        bw,
        t_client_s=t,
        downlink_bytes=downlink_bytes,
        server_links=server_links,
    )


def fed_pop_async_clients_per_sec(
    uplink_bytes_per_client: float,
    k: int,
    bw: float = BW_100MBPS,
    *,
    weights=(1.0,),
    local_steps_mults=(1.0,),
    class_latency_rows=None,
    t_client_s: float = 0.0,
    downlink_bytes: float = 0.0,
    server_links: int = 1,
    overlap_depth: int = 1,
    latency_probs=(1.0,),
) -> float:
    """Population-aware buffered-async serving throughput: compute classes
    stretch the client latency by the weighted factor, and per-class
    latency rows (when given) replace E[tau] with the mixture expectation.
    With `class_latency_rows=None` and unit multipliers this IS
    `fed_async_clients_per_sec` (exact delegation — the collapse half of
    the degeneracy contract)."""
    factor = pop_compute_factor(weights, local_steps_mults)
    t = t_client_s if factor == 1.0 else t_client_s * factor
    if class_latency_rows is None:
        return fed_async_clients_per_sec(
            uplink_bytes_per_client,
            k,
            bw,
            t_client_s=t,
            downlink_bytes=downlink_bytes,
            server_links=server_links,
            overlap_depth=overlap_depth,
            latency_probs=latency_probs,
        )
    wire = (k * uplink_bytes_per_client + downlink_bytes) / (
        bw * max(server_links, 1)
    )
    depth = max(int(overlap_depth), 1)
    compute = (
        t * (1.0 + pop_expected_staleness(weights, class_latency_rows))
        / depth
    )
    return k / max(max(wire, compute), 1e-12)


# ---------------------------------------------------------------------------
# Per-rs_mode static wire accounting. These return the per-worker
# *injection* bytes of every collective the route issues — the same
# numbers GradientExchanger.payload_bytes() reports and the
# jx-wire-accounting "collective" rule pins against the traced jaxpr.
# ---------------------------------------------------------------------------


def _shard_size(d: int, W: int) -> int:
    return (d + W - 1) // W


def _send_budget(d: int, ratio: float, W: int, headroom: float) -> int:
    k = max(1, int(d * ratio))
    return max(1, int(math.ceil(k / W * headroom)))


def _out_budget(d: int, ratio: float, W: int, out_headroom: float) -> int:
    k = max(1, int(d * ratio))
    return min(max(1, int(math.ceil(k / W * out_headroom))), _shard_size(d, W))


def _oktopk_budget(d: int, ratio: float, W: int, cap_headroom: float) -> int:
    """Host-side mirror of sparse_rs.oktopk_send_budget: the global
    threshold targets ~k survivors TOTAL, so expected per-(worker, shard)
    occupancy is k/W² — W× below the sparse route's k/W."""
    k = max(1, int(d * ratio))
    return max(1, int(math.ceil(k / (W * W) * cap_headroom)))


def sketch_cols(d: int, ratio: float, rows: int, cols: int = 0) -> int:
    """Resolved sketch width: explicit `cols` wins; 0 auto-sizes to ~2k/rows
    buckets (constant expected load factor ~1/2 per row) with a floor that
    keeps tiny problems from degenerating."""
    if cols > 0:
        return int(cols)
    k = max(1, int(d * ratio))
    return max(256, int(math.ceil(2.0 * k / max(1, rows))))


def quantized_padded_len(d: int, W: int, block: int) -> int:
    """Length after padding d up to a multiple of W*block so every worker's
    shard is whole blocks."""
    chunk = W * block
    return ((d + chunk - 1) // chunk) * chunk


def adaptive_lane_count(d: int, ratio: float, W: int, out_headroom: float, block: int) -> int:
    """f32 lanes in the adaptive phase-2 row (excluding the +1 flag lane):
    max of the sparse encoding (2 lanes/entry) and the int8-block dense
    shard encoding (levels bitcast into f32 lanes + one f32 norm/block)."""
    S = _shard_size(d, W)
    Sp = ((S + block - 1) // block) * block
    dense_lanes = Sp // 4 + Sp // block
    sparse_lanes = 2 * _out_budget(d, ratio, W, out_headroom)
    return max(sparse_lanes, dense_lanes)


def rs_wire_bytes(
    mode: str,
    d: int,
    W: int,
    ratio: float,
    *,
    headroom: float = 2.0,
    out_headroom: float = 1.0,
    block: int = 256,
    rows: int = 5,
    cols: int = 0,
    bins: int = 4096,
    cap_headroom: float = 2.0,
    masked: bool = False,
) -> Dict[str, float]:
    """Per-collective injection bytes for one sparse_rs route. Keys are the
    collective primitive names the route traces; values are the operand
    bytes one worker contributes to that collective.

    `masked` prices the live-mask-aware re-ownership variants
    (sparse_rs.owner_permutation): the sparse/oktopk wire layout is
    unchanged (global indices ride the same lanes local ones did), but the
    quantized route adds one int8 all_gather of the summed [Ssh] shard so
    deputies can dequantize the shards they serve."""
    B = _send_budget(d, ratio, W, headroom)
    K2 = _out_budget(d, ratio, W, out_headroom)
    if mode == "sparse":
        return {"all_to_all": W * B * 8.0, "all_gather": K2 * 8.0}
    if mode == "adaptive":
        L = adaptive_lane_count(d, ratio, W, out_headroom, block)
        return {"all_to_all": W * B * 8.0, "all_gather": (L + 1) * 4.0}
    if mode == "quantized":
        n = quantized_padded_len(d, W, block)
        extra = (n // W) * 1.0 if masked else 0.0
        return {
            "pmax": (n // block) * 4.0,
            "psum_scatter": n * 1.0,
            "all_gather": K2 * 8.0 + extra,
        }
    if mode == "sketch":
        C = sketch_cols(d, ratio, rows, cols)
        return {"psum": rows * C * 4.0, "all_gather": K2 * 8.0}
    if mode == "oktopk":
        Bo = _oktopk_budget(d, ratio, W, cap_headroom)
        return {
            "psum": bins * 4.0,
            "all_to_all": W * Bo * 8.0,
            "all_gather": K2 * 8.0,
        }
    raise ValueError(f"unknown rs_mode {mode!r}")


def rs_payload_bytes(mode: str, d: int, W: int, ratio: float, **kw) -> float:
    """Total per-worker injection bytes for one route (sum over its
    collectives) — the number payload_bytes()/jx-wire-accounting pin."""
    return float(sum(rs_wire_bytes(mode, d, W, ratio, **kw).values()))


def peak_hbm_bytes(
    route: str,
    d: int,
    W: int,
    *,
    residual: bool = True,
    dtype_bytes: int = 4,
) -> int:
    """Modeled peak live bytes of one audited exchange trace — the number
    the liveness interpreter (analysis/liveness.py) computes and
    jx-peak-bytes commits as the trace's byte budget.

    The audit harness stacks every per-worker operand to ``[W, d]``, so the
    peak is dominated by the stacked gradient (and, with error-feedback
    residuals, the stacked residual bank). What rides on top at the peak
    differs per route:

    - ``fused``: the dense per-worker view sliced out of the stack is still
      live when the peak lands, plus the i32 step counter;
    - ``oktopk``: same dense view (no residual bank — the in-collective
      sparse_rs routes are memory='none');
    - ``bucketed``: per-bucket views die bucket-by-bucket before the peak,
      leaving only encode scratch that is O(payload), not O(d) — modeled
      as zero here, so the estimate is a tight floor.

    tests/test_liveness.py cross-checks these predictions against the
    static analyzer on the committed fused/bucketed/oktopk traces: model,
    trace, and budget cannot drift apart (the jx-wire-accounting contract,
    applied to HBM).
    """
    if route not in ("fused", "bucketed", "oktopk"):
        raise ValueError(f"unknown peak route {route!r}")
    banks = 2 if residual else 1
    stacked = banks * dtype_bytes * W * d
    if route == "fused":
        return stacked + dtype_bytes * d + dtype_bytes
    if route == "oktopk":
        return stacked + dtype_bytes * d
    return stacked


_RING_TIME = {
    "all_gather": allgather_time,
    "all_to_all": all_to_all_time,
    "psum": allreduce_time,
    "pmax": allreduce_time,
    "psum_scatter": reduce_scatter_time,
}


def rs_step_time(
    mode: str,
    d: int,
    W: int,
    ratio: float,
    *,
    t_compute_s: float = 0.0,
    bw: Optional[float] = None,
    compute_time: float = 0.0,
    profile: Optional[MachineProfile] = None,
    **kw,
) -> float:
    """W-aware modeled step time of one in-collective route: ring wire time
    of each collective it issues plus its (once-per-worker) compute.
    ``compute_time`` is backward-pass compute available to hide wire behind
    (the streaming-overlap discipline); 0 keeps the historical serialized
    model byte-for-byte. ``profile`` supplies a calibrated link bandwidth
    when no explicit bw is given."""
    bw = _bw_dcn(bw, profile)
    wire = 0.0
    for prim, size in rs_wire_bytes(mode, d, W, ratio, **kw).items():
        wire += _RING_TIME[prim](size, W, bw)
    wire = max(0.0, wire - max(0.0, compute_time))
    return wire + t_compute_s


def _rs_kw(kw: Dict) -> Dict:
    """Filter **kw down to the keys rs_wire_bytes understands."""
    keep = ("headroom", "out_headroom", "block", "rows", "cols",
            "bins", "cap_headroom", "masked")
    return {k: kw[k] for k in keep if k in kw}


def select_rs_mode(
    d: int,
    W: int,
    ratio: float,
    *,
    headroom: float = 2.0,
    out_headroom: float = 1.0,
    block: int = 256,
    rows: int = 5,
    cols: int = 0,
    bins: int = 4096,
    cap_headroom: float = 2.0,
    bw: Optional[float] = None,
    modes: Optional[tuple] = None,
    measurements: Optional[Dict[str, Dict[str, float]]] = None,
    compute_time: float = 0.0,
    profile: Optional[MachineProfile] = None,
) -> str:
    """Resolve ``rs_mode="auto"`` at construction time: argmin of the
    W-aware model over the concrete routes. At the 100 Mbps default link
    the step is wire-dominated and, with no measured rows, compute terms
    are excluded — the selector is deterministic from (d, W, ratio) and
    static config alone. ``measurements[mode]`` rows (t_encode_s/t_decode_s
    per route, the bench measurement convention) charge each candidate its
    measured codec compute; when absent, a ``profile`` with fitted
    per-route `routes` rows fills them in, so a calibrated profile
    re-ranks the routes on measured encode/decode, not just bandwidth (a
    bandwidth-only v1 profile still can never flip this argmin — every rs
    route's wire scales as 1/bw). ``compute_time`` (hideable backward
    compute, see `overlapped_step_time`) threads through to each
    candidate's `rs_step_time`; the default 0 keeps the historical
    selection."""
    candidates = modes or ("sparse", "adaptive", "quantized", "sketch", "oktopk")
    best, best_t = None, float("inf")
    for mode in candidates:
        m = (measurements or {}).get(mode) or route_measurement(profile, mode)
        tc = (m["t_encode_s"] + m["t_decode_s"]) if m else 0.0
        t = rs_step_time(
            mode, d, W, ratio,
            t_compute_s=tc,
            headroom=headroom, out_headroom=out_headroom,
            block=block, rows=rows, cols=cols,
            bins=bins, cap_headroom=cap_headroom, bw=bw,
            compute_time=compute_time, profile=profile,
        )
        if t < best_t:
            best, best_t = mode, t
    return best


# ---------------------------------------------------------------------------
# Two-tier (ICI x DCN) hierarchical model.
#
# A multi-slice mesh has two links with a ~100x bandwidth gap: the
# intra-slice ICI fabric and the cross-slice DCN. The hierarchical
# exchange reduces densely (or int8-quantized) over the fast axis first,
# then runs one of the flat compressed exchanges across slices only.
# Modeled step time is the SUM of the two legs — the slice mean must
# complete before the DCN leg can start, so the legs serialize.
# ---------------------------------------------------------------------------

# 10 Gbps in bytes/s — a deliberately conservative stand-in for the
# intra-slice fabric (real ICI is far faster; the planner only needs the
# order-of-magnitude gap against the 100 Mbps DCN default).
BW_ICI_10GBPS = 1.25e9

HIER_ICI_LEGS = ("dense", "qar")
HIER_DCN_LEGS = ("fused", "bucketed", "sparse", "adaptive", "quantized", "sketch")


def qar_wire_bytes_per_worker(d: int, W: int, block: int = 512) -> float:
    """Per-worker wire bytes of the int8 two-phase quantized allreduce.

    Mirrors ``qar.wire_bits_per_worker`` (kept numerically identical by
    tests/test_hierarchical.py) without importing jax: two tiled
    all_to_all phases of int8 levels plus two all_gathers of f32 bucket
    norms, each moving the (W-1)/W ring fraction."""
    n = quantized_padded_len(d, W, block)
    bits = 2.0 * (n * 8 + (n // block) * 32) * (W - 1) / W
    return bits / 8.0


def hier_ici_time(
    leg: str, d: int, per_slice: int, bw_ici: Optional[float] = None,
    *, block: int = 512, profile: Optional[MachineProfile] = None,
) -> float:
    """Modeled ICI-leg time: dense f32 psum or int8 quantized allreduce
    over the `per_slice` devices of one slice."""
    bw_ici = _bw_ici(bw_ici, profile)
    if per_slice <= 1:
        return 0.0
    if leg == "dense":
        return allreduce_time(4.0 * d, per_slice, bw_ici)
    if leg == "qar":
        return qar_wire_bytes_per_worker(d, per_slice, block) / bw_ici
    raise ValueError(f"unknown ici leg {leg!r} (expected one of {HIER_ICI_LEGS})")


def hier_dcn_time(
    leg: str,
    d: int,
    n_slices: int,
    ratio: float,
    bw_dcn: Optional[float] = None,
    *,
    measurement: Optional[Dict[str, float]] = None,
    t_compute_s: float = 0.0,
    compute_time: float = 0.0,
    profile: Optional[MachineProfile] = None,
    **kw,
) -> float:
    """Modeled DCN-leg time with `n_slices` workers on the scarce link.

    "fused"/"bucketed" use the allgather model; without a measured codec
    row the payload defaults to 8 bytes/entry at k = d*ratio (the same
    value+index convention rs_wire_bytes uses). "bucketed" overlaps
    decode under the next bucket's gather, so it pays max(wire, decode)
    instead of their sum; with no measured compute the two tie and the
    planner's candidate order prefers plain "fused". ``compute_time`` is
    hideable backward compute (the streaming overlap, `overlapped_step_
    time`): it shaves every leg's wire before the formulas above, so the
    planner can price what streaming buys on the scarce link; 0 keeps the
    historical model. A ``profile`` supplies its calibrated bandwidth AND
    fills the measurement gaps with its fitted encode/decode seconds: a
    per-route `routes` row for the leg wins over the global t_enc/t_dec
    fallback on the fused/bucketed legs, and charges the rs legs one
    encode + one decode of codec compute — so a v2 profile can flip plans
    on ANY leg, not just the gather-then-decode family (explicit
    `measurement`/`t_compute_s` still win)."""
    bw_dcn = _bw_dcn(bw_dcn, profile)
    rm = route_measurement(profile, leg)
    if leg in ("fused", "bucketed"):
        if measurement is not None:
            m = measurement
        elif rm is not None:
            m = {"payload_bytes": 8.0 * max(1, int(d * ratio)), **rm}
        else:
            m = {
                "payload_bytes": 8.0 * max(1, int(d * ratio)),
                "t_encode_s": profile.t_enc_s if profile is not None else 0.0,
                "t_decode_s": profile.t_dec_s if profile is not None else 0.0,
            }
        wire = allgather_time(m["payload_bytes"], n_slices, bw_dcn)
        wire = max(0.0, wire - max(0.0, compute_time))
        if leg == "bucketed":
            return m["t_encode_s"] + max(wire, n_slices * m["t_decode_s"])
        return m["t_encode_s"] + wire + n_slices * m["t_decode_s"]
    if t_compute_s == 0.0 and rm is not None:
        t_compute_s = rm["t_encode_s"] + rm["t_decode_s"]
    return rs_step_time(
        leg, d, n_slices, ratio, t_compute_s=t_compute_s, bw=bw_dcn,
        compute_time=compute_time, **_rs_kw(kw)
    )


def hier_step_time(
    ici: str,
    dcn: str,
    d: int,
    n_slices: int,
    per_slice: int,
    ratio: float,
    *,
    bw_ici: Optional[float] = None,
    bw_dcn: Optional[float] = None,
    ici_block: int = 512,
    measurement: Optional[Dict[str, float]] = None,
    t_compute_s: float = 0.0,
    compute_time: float = 0.0,
    profile: Optional[MachineProfile] = None,
    **kw,
) -> float:
    """Modeled step time of one (ici, dcn) plan: serialized two-leg sum.
    ``compute_time`` (hideable backward compute) applies to the DCN leg
    only — the ICI leg runs after the slice mean and cannot stream."""
    return hier_ici_time(
        ici, d, per_slice, bw_ici, block=ici_block, profile=profile
    ) + hier_dcn_time(
        dcn, d, n_slices, ratio, bw_dcn,
        measurement=measurement, t_compute_s=t_compute_s,
        compute_time=compute_time, profile=profile, **kw,
    )


def stream_hier_step_time(
    dcn: str,
    d: int,
    n_slices: int,
    per_slice: int,
    ratio: float,
    *,
    bw_ici: Optional[float] = None,
    bw_dcn: Optional[float] = None,
    ici_block: int = 512,
    measurement: Optional[Dict[str, float]] = None,
    compute_time: float = 0.0,
    profile: Optional[MachineProfile] = None,
) -> float:
    """`overlapped_step_time` composed with the hierarchical two-leg model:
    the stream-over-hier schedule dispatches each bucket's dense ICI psum
    AND its compressed DCN gather from inside the bucket's backward hook,
    so hideable backward compute shaves the COMBINED wire of both legs —
    the barrier-scheduled `hier_step_time` can only hide the DCN leg.

    Defined for the composable stack only: dense ICI + the allgather
    family on DCN (`dcn` in {"fused", "bucketed"} — the config fences
    every other shape out of streaming). With ``compute_time=0`` the
    "fused" form is exactly ``hier_step_time("dense", "fused", ...)``
    (nothing to hide behind), and "bucketed" pays
    ``max(ici + dcn_wire, decode)`` ≤ the barrier schedule's
    ``ici + max(dcn_wire, decode)`` — so the composed model can never
    exceed the barrier-hier parent, and with compute it can never exceed
    what the same compute buys the flat streaming parent on a scarcer
    gather."""
    if dcn not in ("fused", "bucketed"):
        raise ValueError(
            f"stream_hier_step_time composes the allgather family only "
            f"(fused/bucketed), got dcn={dcn!r}"
        )
    rm = route_measurement(profile, dcn)
    if measurement is not None:
        m = measurement
    elif rm is not None:
        m = {"payload_bytes": 8.0 * max(1, int(d * ratio)), **rm}
    else:
        m = {
            "payload_bytes": 8.0 * max(1, int(d * ratio)),
            "t_encode_s": profile.t_enc_s if profile is not None else 0.0,
            "t_decode_s": profile.t_dec_s if profile is not None else 0.0,
        }
    ici_wire = hier_ici_time(
        "dense", d, per_slice, bw_ici, block=ici_block, profile=profile
    )
    dcn_wire = allgather_time(
        m["payload_bytes"], n_slices, _bw_dcn(bw_dcn, profile)
    )
    exposed = max(0.0, ici_wire + dcn_wire - max(0.0, compute_time))
    if dcn == "bucketed":
        return m["t_encode_s"] + max(exposed, n_slices * m["t_decode_s"])
    return m["t_encode_s"] + exposed + n_slices * m["t_decode_s"]


def select_hier_plan(
    d: int,
    n_slices: int,
    per_slice: int,
    ratio: float,
    bw_ici: Optional[float] = None,
    bw_dcn: Optional[float] = None,
    *,
    ici_block: int = 512,
    ici_legs: Optional[tuple] = None,
    dcn_legs: Optional[tuple] = None,
    measurements: Optional[Dict[str, Dict[str, float]]] = None,
    compute: Optional[Dict[str, float]] = None,
    compute_time: float = 0.0,
    stream: bool = False,
    profile: Optional[MachineProfile] = None,
    **kw,
) -> Dict:
    """Construction-time auto-planner: argmin of `hier_step_time` over
    {ici: dense|qar} x {dcn: fused|bucketed|rs modes}.

    Deterministic from static shapes and config alone, like
    `select_rs_mode`; bench.py --hier-sweep optionally supplies measured
    codec rows (`measurements[dcn_leg]` -> flat measurement dict) and
    per-route compute (`compute[dcn_leg]` seconds) so its report and the
    planner argmin over exactly the same numbers. A ``profile`` re-prices
    every candidate under the calibrated bandwidths and charges the fitted
    encode/decode seconds on the fused/bucketed legs (explicit bw_* and
    `measurements` rows still win) — this is the selector a fitted profile
    can actually flip.

    ``stream=True`` makes the planner overlap-aware: the composable
    candidates (dense ICI x fused/bucketed DCN — the only stack the
    config lets streaming wrap) are priced with `stream_hier_step_time`,
    where ``compute_time`` hides the combined ici+dcn wire instead of the
    dcn leg alone; every other candidate keeps the barrier model so the
    argmin compares what streaming actually buys. The default False keeps
    the historical table to the last float (the calib-reselect audit pins
    it).

    Returns {"ici", "dcn", "modeled_step_s", "table"} where table maps
    "ici+dcn" -> modeled seconds for every candidate pair."""
    ici_cands = ici_legs or HIER_ICI_LEGS
    dcn_cands = dcn_legs or HIER_DCN_LEGS
    table: Dict[str, float] = {}
    best = None
    for dcn in dcn_cands:
        m = (measurements or {}).get(dcn)
        tc = (compute or {}).get(dcn, 0.0)
        for ici in ici_cands:
            if stream and ici == "dense" and dcn in ("fused", "bucketed"):
                t = stream_hier_step_time(
                    dcn, d, n_slices, per_slice, ratio,
                    bw_ici=bw_ici, bw_dcn=bw_dcn, ici_block=ici_block,
                    measurement=m, compute_time=compute_time,
                    profile=profile,
                )
            else:
                t = hier_step_time(
                    ici, dcn, d, n_slices, per_slice, ratio,
                    bw_ici=bw_ici, bw_dcn=bw_dcn, ici_block=ici_block,
                    measurement=m, t_compute_s=tc, compute_time=compute_time,
                    profile=profile, **kw,
                )
            table[f"{ici}+{dcn}"] = t
            if best is None or t < table[f"{best[0]}+{best[1]}"]:
                best = (ici, dcn)
    return {
        "ici": best[0],
        "dcn": best[1],
        "modeled_step_s": table[f"{best[0]}+{best[1]}"],
        "table": table,
    }

# ---------------------------------------------------------------------------
# Calibration: fit a MachineProfile from a tracking run directory.
#
# The fit joins three telemetry artifacts every `--telemetry` run writes:
#   trace.json    — host-side span X-events. Spans wrapping traced code fire
#                   ONCE PER TRACE (their durations are trace-time, inflated
#                   ~10x over a compiled step), while the driver's
#                   `train/step` span fires every step with real wall time.
#   summary.json  — the on-device accumulators' derived rows, including the
#                   per-axis wire counters `dcn_bytes_per_step` /
#                   `ici_bytes_per_step`.
#   metrics.jsonl — per-step records; consecutive `ts` deltas are the step-
#                   time fallback when the run has no train/step spans.
#
# The decomposition is share-based: per-span-name SELF time (container time
# minus children — streaming runs nest the exchange spans inside
# train/forward_backward) is bucketed into encode / decode / DCN-wire /
# ICI-wire / compute / other categories, and each category's share of the
# trace-time pool is apportioned against the measured (warmup-dropped) mean
# step time. The identifiability assumption this rests on: RELATIVE span
# durations at trace time track relative durations at run time — trace-time
# inflation cancels in the shares. Predicted step time is the sum of the
# apportioned components, so the fit reproduces the measured step time
# exactly by construction; the CLI tolerance gate checks the round trip
# through the model formulas (bw inverted, then wire recomputed).
#
# Parameters a run cannot identify (no decode spans, zero ICI bytes, ...)
# are held at the static constants and listed under `fixed` — a profile is
# honest about what it measured.
# ---------------------------------------------------------------------------

# leaf spans charged to each model parameter. Everything not listed (and
# not excluded) lands in the residual "other" component, which calibrate()
# carries through so the decomposition stays exact.
CAL_ENCODE_SPANS = frozenset({
    "exchange/encode", "exchange/pack",
    "sparse_rs/select", "sparse_rs/quantize", "sparse_rs/adaptive-quantize",
    "sparse_rs/sketch",
})
CAL_DECODE_SPANS = frozenset({
    "exchange/decode", "sparse_rs/unsketch", "sparse_rs/reduce",
})
CAL_WIRE_DCN_SPANS = frozenset({
    "exchange/allgather", "exchange/ring", "exchange/qar",
    "sparse_rs/route", "sparse_rs/allgather", "sparse_rs/psum",
    "sparse_rs/reduce-scatter", "sparse_rs/norm-pmax",
})
CAL_WIRE_ICI_SPANS = frozenset({"exchange/ici"})
CAL_COMPUTE_SPANS = frozenset({"train/forward_backward"})
# spans that are not per-step work at all: the driver's step timer (it is
# the measurement target, not a component) and the one-time program build
CAL_EXCLUDED_SPANS = frozenset({"train/step", "train/build"})


def drop_warmup(xs: Sequence[float], k: float = 4.0) -> List[float]:
    """Strip the leading run of compile-skewed samples: with the median of
    the trailing half as the steady-state scale, drop leading samples more
    than `k` times it. Robust to MULTIPLE warmup steps (a telemetry run
    compiles once per distinct program — streaming runs show two) where a
    drop-first-only policy is not. Always keeps at least one sample."""
    xs = list(xs)
    if len(xs) <= 1:
        return xs
    tail = sorted(xs[len(xs) // 2:])
    ref = tail[len(tail) // 2]
    i = 0
    while i < len(xs) - 1 and xs[i] > k * ref:
        i += 1
    return xs[i:]


def _span_route(e: Dict[str, Any]) -> str:
    """The event's route attribution ("" when unlabeled)."""
    args = e.get("args")
    if isinstance(args, dict) and isinstance(args.get("route"), str):
        return args["route"]
    return ""


def span_self_times_by_route(events) -> Dict[Tuple[str, str], float]:
    """Per-(span-name, route) SELF time in seconds from Chrome-trace "X"
    events: each span's duration minus its direct children's, computed with
    a per-(pid, tid) interval stack — so a container like
    train/forward_backward is not double-charged for the exchange spans a
    streaming run nests inside it, and a wire span nested inside a labeled
    encode span keeps its time out of that route's encode row. Unlabeled
    spans key under route ""."""
    by_tid: Dict[Any, List[Tuple[float, float, str, str]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            continue
        key = (e.get("pid"), e.get("tid"))
        by_tid.setdefault(key, []).append(
            (float(ts), float(dur), str(e.get("name", "")), _span_route(e))
        )
    self_us: Dict[Tuple[str, str], float] = {}
    for evs in by_tid.values():
        # parents sort before children: earlier start first, longer first on
        # ties (a child can share its parent's start timestamp)
        evs.sort(key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[float, Tuple[str, str]]] = []  # (end_ts, key)
        for ts, dur, name, route in evs:
            while stack and ts >= stack[-1][0]:
                stack.pop()
            k = (name, route)
            self_us[k] = self_us.get(k, 0.0) + dur
            if stack:
                parent = stack[-1][1]
                self_us[parent] = self_us.get(parent, 0.0) - dur
            stack.append((ts + dur, k))
    return {k: us * 1e-6 for k, us in self_us.items()}


def span_self_times(events) -> Dict[str, float]:
    """Per-span-name SELF time in seconds — `span_self_times_by_route`
    aggregated over the route attribution (the pre-v2 view; adding route
    labels to spans cannot change these totals)."""
    out: Dict[str, float] = {}
    for (name, _route), s in span_self_times_by_route(events).items():
        out[name] = out.get(name, 0.0) + s
    return out


def _read_json(path: pathlib.Path) -> Dict[str, Any]:
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def calibrate(
    run_dir, *, include_warmup: bool = False, warmup_k: float = 4.0
) -> MachineProfile:
    """Fit a MachineProfile from one tracking run dir (see the section
    comment above for the decomposition). Deterministic: the profile is a
    pure function of the run dir's committed files — no wall clock enters
    the record, so re-running on a committed run dir is bitwise stable.
    Raises ValueError when the run lacks the telemetry the fit needs."""
    run = pathlib.Path(run_dir)
    cfg_rec = _read_json(run / "config.json")
    if not cfg_rec:
        raise ValueError(f"{run}: no config.json — not a tracking run dir")
    config = cfg_rec.get("config", {}) or {}
    W = int(config.get("workers", cfg_rec.get("workers", 1)) or 1)
    trace = _read_json(run / "trace.json")
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    if not events:
        raise ValueError(
            f"{run}: no span trace (trace.json) — re-run with --telemetry "
            "to record the spans the fit decomposes"
        )
    routed_s = span_self_times_by_route(events)
    self_s: Dict[str, float] = {}
    for (name, _route), s in routed_s.items():
        self_s[name] = self_s.get(name, 0.0) + s

    # --- measured step time: train/step spans, else metrics.jsonl ts ---- #
    step_durs = sorted(
        (float(e["ts"]), float(e["dur"]) * 1e-6)
        for e in events
        if e.get("name") == "train/step"
        and isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("dur"), (int, float))
    )
    samples = [dur for _, dur in step_durs]
    step_source = "train/step spans"
    if not samples:
        ts: List[float] = []
        mpath = run / "metrics.jsonl"
        if mpath.exists():
            with open(mpath) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rec = json.loads(line)
                        if isinstance(rec.get("ts"), (int, float)):
                            ts.append(float(rec["ts"]))
        samples = [b - a for a, b in zip(ts, ts[1:]) if b >= a]
        step_source = "metrics.jsonl ts deltas"
    if not samples:
        raise ValueError(
            f"{run}: no step-time samples (no train/step spans and no "
            "metrics.jsonl timestamps)"
        )
    n_total = len(samples)
    kept = samples if include_warmup else drop_warmup(samples, k=warmup_k)
    if len(kept) < 4:
        raise ValueError(
            f"{run}: too few step-time samples to fit from — the run has "
            f"{n_total} sample(s), {len(kept)} left after the warmup drop; "
            "the share-based fit needs >= 4 post-warmup samples "
            "(re-run with more steps)"
        )
    T = sum(kept) / len(kept)
    if T <= 0.0:
        raise ValueError(f"{run}: measured mean step time is not positive")

    # --- trace-time shares -> apportioned per-step component seconds ---- #
    pool = {
        name: s
        for name, s in self_s.items()
        if name not in CAL_EXCLUDED_SPANS and s > 0.0
    }
    total_tr = sum(pool.values())

    def _cat(names) -> float:
        return sum(s for n, s in pool.items() if n in names)

    enc_tr = _cat(CAL_ENCODE_SPANS)
    dec_tr = _cat(CAL_DECODE_SPANS)
    wdcn_tr = _cat(CAL_WIRE_DCN_SPANS)
    wici_tr = _cat(CAL_WIRE_ICI_SPANS)
    comp_tr = _cat(CAL_COMPUTE_SPANS)
    other_tr = total_tr - (enc_tr + dec_tr + wdcn_tr + wici_tr + comp_tr)
    scale = T / total_tr if total_tr > 0.0 else 0.0
    enc_s, dec_s = enc_tr * scale, dec_tr * scale
    wdcn_s, wici_s = wdcn_tr * scale, wici_tr * scale
    comp_s, other_s = comp_tr * scale, other_tr * scale

    # --- per-route encode/decode rows (the v2 `routes` table) ----------- #
    # labeled encode/decode self-time buckets per route BEFORE the share
    # fit; the same trace-time -> step-time scale apportions each bucket,
    # so the route rows sum (up to the decode-multiplicity convention) to
    # the global enc_s/dec_s they were split out of.
    enc_tr_route: Dict[str, float] = {}
    dec_tr_route: Dict[str, float] = {}
    for (name, route), s in routed_s.items():
        if not route or s <= 0.0:
            continue
        if name in CAL_ENCODE_SPANS:
            enc_tr_route[route] = enc_tr_route.get(route, 0.0) + s
        elif name in CAL_DECODE_SPANS:
            dec_tr_route[route] = dec_tr_route.get(route, 0.0) + s
    route_samples: Dict[str, int] = {}
    for e in events:
        nm, route = str(e.get("name", "")), _span_route(e)
        if route and (nm in CAL_ENCODE_SPANS or nm in CAL_DECODE_SPANS):
            route_samples[route] = route_samples.get(route, 0) + 1
    routes: Dict[str, Dict[str, float]] = {}
    for label in sorted(set(enc_tr_route) | set(dec_tr_route)):
        routes[label] = {
            "t_enc_s": enc_tr_route.get(label, 0.0) * scale,
            "t_dec_s": dec_tr_route.get(label, 0.0)
            * scale
            / _route_decodes_per_step(label, W),
            "samples": route_samples.get(label, 1),
        }

    # --- wire counters (per-worker injection bytes per step) ------------ #
    telem = _read_json(run / "summary.json").get("telemetry") or {}
    dcn_bytes = float(telem.get("dcn_bytes_per_step", 0.0) or 0.0)
    ici_bytes = float(telem.get("ici_bytes_per_step", 0.0) or 0.0)

    # --- invert the model where identifiable, hold constants where not -- #
    fitted: List[str] = []
    fixed: List[str] = []
    t_enc = 0.0
    if enc_tr > 0.0:
        t_enc = enc_s
        fitted.append("t_enc")
    else:
        fixed.append("t_enc")
    t_dec = 0.0
    if dec_tr > 0.0:
        # the model charges W decodes per step (own + W-1 remote rows)
        t_dec = dec_s / W
        fitted.append("t_dec")
    else:
        fixed.append("t_dec")
    bw_dcn = BW_100MBPS
    if wdcn_tr > 0.0 and dcn_bytes > 0.0 and W > 1:
        # allgather ring: wire_s = (W-1) * injection_bytes / bw
        bw_dcn = (W - 1) * dcn_bytes / wdcn_s
        fitted.append("bw_dcn")
    else:
        fixed.append("bw_dcn")
    bw_ici = BW_ICI_10GBPS
    if wici_tr > 0.0 and ici_bytes > 0.0:
        bw_ici = ici_bytes / wici_s
        fitted.append("bw_ici")
    else:
        fixed.append("bw_ici")
    compute_time = 0.0
    if comp_tr > 0.0:
        compute_time = comp_s
        fitted.append("compute_time")
    else:
        fixed.append("compute_time")

    # round trip through the model formulas: fitted bandwidths re-price the
    # observed bytes, fixed components keep their apportioned seconds
    wire_dcn_pred = (
        allgather_time(dcn_bytes, W, bw_dcn) if "bw_dcn" in fitted else wdcn_s
    )
    wire_ici_pred = ici_bytes / bw_ici if "bw_ici" in fitted else wici_s
    predicted = (
        t_enc + wire_dcn_pred + wire_ici_pred + W * t_dec + compute_time + other_s
    )
    cfg_digest = hashlib.sha256(
        json.dumps(config, sort_keys=True).encode()
    ).hexdigest()[:16]
    source = {
        "run": run.name,
        "config_digest": cfg_digest,
        "workers": W,
        "step_time_source": step_source,
        "include_warmup": bool(include_warmup),
        "steps_total": n_total,
        "steps_measured": len(kept),
        "warmup_dropped": n_total - len(kept),
        "measured_step_s": T,
        "predicted_step_s": predicted,
        "encode_s": enc_s,
        "decode_s": dec_s,
        "wire_dcn_s": wdcn_s,
        "wire_ici_s": wici_s,
        "compute_s": comp_s,
        "other_s": other_s,
        "dcn_bytes_per_step": dcn_bytes,
        "ici_bytes_per_step": ici_bytes,
    }
    return MachineProfile(
        bw_dcn=bw_dcn,
        bw_ici=bw_ici,
        t_enc_s=t_enc,
        t_dec_s=t_dec,
        compute_time_s=compute_time,
        fitted=tuple(fitted),
        fixed=tuple(fixed),
        routes=routes,
        source=source,
    )
