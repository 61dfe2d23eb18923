"""On-device running metric accumulators, ported from
`deepreduce_tpu/telemetry/device_metrics.py`.

`MetricAccumulators` holds the JAX package's fields in its order: the 19
float32 scalar counters from `steps` to `ici_bits`, then `bucket_saturated`
f32[C] (bucket-spec order; C = 0 unbucketed), `staleness_hist` f32[D] (the
asynchronous federated tick's latency levels; D = 0 elsewhere) and
`pop_hist` f32[K] (a population's classes; None when off). Here they are
named slots of ONE float32 tensor on the run's device, `vec` [..., 19 + C
+ D + K] (a leading [T] for the multi-tenant tick's per-tenant rows), so
that

- an accumulate is one `torch.cat` of the step's terms and one add, with
  no host sync: every term is a tensor already on the device, or a Python
  number that becomes a cached constant filled on the device (a tensor
  copied from the host would wait for the device);
- `fetch()` is the window's one device-to-host copy.

Every counter is a float32 running sum, added field by field in float32
as the JAX package adds them, so the counts (bits, saturations, steps,
live workers) are bitwise the JAX package's given the same per-step terms,
and the delta of two fetches is the exact accumulation over the steps
between them (`fetch_delta`). `fetch_delta`, `hist_quantile` and `derive`
are the JAX package's host functions, copied.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

_EPS = 1e-12

SCALAR_FIELDS: Tuple[str, ...] = (
    "steps",
    "index_bits",
    "value_bits",
    "dense_bits",
    "saturated",  # total saturated tensor payloads (count)
    "residual_l2",  # Σ per-step mean-over-workers ‖residual‖₂
    "err_l2",  # Σ per-step ‖agg − dense_mean‖₂ / ‖dense_mean‖₂
    "err_cos",  # Σ per-step cos(agg, dense_mean)
    "fp_count",  # Σ bloom false positives (decoded-but-not-selected)
    "fp_universe",  # Σ not-selected universe size (the FPR's denominator)
    "live_workers",  # Σ per-step live-worker count (participation)
    "dropped_steps",  # steps where at least one worker was masked out
    "checksum_failures",  # Σ failed-checksum payload decodes
    "rs_density",  # Σ adaptive sparse_rs shard density after phase 1
    "rs_dense_switches",  # Σ steps whose phase-2 row went dense
    "rs_oktopk_survivors",  # Σ oktopk global survivor count
    "rs_oktopk_threshold",  # Σ oktopk threshold magnitude
    "rs_oktopk_spills",  # Σ oktopk survivors this worker's capacity spilled
    "ici_bits",  # Σ bits moved on the intra-slice link (hierarchical)
)
_SLOT = {name: i for i, name in enumerate(SCALAR_FIELDS)}
_N = len(SCALAR_FIELDS)

# device constants filled once per (device, value, length): the terms a
# caller gives as Python numbers
_CONSTS: Dict[Tuple[str, float, int], torch.Tensor] = {}


def _const(value: float, n: int, device: torch.device) -> torch.Tensor:
    key = (str(device), float(value), int(n))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.full((n,), float(value), dtype=torch.float32, device=device)
        _CONSTS[key] = t
    return t


def _term(x: Any, n: int, device: torch.device) -> torch.Tensor:
    """One accumulate term as float32 [n] on `device` (n = 1 for a scalar;
    a scalar given for a vector slot broadcasts, as JAX's `[C] + 0.0`)."""
    if torch.is_tensor(x):
        x = x.to(torch.float32).reshape(-1)
        return x.expand(n) if x.numel() == 1 and n != 1 else x
    return _const(x, n, device)


def fetch_delta(cur: Dict[str, Any], prev: Dict[str, Any]) -> Dict[str, Any]:
    """Elementwise `cur - prev` of two cumulative `fetch()` snapshots: the
    per-window counters the adaptive controller consumes."""
    out: Dict[str, Any] = {}
    for name in MetricAccumulators.scalar_fields():
        out[name] = cur[name] - prev[name]
    cur_b = cur.get("bucket_saturated", [])
    prev_b = prev.get("bucket_saturated", [])
    if len(cur_b) != len(prev_b):
        raise ValueError(
            f"fetch_delta bucket vector length mismatch: {len(cur_b)} vs {len(prev_b)}"
        )
    out["bucket_saturated"] = [c - p for c, p in zip(cur_b, prev_b)]
    cur_s = cur.get("staleness_hist", [])
    prev_s = prev.get("staleness_hist", [])
    if cur_s or prev_s:
        if len(cur_s) != len(prev_s):
            raise ValueError(
                "fetch_delta staleness_hist length mismatch: "
                f"{len(cur_s)} vs {len(prev_s)}"
            )
        out["staleness_hist"] = [c - p for c, p in zip(cur_s, prev_s)]
    cur_p = cur.get("pop_hist", [])
    prev_p = prev.get("pop_hist", [])
    if cur_p or prev_p:
        if len(cur_p) != len(prev_p):
            raise ValueError(
                "fetch_delta pop_hist length mismatch: "
                f"{len(cur_p)} vs {len(prev_p)}"
            )
        out["pop_hist"] = [c - p for c, p in zip(cur_p, prev_p)]
    return out


def hist_quantile(hist, q: float) -> float:
    """Exact q-quantile of the discrete staleness distribution a counts
    histogram encodes: the smallest level d whose CDF reaches q; 0.0 on an
    empty or all-zero histogram."""
    counts = [max(float(h), 0.0) for h in hist]
    total = sum(counts)
    if total <= 0.0:
        return 0.0
    target = q * total
    cum = 0.0
    for d, h in enumerate(counts):
        cum += h
        # 1e-9 absorbs f32-accumulated rounding at exact-boundary targets
        if cum + 1e-9 >= target:
            return float(d)
    return float(len(counts) - 1)


class MetricAccumulators:
    """Running float32 counters in one device tensor. Immutable in use:
    `accumulate` returns a new accumulator."""

    def __init__(self, vec: torch.Tensor, num_buckets: int = 0, num_stale_levels: int = 0,
                 num_pop_classes: Optional[int] = None):
        C, D, K = int(num_buckets), int(num_stale_levels), int(num_pop_classes or 0)
        if vec.shape[-1] != _N + C + D + K or vec.dtype != torch.float32:
            raise ValueError(f"accumulator vector {tuple(vec.shape)} {vec.dtype} does not hold "
                             f"{_N} + {C} + {D} + {K} float32 slots")
        self.vec = vec
        self.num_buckets = C
        self.num_stale_levels = D
        self.num_pop_classes = None if not num_pop_classes else K

    @classmethod
    def zeros(cls, num_buckets: int = 0, num_stale_levels: int = 0, num_pop_classes: int = 0, *,
              device="cuda", batch: Sequence[int] = ()) -> "MetricAccumulators":
        """Fresh counters (`batch`: leading dimensions, the tenants)."""
        n = _N + int(num_buckets) + int(num_stale_levels) + int(num_pop_classes)
        vec = torch.zeros(tuple(batch) + (n,), dtype=torch.float32, device=device)
        return cls(vec, num_buckets, num_stale_levels, num_pop_classes or None)

    def _like(self, vec: torch.Tensor) -> "MetricAccumulators":
        return MetricAccumulators(vec, self.num_buckets, self.num_stale_levels, self.num_pop_classes)

    @property
    def device(self) -> torch.device:
        return self.vec.device

    # -- the fields, as views of the vector ------------------------------ #

    def __getattr__(self, name: str):
        slot = _SLOT.get(name)
        if slot is None:
            raise AttributeError(name)
        return self.vec[..., slot]

    @property
    def bucket_saturated(self) -> torch.Tensor:
        return self.vec[..., _N : _N + self.num_buckets]

    @property
    def staleness_hist(self) -> torch.Tensor:
        lo = _N + self.num_buckets
        return self.vec[..., lo : lo + self.num_stale_levels]

    @property
    def pop_hist(self) -> Optional[torch.Tensor]:
        if self.num_pop_classes is None:
            return None
        lo = _N + self.num_buckets + self.num_stale_levels
        return self.vec[..., lo:]

    # -- accumulate ------------------------------------------------------ #

    def delta(
        self,
        wire,
        *,
        residual_l2=0.0,
        err_l2=0.0,
        err_cos=0.0,
        fp_count=0.0,
        fp_universe=0.0,
        live_workers=0.0,
        dropped_steps=0.0,
        checksum_failures=0.0,
        rs_density=0.0,
        rs_dense_switches=0.0,
        rs_oktopk_survivors=0.0,
        rs_oktopk_threshold=0.0,
        rs_oktopk_spills=0.0,
        bucket_saturated=0.0,
        staleness_hist=0.0,
        pop_hist=0.0,
    ) -> torch.Tensor:
        """One step's terms as one float32 vector in slot order (one cat)."""
        dev = self.device
        scalars = (
            1.0, wire.index_bits, wire.value_bits, wire.dense_bits, wire.saturated, residual_l2, err_l2, err_cos,
            fp_count, fp_universe, live_workers, dropped_steps, checksum_failures, rs_density, rs_dense_switches,
            rs_oktopk_survivors, rs_oktopk_threshold, rs_oktopk_spills, wire.ici_bits,
        )
        parts = [_term(x, 1, dev) for x in scalars]
        for x, n in ((bucket_saturated, self.num_buckets), (staleness_hist, self.num_stale_levels),
                     (pop_hist, self.num_pop_classes or 0)):
            if n:
                parts.append(_term(x, n, dev))
        return torch.cat(parts)

    def accumulate(self, wire, **terms) -> "MetricAccumulators":
        """The counters plus one step's terms (the JAX package's keywords)."""
        return self._like(self.vec + self.delta(wire, **terms))

    def add(self, delta: torch.Tensor) -> "MetricAccumulators":
        """The counters plus precomputed `delta` rows (the multi-tenant tick
        stacks its tenants' rows into one add)."""
        return self._like(self.vec + delta)

    def sum_tenants(self) -> "MetricAccumulators":
        """Per-tenant rows [T, n] -> the fleet totals [n]."""
        return self._like(self.vec.sum(dim=0))

    # -- derived ratios (on the device) ---------------------------------- #

    def rel_volume(self) -> torch.Tensor:
        return (self.index_bits + self.value_bits) / torch.clamp(self.dense_bits, min=_EPS)

    def measured_fpr(self) -> torch.Tensor:
        return self.fp_count / torch.clamp(self.fp_universe, min=1.0)

    @classmethod
    def scalar_fields(cls) -> Tuple[str, ...]:
        """The scalar counters' names, in declaration order."""
        return SCALAR_FIELDS

    # -- the host side --------------------------------------------------- #

    def fetch(self) -> Dict[str, Any]:
        """The cumulative counters as host floats: the window's one
        device-to-host copy. Scalars by name, `bucket_saturated` as a list,
        and `staleness_hist` / `pop_hist` where the accumulator has them."""
        if self.vec.dim() != 1:
            raise ValueError("fetch() reads one accumulator: sum_tenants() the per-tenant rows first")
        v = self.vec.cpu().tolist()
        vals: Dict[str, Any] = {name: float(v[i]) for i, name in enumerate(SCALAR_FIELDS)}
        lo = _N
        vals["bucket_saturated"] = [float(x) for x in v[lo : lo + self.num_buckets]]
        lo += self.num_buckets
        if self.num_stale_levels:
            vals["staleness_hist"] = [float(x) for x in v[lo : lo + self.num_stale_levels]]
        lo += self.num_stale_levels
        if self.num_pop_classes:
            vals["pop_hist"] = [float(x) for x in v[lo:]]
        return vals

    @staticmethod
    def derive(vals: Dict[str, Any]) -> Dict[str, Any]:
        """A fetched (or delta'd) counter dict -> the reported ratios and
        rates (the JAX package's keys)."""
        steps = max(vals["steps"], 1.0)
        dense = max(vals["dense_bits"], _EPS)
        bucket_sat = vals.get("bucket_saturated", [])
        out: Dict[str, Any] = {}
        if len(bucket_sat):
            out["bucket_saturated_per_step"] = [float(v) / steps for v in bucket_sat]
        stale_hist = vals.get("staleness_hist", [])
        if len(stale_hist):
            out["staleness_hist"] = [float(v) for v in stale_hist]
            out["staleness_p50"] = hist_quantile(stale_hist, 0.50)
            out["staleness_p95"] = hist_quantile(stale_hist, 0.95)
            out["staleness_p99"] = hist_quantile(stale_hist, 0.99)
        pop_hist = vals.get("pop_hist", [])
        if len(pop_hist):
            out["pop_hist"] = [float(v) for v in pop_hist]
            total = max(sum(float(v) for v in pop_hist), 1.0)
            out["pop_shares"] = [float(v) / total for v in pop_hist]
            out["pop_residency_min"] = min(out["pop_shares"])
        return out | {
            "steps": vals["steps"],
            "cumulative_total_bits": vals["index_bits"] + vals["value_bits"],
            "rel_volume": (vals["index_bits"] + vals["value_bits"]) / dense,
            "idx_rel_volume": vals["index_bits"] / dense,
            "val_rel_volume": vals["value_bits"] / dense,
            "saturated_per_step": vals["saturated"] / steps,
            "residual_l2_per_step": vals["residual_l2"] / steps,
            "compress_err_l2": vals["err_l2"] / steps,
            "compress_err_cos": vals["err_cos"] / steps,
            "measured_fpr": vals["fp_count"] / max(vals["fp_universe"], 1.0),
            "live_workers_per_step": vals["live_workers"] / steps,
            "dropped_steps": vals["dropped_steps"],
            "checksum_failures": vals["checksum_failures"],
            "rs_density_per_step": vals["rs_density"] / steps,
            "rs_dense_switch_rate": vals["rs_dense_switches"] / steps,
            "rs_oktopk_survivors_per_step": vals["rs_oktopk_survivors"] / steps,
            "rs_oktopk_threshold": vals["rs_oktopk_threshold"] / steps,
            "rs_oktopk_spill_rate": vals["rs_oktopk_spills"] / steps,
            "ici_bytes_per_step": vals["ici_bits"] / 8.0 / steps,
            "dcn_bytes_per_step": (vals["index_bits"] + vals["value_bits"])
            / 8.0 / steps,
        }

    def summary(self, prev: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Fetch and derive; with `prev` (an earlier `fetch()`), also every
        rate over the window since it under `window_*` keys."""
        vals = self.fetch()
        out = self.derive(vals)
        if prev is not None:
            window = self.derive(fetch_delta(vals, prev))
            out.update({f"window_{k}": v for k, v in window.items()})
        return out
