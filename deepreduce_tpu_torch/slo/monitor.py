"""Rolling-window health monitor with an auditable ``health.jsonl`` trail,
a copy of `deepreduce_tpu/slo/monitor.py` (with `hist_quantile` from its
telemetry package): host Python over the federated tick reports.

The `HealthMonitor` is the serving-path sibling of the compression
controller: a host-side, deterministic pure function of the telemetry
report stream. Each tick it evaluates the `SLOSpec` targets over rolling
windows of recorded reports and walks a hysteretic three-rung ladder

    OK -> DEGRADED -> BREACH   (and back down, one rung at a time)

Transitions — and only transitions — are emitted as schema-validated
records to ``health.jsonl``; a flapping metric that crosses its ceiling
every other window never builds the `hysteresis_ticks` streak and so
emits nothing (no transition storms). Records carry no wall-clock
timestamp: the trail is a pure function of the report stream, which is
what lets `fedsim check --slo` replay it bitwise across kill/resume.

Severity grading is multi-window. A plain target (clients floor,
staleness-p95 ceiling, buffer-fill bound, convergence residency) grades
DEGRADED when violated over the evaluation window and BREACH-grade only
when the violation also holds over the full slow window. The checksum
error budget grades on classic fast/slow burn rates: burn = observed
failure fraction / budget; BREACH-grade requires the fast window to burn
at `burn_fast` x budget WHILE the slow window still burns at `burn_slow`
x budget, so a transient spike pages nobody but a sustained burn cannot
hide behind a long quiet history.

Everything in the monitor state is plain JSON-serializable Python
(ints, floats, lists, dicts), so `state_dict()` round-trips bitwise
through a JSON sidecar next to the checkpoint.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deepreduce_tpu_torch.slo.spec import SLOSpec, TARGET_KEYS


def hist_quantile(hist, q: float) -> float:
    """Exact q-quantile of the discrete staleness distribution a counts
    histogram encodes: the smallest level d whose CDF reaches q. Staleness
    levels are integers (indices into the latency distribution), so no
    interpolation is involved — the returned tail is exact, not estimated.
    0.0 on an empty/all-zero histogram (a degenerate run observed nothing).
    A copy of the JAX package's telemetry helper."""
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

HEALTH_STATES = ("OK", "DEGRADED", "BREACH")
_LEVEL = {s: i for i, s in enumerate(HEALTH_STATES)}

# the downward transition's trigger code; upward transitions carry the
# violated target key
TRIG_RECOVERED = "recovered"
TRIGGER_CODES = tuple(TARGET_KEYS) + (TRIG_RECOVERED,)

# health.jsonl schema: field name -> accepted types. Every record must
# carry exactly these keys (documented in ARCHITECTURE.md).
HEALTH_SCHEMA: Dict[str, Tuple[type, ...]] = {
    "tick": (int,),
    "tenant": (int,),
    "window_ticks": (int,),
    "from_state": (str,),
    "to_state": (str,),
    "trigger": (str,),
    "value": (float, type(None)),
    "threshold": (float, type(None)),
    "burn_fast": (float, type(None)),
    "burn_slow": (float, type(None)),
}


def validate_health(rec: Dict[str, Any]) -> None:
    """Raise ValueError unless `rec` matches HEALTH_SCHEMA exactly."""
    if not isinstance(rec, dict):
        raise ValueError(f"health record must be a dict, got {type(rec)}")
    missing = sorted(set(HEALTH_SCHEMA) - set(rec))
    extra = sorted(set(rec) - set(HEALTH_SCHEMA))
    if missing or extra:
        raise ValueError(
            f"health record keys mismatch: missing={missing} extra={extra}"
        )
    for key, types in HEALTH_SCHEMA.items():
        # bool is an int subclass; keep tick/tenant/window strictly int.
        if isinstance(rec[key], bool) and bool not in types:
            raise ValueError(f"health field {key}={rec[key]!r} is bool, want {types}")
        if not isinstance(rec[key], types):
            raise ValueError(
                f"health field {key}={rec[key]!r} has type "
                f"{type(rec[key]).__name__}, want {types}"
            )
    for key in ("from_state", "to_state"):
        if rec[key] not in HEALTH_STATES:
            raise ValueError(f"unknown health state {rec[key]!r} in {key}")
    if rec["trigger"] not in TRIGGER_CODES:
        raise ValueError(f"unknown trigger code {rec['trigger']!r}")
    if rec["tick"] < 0 or rec["tenant"] < 0 or rec["window_ticks"] < 1:
        raise ValueError(
            f"health record out of range: tick={rec['tick']} "
            f"tenant={rec['tenant']} window_ticks={rec['window_ticks']}"
        )
    delta = _LEVEL[rec["to_state"]] - _LEVEL[rec["from_state"]]
    if abs(delta) != 1:
        raise ValueError(
            f"health transition {rec['from_state']} -> {rec['to_state']} "
            "must move exactly one rung"
        )
    if (delta < 0) != (rec["trigger"] == TRIG_RECOVERED):
        raise ValueError(
            "downward transitions carry trigger='recovered' and upward "
            f"ones a target key; got {rec['trigger']!r} for "
            f"{rec['from_state']} -> {rec['to_state']}"
        )


def validate_health_stream(records: Sequence[Dict[str, Any]]) -> None:
    """Validate every record plus the cross-record contracts: per-tenant
    ticks strictly increase and consecutive transitions chain (a
    tenant's from_state equals its previous to_state)."""
    last: Dict[int, Dict[str, Any]] = {}
    for i, rec in enumerate(records):
        try:
            validate_health(rec)
        except ValueError as e:
            raise ValueError(f"health.jsonl record {i}: {e}") from e
        prev = last.get(rec["tenant"])
        if prev is not None:
            if rec["tick"] <= prev["tick"]:
                raise ValueError(
                    f"health.jsonl record {i}: non-monotonic tick "
                    f"{rec['tick']} <= {prev['tick']} for tenant "
                    f"{rec['tenant']}"
                )
            if rec["from_state"] != prev["to_state"]:
                raise ValueError(
                    f"health.jsonl record {i}: broken transition chain "
                    f"for tenant {rec['tenant']}: from_state="
                    f"{rec['from_state']!r} after to_state="
                    f"{prev['to_state']!r}"
                )
        last[rec["tenant"]] = rec


class HealthLog:
    """Append-only, schema-validated ``health.jsonl`` writer. Rejects
    per-tenant tick regressions at append time, so a buggy driver can
    never write a trail the stream validator would refuse to read."""

    def __init__(self, path) -> None:
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._last_tick: Dict[int, int] = {}

    def append(self, rec: Dict[str, Any]) -> None:
        validate_health(rec)
        last = self._last_tick.get(rec["tenant"])
        if last is not None and rec["tick"] <= last:
            raise ValueError(
                f"non-monotonic health tick {rec['tick']} <= {last} for "
                f"tenant {rec['tenant']}"
            )
        self._last_tick[rec["tenant"]] = rec["tick"]
        with self.path.open("a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    @staticmethod
    def read(path) -> List[Dict[str, Any]]:
        path = pathlib.Path(path)
        if not path.exists():
            return []
        records = []
        with path.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        return records


# report keys the monitor consumes; everything else in a row is ignored.
# staleness_hist is a list, the rest are scalars.
_REPORT_SCALARS = (
    "clients", "clients_per_sec", "buffer_fill", "checksum_failures",
    "w_rel_err",
)


def _normalize_report(report: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in _REPORT_SCALARS:
        if report.get(key) is not None:
            out[key] = float(report[key])
    hist = report.get("staleness_hist")
    if hist is not None and len(hist):
        out["staleness_hist"] = [float(h) for h in hist]
    pop = report.get("pop_hist")
    if pop is not None and len(pop):
        out["pop_hist"] = [float(h) for h in pop]
    return out


def _mean_of(rows: Sequence[Dict[str, Any]], key: str) -> Optional[float]:
    vals = [r[key] for r in rows if key in r]
    return sum(vals) / len(vals) if vals else None


def _max_of(rows: Sequence[Dict[str, Any]], key: str) -> Optional[float]:
    vals = [r[key] for r in rows if key in r]
    return max(vals) if vals else None


def _hist_p95(rows: Sequence[Dict[str, Any]]) -> Optional[float]:
    hists = [r["staleness_hist"] for r in rows if "staleness_hist" in r]
    if not hists:
        return None
    depth = max(len(h) for h in hists)
    total = [0.0] * depth
    for h in hists:
        for d, v in enumerate(h):
            total[d] += v
    return hist_quantile(total, 0.95)


def _residency(
    rows: Sequence[Dict[str, Any]], band: float
) -> Optional[float]:
    vals = [r["w_rel_err"] for r in rows if "w_rel_err" in r]
    if not vals:
        return None
    return sum(1.0 for v in vals if v <= band) / len(vals)


def _pop_min_share(rows: Sequence[Dict[str, Any]]) -> Optional[float]:
    hists = [r["pop_hist"] for r in rows if "pop_hist" in r]
    if not hists:
        return None
    depth = max(len(h) for h in hists)
    total = [0.0] * depth
    for h in hists:
        for k, v in enumerate(h):
            total[k] += v
    grand = sum(total)
    if grand <= 0.0:
        return None
    return min(total) / grand


def _burn(rows: Sequence[Dict[str, Any]], budget: float) -> float:
    fails = sum(r.get("checksum_failures", 0.0) for r in rows)
    total = sum(
        r.get("clients", 0.0) + r.get("checksum_failures", 0.0)
        for r in rows
    )
    frac = fails / total if total > 0.0 else 0.0
    return frac / budget


class _Eval:
    """One target's evaluation this tick (value=None: no data, level 0)."""

    __slots__ = ("key", "level", "value", "threshold", "burn_fast",
                 "burn_slow")

    def __init__(self, key, level, value, threshold,
                 burn_fast=None, burn_slow=None):
        self.key = key
        self.level = level
        self.value = value
        self.threshold = threshold
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow


class HealthMonitor:
    """Walks the OK/DEGRADED/BREACH ladder from the report stream.

    Host-side only, like the compression controller: feed it one report
    dict per (tick, tenant) via `observe` and it returns the transition
    records it emitted (at most one per call — the ladder moves one rung
    per tick). State round-trips through `state_dict`/`load_state_dict`
    as plain JSON types, so a resumed run continues the trail bitwise.
    """

    def __init__(
        self,
        spec: SLOSpec,
        *,
        log: Optional[HealthLog] = None,
    ) -> None:
        self.spec = spec
        self.log = log
        self.events: List[Dict[str, Any]] = []
        # tenant -> {"level", "up", "down", "last_tick", "history"}
        self._tenants: Dict[int, Dict[str, Any]] = {}

    # -- evaluation -----------------------------------------------------

    @property
    def is_noop(self) -> bool:
        return self.spec.is_noop

    def _history_cap(self) -> int:
        return max(self.spec.window_ticks, self.spec.slow_window_ticks)

    def _tenant(self, tenant: int) -> Dict[str, Any]:
        st = self._tenants.get(tenant)
        if st is None:
            st = {"level": 0, "up": 0, "down": 0, "last_tick": -1,
                  "history": []}
            self._tenants[tenant] = st
        return st

    def _evaluate(
        self, targets: Dict[str, float], history: List[Dict[str, Any]]
    ) -> List[_Eval]:
        spec = self.spec
        win = history[-spec.window_ticks:]
        slow = history[-spec.slow_window_ticks:]
        fast = history[-spec.fast_window_ticks:]
        # BREACH grade needs the violation sustained over a FULL slow
        # window; with a shorter history the grade caps at DEGRADED.
        slow_full = len(history) >= spec.slow_window_ticks

        def graded(key, thr, now, sustained, violated):
            level = 0
            if now is not None and violated(now):
                level = 1
                if (slow_full and sustained is not None
                        and violated(sustained)):
                    level = 2
            return _Eval(key, level, now, thr)

        evals: List[_Eval] = []
        for key in TARGET_KEYS:
            if key not in targets:
                continue
            thr = targets[key]
            if key == "min_clients_per_round":
                evals.append(graded(
                    key, thr, _mean_of(win, "clients"),
                    _mean_of(slow, "clients"), lambda v: v < thr))
            elif key == "min_clients_per_sec":
                evals.append(graded(
                    key, thr, _mean_of(win, "clients_per_sec"),
                    _mean_of(slow, "clients_per_sec"), lambda v: v < thr))
            elif key == "staleness_p95_max":
                evals.append(graded(
                    key, thr, _hist_p95(win), _hist_p95(slow),
                    lambda v: v > thr))
            elif key == "buffer_fill_max":
                evals.append(graded(
                    key, thr, _max_of(win, "buffer_fill"),
                    _max_of(slow, "buffer_fill"), lambda v: v > thr))
            elif key == "checksum_failure_budget":
                bf = _burn(fast, thr)
                bs = _burn(slow, thr)
                level = 0
                if bs >= self.spec.burn_slow:
                    level = 2 if (
                        slow_full and bf >= self.spec.burn_fast
                    ) else 1
                ev = _Eval(key, level, bs * thr, thr, bf, bs)
                evals.append(ev)
            elif key == "convergence_band":
                resid_min = targets.get("convergence_residency_min", 1.0)
                evals.append(graded(
                    key, resid_min, _residency(win, thr),
                    _residency(slow, thr), lambda v: v < resid_min))
            elif key == "pop_residency_min":
                evals.append(graded(
                    key, thr, _pop_min_share(win), _pop_min_share(slow),
                    lambda v: v < thr))
            # convergence_residency_min is folded into convergence_band
        return evals

    def observe(
        self, tick: int, report: Dict[str, Any], tenant: int = 0
    ) -> List[Dict[str, Any]]:
        """Feed one (tick, tenant) report; returns the emitted records."""
        if self.is_noop:
            return []
        targets = self.spec.effective_targets(tenant)
        if not targets:
            return []
        st = self._tenant(tenant)
        if tick <= st["last_tick"]:
            raise ValueError(
                f"non-monotonic observe tick {tick} <= {st['last_tick']} "
                f"for tenant {tenant}"
            )
        st["last_tick"] = tick
        st["history"].append(_normalize_report(report))
        del st["history"][:-self._history_cap()]

        evals = self._evaluate(targets, st["history"])
        desired = max((e.level for e in evals), default=0)
        cur = st["level"]
        if desired > cur:
            st["up"] += 1
            st["down"] = 0
        elif desired < cur:
            st["down"] += 1
            st["up"] = 0
        else:
            st["up"] = 0
            st["down"] = 0

        emitted: List[Dict[str, Any]] = []
        hyst = self.spec.hysteresis_ticks
        if st["up"] >= hyst and cur < len(HEALTH_STATES) - 1:
            worst = max(
                (e for e in evals if e.level > 0),
                key=lambda e: (e.level, -list(TARGET_KEYS).index(e.key)),
            )
            rec = {
                "tick": tick,
                "tenant": tenant,
                "window_ticks": self.spec.window_ticks,
                "from_state": HEALTH_STATES[cur],
                "to_state": HEALTH_STATES[cur + 1],
                "trigger": worst.key,
                "value": worst.value,
                "threshold": worst.threshold,
                "burn_fast": worst.burn_fast,
                "burn_slow": worst.burn_slow,
            }
            st["level"] = cur + 1
            st["up"] = 0
            emitted.append(rec)
        elif st["down"] >= hyst and cur > 0:
            rec = {
                "tick": tick,
                "tenant": tenant,
                "window_ticks": self.spec.window_ticks,
                "from_state": HEALTH_STATES[cur],
                "to_state": HEALTH_STATES[cur - 1],
                "trigger": TRIG_RECOVERED,
                "value": None,
                "threshold": None,
                "burn_fast": None,
                "burn_slow": None,
            }
            st["level"] = cur - 1
            st["down"] = 0
            emitted.append(rec)
        for rec in emitted:
            self.events.append(rec)
            if self.log is not None:
                self.log.append(rec)
        return emitted

    # -- verdicts -------------------------------------------------------

    def state_of(self, tenant: int = 0) -> str:
        st = self._tenants.get(tenant)
        return HEALTH_STATES[st["level"]] if st is not None else "OK"

    def final_states(self) -> Dict[int, str]:
        return {
            t: HEALTH_STATES[st["level"]]
            for t, st in sorted(self._tenants.items())
        }

    def healthy(self) -> bool:
        """True iff every observed tenant sits at OK right now."""
        return all(st["level"] == 0 for st in self._tenants.values())

    def verdict(self, tenant: int = 0) -> Dict[str, Any]:
        """Current state + per-target windowed value/threshold/ok for the
        `telemetry slo` table. value None = no data in the window."""
        targets = self.spec.effective_targets(tenant)
        st = self._tenants.get(tenant)
        history = st["history"] if st is not None else []
        rows = {}
        for ev in self._evaluate(targets, list(history)):
            rows[ev.key] = {
                "value": ev.value,
                "threshold": ev.threshold,
                "ok": ev.level == 0,
                "burn_fast": ev.burn_fast,
                "burn_slow": ev.burn_slow,
            }
        return {
            "tenant": tenant,
            "state": self.state_of(tenant),
            "targets": rows,
        }

    # -- checkpoint plumbing -------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Plain-JSON state: round-trips bitwise through json.dumps."""
        return {
            "tenants": {
                str(t): {
                    "level": st["level"],
                    "up": st["up"],
                    "down": st["down"],
                    "last_tick": st["last_tick"],
                    "history": [dict(r) for r in st["history"]],
                }
                for t, st in self._tenants.items()
            },
            "events": [dict(r) for r in self.events],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._tenants = {
            int(t): {
                "level": int(st["level"]),
                "up": int(st["up"]),
                "down": int(st["down"]),
                "last_tick": int(st["last_tick"]),
                "history": [dict(r) for r in st["history"]],
            }
            for t, st in state["tenants"].items()
        }
        self.events = [dict(r) for r in state["events"]]
