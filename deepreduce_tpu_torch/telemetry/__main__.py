"""`python -m deepreduce_tpu_torch.telemetry {summary,compare,calibrate,
profiles,slo,bench-history,trace}` — the offline consumer of tracking.py
run directories, a copy of `deepreduce_tpu/telemetry/__main__.py` that
reads the port's `costmodel`, `slo` and `hist_quantile`. It digests the
records it is given, whichever package wrote them: on the same run
directories both CLIs print the same output.

- ``summary RUN``            one-screen digest of a run: loss trajectory,
                             rel-volume and step-time distributions, and
                             the device-accumulator fields from
                             summary.json when the run had telemetry on.
- ``compare RUN_A RUN_B``    diff two runs' step-time and rel-volume
                             distributions; exits 1 when B's mean step
                             time regresses past ``--tol`` vs A.
- ``compare RUN --against BENCH_DECODE_r06.json``
                             check a run against the committed decode-
                             strategy bench record (matched on the run's
                             `decode_strategy` config); exits 1 on a
                             step-time regression — the bench trajectory's
                             automated consumer.
- ``compare RUN_A RUN_B --ctrl``
                             adaptive-vs-fixed diff: cumulative wire
                             volume at matched (running-min) loss; exits 1
                             when the adaptive run (A) spent >= wire than
                             the fixed baseline (B).
- ``trace RUN [--out F]``    merged Chrome trace: the run's span events
                             (trace.json, written by a telemetry run's
                             `spans.save`) plus per-step metrics as "C"
                             counter events; adaptive runs additionally get
                             ctrl_ladder_index/ctrl_ratio counter tracks and
                             instant markers at each operating-point switch.
                             Load the output in Perfetto.
- ``trace RUN --overlap``    wall-clock overlap fraction between the
                             train/forward_backward spans and the
                             exchange/bucket/* dispatch spans — ~1 for a
                             streaming run (cfg.stream_exchange), 0 for a
                             barrier/pipeline run; exits 1 below
                             ``--overlap-threshold`` (the CI gate that
                             backprop-overlapped dispatch actually
                             happened).
- ``calibrate RUN [--out F]``
                             fit a MachineProfile from the run's telemetry
                             (costmodel.calibrate): span self-times joined
                             with the per-axis wire counters, warmup
                             dropped. Emits a schema-validated profile
                             record — no wall clock in it, so a committed
                             run dir replays bitwise. Exits 1 when the
                             fitted model's predicted step time misses the
                             measured one by more than ``--tol``.
- ``compare --profile P --against BENCH.json``
                             re-price a committed bench claim under a
                             fitted machine profile: re-run the plan
                             selection with and without the profile and
                             report each sweep point where the static pick
                             and the calibrated pick disagree (and what
                             the static pick costs under the fitted
                             model). Informational — exits 0. Pass
                             ``--profile`` twice to compare the picks of
                             two fitted profiles (A vs B) instead of
                             static vs fitted.
- ``slo RUN --spec slo.json``
                             per-tenant SLO verdict table: replay the
                             run's tick stream through the health monitor
                             (slo/monitor.py) and print each target's
                             windowed value vs threshold plus any
                             OK/DEGRADED/BREACH transitions; exits 1 when
                             any tenant ends in BREACH — the gate a
                             "healthy at N clients/s" claim hangs on.
- ``bench-history [DIR]``    longitudinal view of the committed
                             BENCH_*.json ledger: one provenance-stamped
                             trend row per round (headline metric,
                             modeled/measured flag, profile_sha256 when
                             present); exits 2 on a schema-less record.
- ``profiles A.json B.json [...] --against BENCH.json``
                             cross-profile drift sentinel: per-parameter
                             drift between saved machine profiles,
                             per-route row disagreement from their v2
                             route tables, and — the load-bearing part —
                             which committed bench plan selections flip
                             between profiles. Exits 1 when any
                             ``--against`` sweep point's pick differs
                             between any two of the profiles.

Step-time statistics drop compile-dominated warmup intervals by default
(``--include-warmup`` keeps them). Runs with telemetry off get a clean
"telemetry was off" notice instead of partial output. RUN may be a run
directory or a tracking root (latest run is picked). Exit codes: 0 ok,
1 flagged regression, 2 usage/data error.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Any, Dict, List, Optional

from deepreduce_tpu_torch import costmodel


def _fail(msg: str) -> int:
    print(f"telemetry: error: {msg}", file=sys.stderr)
    return 2


def _resolve_run(path: str) -> Optional[pathlib.Path]:
    """A run dir (has config.json) or a tracking root (latest run wins)."""
    p = pathlib.Path(path)
    if (p / "config.json").exists():
        return p
    if p.is_dir():
        runs = sorted(
            (d for d in p.iterdir() if (d / "config.json").exists()),
            key=lambda d: d.stat().st_mtime,
        )
        if runs:
            return runs[-1]
    return None


def _history(run: pathlib.Path) -> List[Dict[str, Any]]:
    path = run / "metrics.jsonl"
    if not path.exists():
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _load_json(path: pathlib.Path) -> Dict[str, Any]:
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def _decisions(run: pathlib.Path) -> List[Dict[str, Any]]:
    """The adaptive controller's decisions.jsonl trail ([] when absent)."""
    path = run / "decisions.jsonl"
    if not path.exists():
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _telemetry_off(run: pathlib.Path, summ: Dict[str, Any]) -> bool:
    """True when the run recorded no telemetry artifacts at all: no device
    accumulators in summary.json and no span trace. Used to print a clean
    'telemetry was off' notice instead of silently partial output."""
    return not isinstance(summ.get("telemetry"), dict) and not (
        run / "trace.json"
    ).exists()


def _series(hist: List[Dict[str, Any]], key: str) -> List[float]:
    return [float(r[key]) for r in hist if isinstance(r.get(key), (int, float))]


def _step_times(
    hist: List[Dict[str, Any]], include_warmup: bool = False
) -> List[float]:
    """Per-step wall time from consecutive metrics.jsonl timestamps.
    Compile-dominated warmup intervals are dropped by default via
    costmodel.drop_warmup — robust to MULTIPLE compiled programs per run
    (a streaming run compiles two), where the old drop-first-only policy
    let the second warmup step skew p50/p99 and the calibration fit.
    `--include-warmup` keeps every interval."""
    ts = _series(hist, "ts")
    dt = [b - a for a, b in zip(ts, ts[1:]) if b >= a]
    if include_warmup or len(dt) <= 2:
        return dt
    return costmodel.drop_warmup(dt)


def _percentile(xs: List[float], q: float) -> float:
    """Sorted linear-interpolation quantile (numpy's default 'linear'
    method, without numpy): exact order statistics at the grid points,
    interpolated between them — so p95/p99 of short series move smoothly
    instead of snapping to the nearest rank."""
    if not xs:
        return float("nan")
    ys = sorted(xs)
    if len(ys) == 1:
        return ys[0]
    pos = q * (len(ys) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ys) - 1)
    frac = pos - lo
    return ys[lo] * (1.0 - frac) + ys[hi] * frac


def _dist(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"n": 0}
    return {
        "n": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": _percentile(xs, 0.5),
        "p90": _percentile(xs, 0.9),
        "p95": _percentile(xs, 0.95),
        "p99": _percentile(xs, 0.99),
        "min": min(xs),
        "max": max(xs),
    }


def _fmt_dist(d: Dict[str, float], unit: str = "") -> str:
    if not d.get("n"):
        return "(no samples)"
    return (
        f"mean {d['mean']:.6g}{unit}  p50 {d['p50']:.6g}{unit}  "
        f"p90 {d['p90']:.6g}{unit}  p95 {d['p95']:.6g}{unit}  "
        f"p99 {d['p99']:.6g}{unit}  n={d['n']}"
    )


def _run_report(
    run: pathlib.Path, include_warmup: bool = False
) -> Dict[str, Any]:
    cfg = _load_json(run / "config.json")
    summ = _load_json(run / "summary.json")
    hist = _history(run)
    losses = _series(hist, "loss")
    report = {
        "run": run.name,
        "dir": str(run),
        "config": cfg.get("config", {}),
        "steps_logged": len(hist),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "rel_volume": _dist(_series(hist, "rel_volume")),
        "step_time_s": _dist(_step_times(hist, include_warmup)),
    }
    telem = summ.get("telemetry")
    if isinstance(telem, dict):
        report["telemetry"] = telem
    if _telemetry_off(run, summ):
        report["telemetry_off"] = True
    fedsim = _fedsim_report(hist)
    if fedsim is not None:
        report["fedsim"] = fedsim
    ctrl = _ctrl_report(run)
    if ctrl is not None:
        report["ctrl"] = ctrl
    return report


def _ctrl_report(run: pathlib.Path) -> Optional[Dict[str, Any]]:
    """Adaptive-controller digest from decisions.jsonl (None when the run
    had no controller). `effective_ratio` is the step-weighted mean of the
    rung each window actually ran at (old_ratio — the switch takes effect
    for the NEXT window); `ctrl_switches_per_step` normalizes switch churn
    by the decision span so runs of different lengths compare."""
    decs = _decisions(run)
    if not decs:
        return None
    switches = [d for d in decs if d.get("switched")]
    span = max((int(d.get("step", 0)) for d in decs), default=0)
    wsum = sum(float(d.get("window_steps", 0)) for d in decs)
    wratio = sum(
        float(d.get("window_steps", 0)) * float(d.get("old_ratio", 0.0))
        for d in decs
    )
    last = decs[-1]
    out: Dict[str, Any] = {
        "decisions": len(decs),
        "switches": len(switches),
        "ctrl_switches_per_step": len(switches) / span if span else 0.0,
        "effective_ratio": wratio / wsum if wsum else None,
        "final_index": last.get("new_index"),
        "final_ratio": last.get("new_ratio"),
        "trail": [
            f"{d.get('step')}: {d.get('old_index')}->{d.get('new_index')} "
            f"({d.get('trigger')}/{d.get('rationale')})"
            for d in switches
        ],
    }
    return out


def _fedsim_report(hist: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Federated-round rates when the run logged fedsim metrics (`clients` +
    `uplink_bytes` per round, as the fedsim CLI / bench drivers write).
    clients/sec pairs each round's live-client count with the wall interval
    to the previous record, first (compile-bearing) interval dropped like
    `_step_times`."""
    clients = _series(hist, "clients")
    uplink = _series(hist, "uplink_bytes")
    if not clients or not uplink:
        return None
    rates = []
    recs = [r for r in hist if isinstance(r.get("ts"), (int, float))]
    for prev, cur in zip(recs, recs[1:]):
        dt = cur["ts"] - prev["ts"]
        c = cur.get("clients")
        if dt > 0 and isinstance(c, (int, float)):
            rates.append(float(c) / dt)
    if len(rates) > 2:
        rates = rates[1:]
    out: Dict[str, Any] = {
        "uplink_bytes_per_round": _dist(uplink),
        "clients_per_round": _dist(clients),
    }
    if rates:
        out["clients_per_sec"] = _dist(rates)
    failures = _series(hist, "checksum_failures")
    if failures:
        out["checksum_failures_total"] = sum(failures)
    # asynchronous buffered mode: per-tick staleness + buffer digests (the
    # async driver logs staleness_mean/staleness_max/buffer_fill/applied)
    st_mean = _series(hist, "staleness_mean")
    st_max = _series(hist, "staleness_max")
    if st_mean:
        out["fed_staleness_mean"] = sum(st_mean) / len(st_mean)
    if st_max:
        out["fed_staleness_max"] = max(st_max)
    # exact staleness tail from the on-device per-tick histograms (the new
    # psum members): sum the f32[D] rows over the run, then read discrete
    # quantiles off the cumulative counts — no sampling, no interpolation
    hists = [
        r["staleness_hist"] for r in hist
        if isinstance(r.get("staleness_hist"), list) and r["staleness_hist"]
    ]
    if hists:
        from deepreduce_tpu_torch.telemetry.device_metrics import hist_quantile

        depth = max(len(h) for h in hists)
        total = [
            sum(float(h[d]) for h in hists if d < len(h))
            for d in range(depth)
        ]
        out["fed_staleness_hist_total"] = total
        out["fed_staleness_p50"] = hist_quantile(total, 0.50)
        out["fed_staleness_p95"] = hist_quantile(total, 0.95)
        out["fed_staleness_p99"] = hist_quantile(total, 0.99)
    # heterogeneous populations: exact per-class participation from the
    # on-device pop_hist psum member (per-round f32[K] rows, logged as
    # lists) — cumulative counts, shares, and the worst class's share
    pop_hists = [
        r["pop_hist"] for r in hist
        if isinstance(r.get("pop_hist"), list) and r["pop_hist"]
    ]
    if pop_hists:
        K = max(len(h) for h in pop_hists)
        pop_total = [
            sum(float(h[k]) for h in pop_hists if k < len(h))
            for k in range(K)
        ]
        grand = max(sum(pop_total), 1.0)
        out["fed_pop_classes"] = K
        out["fed_pop_hist_total"] = pop_total
        out["fed_pop_shares"] = [v / grand for v in pop_total]
        out["fed_pop_residency_min"] = min(out["fed_pop_shares"])
    fills = [
        float(r["buffer_fill"])
        for r in hist
        if isinstance(r.get("buffer_fill"), (int, float))
        and float(r.get("applied", 0.0)) > 0
    ]
    if fills:
        # buffer occupancy at the moment of each buffered apply — how far
        # past the K threshold the ingest stream overshoots
        out["fed_buffer_fill_per_apply"] = sum(fills) / len(fills)
    # multi-tenant rows: the MT driver logs per-tenant LISTS under *_t keys
    # next to the scalar fleet aggregates digested above — render the
    # tenant-indexed variants of the r20 rows
    mt = _mt_fedsim_rows(hist)
    if mt:
        out.update(mt)
    return out


def _mt_series(hist: List[Dict[str, Any]], key: str) -> List[List[float]]:
    return [
        [float(x) for x in r[key]]
        for r in hist
        if isinstance(r.get(key), list) and r[key]
    ]


def _mt_fedsim_rows(hist: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Tenant-indexed fedsim digests from the per-tenant `*_t` list rows
    the multi-tenant driver logs ({} for single-tenant runs). Each output
    is a length-T list, index = tenant slot."""
    clients_t = _mt_series(hist, "clients_t")
    if not clients_t:
        return {}
    T = max(len(row) for row in clients_t)
    out: Dict[str, Any] = {"fed_tenants": T}
    # per-tenant clients/sec: pair each tick's per-tenant live count with
    # the wall interval to the previous record (first interval dropped,
    # like the aggregate rate)
    recs = [
        r for r in hist
        if isinstance(r.get("ts"), (int, float))
        and isinstance(r.get("clients_t"), list)
    ]
    rates: List[List[float]] = [[] for _ in range(T)]
    for prev, cur in zip(recs, recs[1:]):
        dt = cur["ts"] - prev["ts"]
        if dt <= 0:
            continue
        for t, c in enumerate(cur["clients_t"][:T]):
            rates[t].append(float(c) / dt)
    rates = [r[1:] if len(r) > 2 else r for r in rates]
    if any(rates):
        out["fed_mt_clients_per_sec"] = [
            (sum(r) / len(r)) if r else 0.0 for r in rates
        ]
    # rows can be RAGGED: a run dir mixing single-tenant and MT records,
    # or a tenant-geometry change mid-dir, logs rows shorter than T —
    # average/maximize each slot over the rows that actually carry it
    # instead of indexing row[t] into an IndexError
    st_mean_t = _mt_series(hist, "staleness_mean_t")
    if st_mean_t:
        out["fed_mt_staleness_mean"] = [
            (
                sum(row[t] for row in st_mean_t if t < len(row))
                / max(sum(1 for row in st_mean_t if t < len(row)), 1)
            )
            for t in range(T)
        ]
    st_max_t = _mt_series(hist, "staleness_max_t")
    if st_max_t:
        out["fed_mt_staleness_max"] = [
            max((row[t] for row in st_max_t if t < len(row)), default=0.0)
            for t in range(T)
        ]
    # per-tenant staleness tails from the [T, D] on-device histogram rows
    hist_t_rows = [
        r["staleness_hist_t"] for r in hist
        if isinstance(r.get("staleness_hist_t"), list) and r["staleness_hist_t"]
    ]
    if hist_t_rows:
        from deepreduce_tpu_torch.telemetry.device_metrics import hist_quantile

        totals: List[List[float]] = [[] for _ in range(T)]
        for row in hist_t_rows:
            for t, h in enumerate(row):
                if t >= T or not isinstance(h, list):
                    continue
                if len(h) > len(totals[t]):
                    totals[t].extend([0.0] * (len(h) - len(totals[t])))
                for d, v in enumerate(h):
                    totals[t][d] += float(v)
        for q, name in ((0.50, "fed_mt_staleness_p50"),
                        (0.95, "fed_mt_staleness_p95"),
                        (0.99, "fed_mt_staleness_p99")):
            out[name] = [hist_quantile(tot, q) for tot in totals]
    # per-tenant buffer occupancy at that tenant's own applies (the
    # tenant-indexed fed_buffer_fill_per_apply)
    fill_rows = [
        r for r in hist
        if isinstance(r.get("buffer_fill_t"), list)
        and isinstance(r.get("applied_t"), list)
    ]
    if fill_rows:
        fills_t: List[List[float]] = [[] for _ in range(T)]
        for r in fill_rows:
            for t, (f, a) in enumerate(zip(r["buffer_fill_t"], r["applied_t"])):
                if t < T and float(a) > 0:
                    fills_t[t].append(float(f))
        if any(fills_t):
            out["fed_mt_buffer_fill_per_apply"] = [
                (sum(f) / len(f)) if f else 0.0 for f in fills_t
            ]
    return out


# ---------------------------------------------------------------------- #
# summary
# ---------------------------------------------------------------------- #


def cmd_summary(args) -> int:
    run = _resolve_run(args.run)
    if run is None:
        return _fail(f"no run directory under {args.run!r} (need config.json)")
    rep = _run_report(run, args.include_warmup)
    if args.json:
        print(json.dumps(rep, indent=2))
        return 0
    cfg = rep["config"]
    print(f"run {rep['run']}  ({rep['dir']})")
    if cfg:
        knobs = ", ".join(f"{k}={v}" for k, v in sorted(cfg.items()))
        print(f"  config: {knobs}")
    print(f"  steps logged: {rep['steps_logged']}")
    if rep["loss_first"] is not None:
        print(f"  loss: {rep['loss_first']:.4f} -> {rep['loss_last']:.4f}")
    print(f"  rel_volume: {_fmt_dist(rep['rel_volume'])}")
    print(f"  step_time:  {_fmt_dist(rep['step_time_s'], 's')}")
    if "fedsim" in rep:
        fed = rep["fedsim"]
        print("  fedsim:")
        if "clients_per_sec" in fed:
            print(f"    clients_per_sec: {_fmt_dist(fed['clients_per_sec'])}")
        print(
            "    uplink_bytes_per_round: "
            f"{_fmt_dist(fed['uplink_bytes_per_round'], 'B')}"
        )
        print(
            "    clients_per_round: "
            f"{_fmt_dist(fed['clients_per_round'])}"
        )
        if "checksum_failures_total" in fed:
            print(
                f"    checksum_failures_total: {fed['checksum_failures_total']:.6g}"
            )
        if "fed_staleness_mean" in fed:
            print(f"    fed_staleness_mean: {fed['fed_staleness_mean']:.6g}")
        if "fed_staleness_max" in fed:
            print(f"    fed_staleness_max: {fed['fed_staleness_max']:.6g}")
        if "fed_staleness_p95" in fed:
            print(
                "    fed_staleness_tail: "
                f"p50 {fed['fed_staleness_p50']:.6g}  "
                f"p95 {fed['fed_staleness_p95']:.6g}  "
                f"p99 {fed['fed_staleness_p99']:.6g}  "
                "(exact, on-device histogram)"
            )
        if "fed_buffer_fill_per_apply" in fed:
            print(
                "    fed_buffer_fill_per_apply: "
                f"{fed['fed_buffer_fill_per_apply']:.6g}"
            )
        if "fed_pop_classes" in fed:
            print(f"    fed_pop_classes: {fed['fed_pop_classes']}")
            shares = ", ".join(f"{v:.6g}" for v in fed["fed_pop_shares"])
            print(
                f"    fed_pop_shares: [{shares}]  "
                "(exact, on-device histogram)"
            )
            print(
                "    fed_pop_residency_min: "
                f"{fed['fed_pop_residency_min']:.6g}"
            )
        if "fed_tenants" in fed:
            print(f"    fed_tenants: {fed['fed_tenants']}")
            for row in (
                "fed_mt_clients_per_sec",
                "fed_mt_staleness_mean",
                "fed_mt_staleness_max",
                "fed_mt_staleness_p50",
                "fed_mt_staleness_p95",
                "fed_mt_staleness_p99",
                "fed_mt_buffer_fill_per_apply",
            ):
                if row in fed:
                    vals = ", ".join(f"{v:.6g}" for v in fed[row])
                    print(f"    {row}: [{vals}]")
    if "ctrl" in rep:
        ctrl = rep["ctrl"]
        print("  ctrl (adaptive compression controller):")
        print(
            f"    decisions: {ctrl['decisions']}  switches: {ctrl['switches']}"
            f"  final: rung {ctrl['final_index']} (ratio {ctrl['final_ratio']})"
        )
        print(f"    ctrl_switches_per_step: {ctrl['ctrl_switches_per_step']:.6g}")
        if ctrl["effective_ratio"] is not None:
            print(f"    effective_ratio: {ctrl['effective_ratio']:.6g}")
        for line in ctrl["trail"]:
            print(f"    switch {line}")
    if "telemetry" in rep:
        print("  device accumulators:")
        for k, v in sorted(rep["telemetry"].items()):
            print(f"    {k}: {v:.6g}" if isinstance(v, float) else f"    {k}: {v}")
    elif rep.get("telemetry_off"):
        print(
            "  telemetry: was off for this run — no device accumulators or "
            "span trace (re-run with --telemetry to record them)"
        )
    return 0


# ---------------------------------------------------------------------- #
# compare
# ---------------------------------------------------------------------- #


def _bench_step_time(bench: Dict[str, Any], strategy: str) -> Optional[float]:
    strategies = bench.get("detail", {}).get("strategies", {})
    rec = strategies.get(strategy)
    if isinstance(rec, dict) and isinstance(rec.get("t_step_s"), (int, float)):
        return float(rec["t_step_s"])
    return None


def _wire_to_loss(hist: List[Dict[str, Any]], target: float):
    """(cumulative rel_volume, step) at the first record whose running-min
    loss reaches `target`, or None if the run never gets there. rel_volume
    is proportional to wire bytes when both runs share the model, so the
    cumulative sum compares total gradient traffic at matched loss."""
    best = float("inf")
    wire = 0.0
    for rec in hist:
        rv = rec.get("rel_volume")
        loss = rec.get("loss")
        if isinstance(rv, (int, float)):
            wire += float(rv)
        if isinstance(loss, (int, float)):
            best = min(best, float(loss))
            if best <= target:
                return wire, int(rec.get("step", 0))
    return None


def _compare_ctrl(run_a, rep_a, run_b, rep_b) -> int:
    """`compare A B --ctrl`: A is the adaptive run, B the fixed baseline.
    Matched-loss wire comparison — target is the WORSE of the two best
    (running-min) losses, so both runs provably reached it; exits 1 when
    the adaptive run spent at least as much wire getting there."""
    hist_a = _history(run_a)
    hist_b = _history(run_b)
    loss_a = _series(hist_a, "loss")
    loss_b = _series(hist_b, "loss")
    if not loss_a or not loss_b:
        return _fail("--ctrl compare needs loss series in both runs")
    target = max(min(loss_a), min(loss_b))
    at_a = _wire_to_loss(hist_a, target)
    at_b = _wire_to_loss(hist_b, target)
    if at_a is None or at_b is None:
        return _fail("--ctrl compare: a run never reached the matched loss")
    wire_a, step_a = at_a
    wire_b, step_b = at_b
    ctrl_a = rep_a.get("ctrl")
    print(f"adaptive: {rep_a['run']}   fixed: {rep_b['run']}")
    print(f"  matched loss target: {target:.6g}")
    print(f"  adaptive: reached at step {step_a}, cum rel_volume {wire_a:.6g}")
    print(f"  fixed:    reached at step {step_b}, cum rel_volume {wire_b:.6g}")
    if ctrl_a:
        er = ctrl_a.get("effective_ratio")
        if er is not None:
            print(f"  adaptive effective_ratio: {er:.6g} "
                  f"({ctrl_a['switches']} switches)")
    if wire_b > 0:
        print(f"  wire adaptive/fixed: {wire_a / wire_b:.3f}x")
    if wire_a >= wire_b:
        print("  REGRESSION: adaptive run spent >= wire of fixed at matched loss")
        return 1
    print("  ok: adaptive reached matched loss on less wire")
    return 0


def _profile_points(detail: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """Sweep points a machine profile can re-price. BENCH_CALIB records
    carry an explicit `detail.points` list; single-point hier records
    (BENCH_HIER_r12) carry the plan shape at the top of `detail`."""
    pts = detail.get("points")
    if isinstance(pts, list) and pts:
        return [p for p in pts if isinstance(p, dict)]
    if {"d", "ratio", "n_slices", "per_slice"} <= set(detail):
        return [detail]
    return None


def _point_pick(pt: Dict[str, Any], prof) -> Optional[tuple]:
    """Plan pick for one bench sweep point under a machine profile
    (prof=None selects with the static constants). Hier-shaped points
    (n_slices/per_slice) go through `select_hier_plan`; rs-shaped points
    (`workers`) through `select_rs_mode`. Returns
    (label, pick_key, modeled_step_s) or None when the point carries
    neither shape."""
    d = int(pt.get("d", 0))
    ratio = float(pt.get("ratio", 0.0))
    if not d:
        return None
    if "n_slices" in pt and "per_slice" in pt:
        n_slices, per_slice = int(pt["n_slices"]), int(pt["per_slice"])
        plan = costmodel.select_hier_plan(
            d, n_slices, per_slice, ratio, profile=prof
        )
        key = f"{plan['ici']}+{plan['dcn']}"
        label = f"d={d} ratio={ratio:g} {n_slices}x{per_slice}"
        return (label, key, float(plan["modeled_step_s"]))
    if "workers" in pt:
        W = int(pt["workers"])
        mode = costmodel.select_rs_mode(d, W, ratio, profile=prof)
        t = costmodel.rs_step_time(mode, d, W, ratio, profile=prof)
        return (f"d={d} ratio={ratio:g} W={W}", mode, float(t))
    return None


def _point_price(pt: Dict[str, Any], key: str, prof) -> Optional[float]:
    """Price a specific pick `key` for a sweep point under a profile —
    what the other side's choice would cost on this machine."""
    d = int(pt.get("d", 0))
    ratio = float(pt.get("ratio", 0.0))
    if "n_slices" in pt and "per_slice" in pt:
        plan = costmodel.select_hier_plan(
            d, int(pt["n_slices"]), int(pt["per_slice"]), ratio, profile=prof
        )
        t = plan["table"].get(key)
        return float(t) if t is not None else None
    if "workers" in pt:
        return float(
            costmodel.rs_step_time(key, d, int(pt["workers"]), ratio,
                                   profile=prof)
        )
    return None


def _compare_profile(args) -> int:
    """`compare --profile P --against BENCH.json`: re-price a committed
    bench claim under a fitted machine profile. For each hier-shaped sweep
    point the static `select_hier_plan` pick and the profile-driven pick
    are compared; when they disagree, the static pick is also priced under
    the fitted model to show what the constants would have cost on this
    machine. rs-shaped points (`workers` instead of slices) get the same
    treatment through `select_rs_mode`. Passing --profile TWICE compares
    profile-A picks against profile-B picks instead of static vs fitted.
    Informational: exits 0 — the exit-code-gated cross-profile sentinel
    is the `profiles` subcommand."""
    if len(args.profile) > 2:
        return _fail("compare takes at most two --profile flags")
    profs = []
    for path in args.profile:
        try:
            profs.append((path, costmodel.load_profile(path)))
        except (OSError, ValueError) as e:
            return _fail(f"cannot load profile {path!r}: {e}")
    if len(profs) == 2:
        (name_a, prof_a), (name_b, prof_b) = profs
    else:
        name_a, prof_a = "static", None
        name_b, prof_b = profs[0]
    bench = _load_json(pathlib.Path(args.against))
    if not bench:
        return _fail(f"cannot read bench record {args.against!r}")
    detail = bench.get("detail", {})
    points = _profile_points(detail if isinstance(detail, dict) else {})
    if points is None:
        return _fail(
            f"{args.against!r} has no profile-repriceable sweep points "
            "(need detail.points, or d/ratio/n_slices/per_slice in detail)"
        )
    print(f"re-pricing {args.against}: {name_a} vs {name_b}")
    for name, prof in profs:
        print(
            f"  {name}: bw_dcn {prof.bw_dcn:.4g} B/s  bw_ici "
            f"{prof.bw_ici:.4g} B/s  t_enc {prof.t_enc_s:.4g}s  t_dec "
            f"{prof.t_dec_s:.4g}s  {len(prof.routes)} route row(s)  "
            f"(fitted: {', '.join(prof.fitted) or 'none'})"
        )
    disagreements = 0
    for pt in points:
        got_a = _point_pick(pt, prof_a)
        got_b = _point_pick(pt, prof_b)
        if got_a is None or got_b is None:
            continue
        label, a_key, _ = got_a
        _, b_key, b_time = got_b
        if a_key == b_key:
            print(
                f"  {label}: {name_a} and {name_b} agree on {a_key} "
                f"({b_time:.6g}s under {name_b}'s model)"
            )
        else:
            disagreements += 1
            a_under_b = _point_price(pt, a_key, prof_b)
            priced = (
                f"({a_under_b:.6g}s under {name_b}'s model), "
                f"{name_b} picks {b_key} ({b_time:.6g}s, "
                f"{a_under_b / b_time:.2f}x better)"
                if a_under_b
                else f"{name_b} picks {b_key} ({b_time:.6g}s)"
            )
            print(f"  {label}: DISAGREE — {name_a} picks {a_key} {priced}")
    print(f"  {disagreements} pick disagreement(s) across {len(points)} point(s)")
    return 0


def cmd_compare(args) -> int:
    if args.profile:
        if not args.against:
            return _fail("--profile needs --against BENCH.json to re-price")
        return _compare_profile(args)
    if not args.run_a:
        return _fail("compare needs RUN_A (or --profile --against)")
    run_a = _resolve_run(args.run_a)
    if run_a is None:
        return _fail(f"no run directory under {args.run_a!r}")
    rep_a = _run_report(run_a, args.include_warmup)
    t_a = rep_a["step_time_s"].get("mean")

    if args.against:
        bench = _load_json(pathlib.Path(args.against))
        if not bench:
            return _fail(f"cannot read bench record {args.against!r}")
        strategy = str(rep_a["config"].get("decode_strategy", "loop"))
        t_bench = _bench_step_time(bench, strategy)
        if t_bench is None:
            return _fail(
                f"{args.against!r} has no detail.strategies[{strategy!r}]"
                ".t_step_s entry"
            )
        if t_a is None:
            return _fail(f"run {rep_a['run']} has no step-time samples")
        ratio = t_a / t_bench
        regressed = t_a > t_bench * (1.0 + args.tol)
        flag = "REGRESSION" if regressed else "ok"
        print(
            f"{rep_a['run']} [{strategy}]: step_time mean {t_a:.6g}s vs bench "
            f"{t_bench:.6g}s  ({ratio:.2f}x, tol {args.tol:.0%})  {flag}"
        )
        return 1 if regressed else 0

    if not args.run_b:
        return _fail("compare needs RUN_B or --against BENCH.json")
    run_b = _resolve_run(args.run_b)
    if run_b is None:
        return _fail(f"no run directory under {args.run_b!r}")
    rep_b = _run_report(run_b, args.include_warmup)
    t_b = rep_b["step_time_s"].get("mean")

    if args.ctrl:
        return _compare_ctrl(run_a, rep_a, run_b, rep_b)
    print(f"A: {rep_a['run']}   B: {rep_b['run']}")
    print(f"  step_time A: {_fmt_dist(rep_a['step_time_s'], 's')}")
    print(f"  step_time B: {_fmt_dist(rep_b['step_time_s'], 's')}")
    print(f"  rel_volume A: {_fmt_dist(rep_a['rel_volume'])}")
    print(f"  rel_volume B: {_fmt_dist(rep_b['rel_volume'])}")
    rv_a = rep_a["rel_volume"].get("mean")
    rv_b = rep_b["rel_volume"].get("mean")
    if rv_a and rv_b:
        print(f"  rel_volume B/A: {rv_b / rv_a:.3f}x")
    if t_a and t_b:
        print(f"  step_time  B/A: {t_b / t_a:.3f}x")
        if t_b > t_a * (1.0 + args.tol):
            print(f"  REGRESSION: B exceeds A by more than {args.tol:.0%}")
            return 1
    return 0


# ---------------------------------------------------------------------- #
# calibrate
# ---------------------------------------------------------------------- #


def cmd_calibrate(args) -> int:
    run = _resolve_run(args.run)
    if run is None:
        return _fail(f"no run directory under {args.run!r}")
    try:
        prof = costmodel.calibrate(run, include_warmup=args.include_warmup)
    except (ValueError, OSError) as e:
        return _fail(str(e))
    rec = prof.to_record()
    costmodel.validate_profile(rec)  # never emit an invalid profile
    src = prof.source
    T = float(src["measured_step_s"])
    P = float(src["predicted_step_s"])
    err = abs(P - T) / T if T > 0 else float("inf")
    if args.json:
        print(json.dumps(rec, indent=2))
    else:
        print(f"calibrate: run {run.name}  (W={src['workers']})")
        print(
            f"  steps: {src['steps_measured']} measured of "
            f"{src['steps_total']} ({src['warmup_dropped']} warmup dropped; "
            f"{src['step_time_source']})"
        )
        print(
            f"  measured step {T:.6g}s  predicted {P:.6g}s  "
            f"(error {err:.2%}, tol {args.tol:.0%})"
        )
        print(
            f"  components: encode {src['encode_s']:.6g}s  decode "
            f"{src['decode_s']:.6g}s  wire_dcn {src['wire_dcn_s']:.6g}s  "
            f"wire_ici {src['wire_ici_s']:.6g}s  compute "
            f"{src['compute_s']:.6g}s  other {src['other_s']:.6g}s"
        )
        print(
            f"  fitted: bw_dcn {prof.bw_dcn:.6g} B/s  bw_ici "
            f"{prof.bw_ici:.6g} B/s  t_enc {prof.t_enc_s:.6g}s  t_dec "
            f"{prof.t_dec_s:.6g}s  compute {prof.compute_time_s:.6g}s"
        )
        print(f"    measured: {', '.join(prof.fitted) or '(none)'}")
        print(f"    held at static constants: {', '.join(prof.fixed) or '(none)'}")
    if args.out:
        prof.save(args.out)
        print(f"wrote profile -> {args.out}")
    if err > args.tol:
        print(
            f"calibrate: REGRESSION: predicted step time misses measured by "
            f"{err:.2%} (> {args.tol:.0%}) — the fit does not explain this run",
            file=sys.stderr,
        )
        return 1
    missing = [p for p in (args.require_fitted or []) if p not in prof.fitted]
    if missing:
        print(
            f"calibrate: REGRESSION: required parameter(s) left at static "
            f"constants instead of fitted: {', '.join(missing)} "
            f"(fitted: {', '.join(prof.fitted) or 'none'}) — the run's "
            "telemetry carried no signal for them",
            file=sys.stderr,
        )
        return 1
    return 0


# ---------------------------------------------------------------------- #
# profiles (cross-profile drift sentinel)
# ---------------------------------------------------------------------- #

_PROFILE_PARAMS = (
    ("bw_dcn", "B/s"),
    ("bw_ici", "B/s"),
    ("t_enc_s", "s"),
    ("t_dec_s", "s"),
    ("compute_time_s", "s"),
)


def _rel_drift(values: List[float]) -> float:
    hi, lo = max(values), min(values)
    return (hi - lo) / hi if hi > 0 else 0.0


def cmd_profiles(args) -> int:
    """`profiles A.json B.json [...] --against BENCH.json`: the
    cross-profile drift sentinel. Reports (a) per-parameter drift between
    the saved profiles, (b) per-route row disagreement from their v2
    route tables, and (c) — the exit-code-gated part — which committed
    bench plan selections flip between the profiles: for every sweep
    point of every --against record, each profile's pick is computed and
    any point where two profiles disagree counts as a flip. Exits 1 when
    any pick flips; parameter/route drift alone is informational."""
    if len(args.profiles) < 2:
        return _fail("profiles needs at least two PROFILE.json paths")
    profs = []
    for path in args.profiles:
        try:
            profs.append((path, costmodel.load_profile(path)))
        except (OSError, ValueError) as e:
            return _fail(f"cannot load profile {path!r}: {e}")
    names = [name for name, _ in profs]
    print(f"profiles: comparing {len(profs)} profile(s)")
    for name, prof in profs:
        print(
            f"  {name}: sha256 {prof.content_hash()}  "
            f"{len(prof.routes)} route row(s)  "
            f"(fitted: {', '.join(prof.fitted) or 'none'})"
        )

    report: Dict[str, Any] = {"profiles": names, "params": {}, "routes": {},
                              "flips": []}
    print("  parameter drift:")
    for attr, unit in _PROFILE_PARAMS:
        vals = [float(getattr(prof, attr)) for _, prof in profs]
        drift = _rel_drift(vals)
        shown = "  ".join(f"{v:.6g}" for v in vals)
        print(f"    {attr:>15}: {shown} {unit}  (drift {drift:.2%})")
        report["params"][attr] = {"values": vals, "rel_drift": drift}

    labels = sorted({l for _, prof in profs for l in prof.routes})
    if labels:
        print("  route rows (t_enc_s/t_dec_s per route):")
    for label in labels:
        rows = [prof.routes.get(label) for _, prof in profs]
        cells, encs, decs = [], [], []
        for row in rows:
            if row is None:
                cells.append("(absent)")
            else:
                cells.append(f"{row['t_enc_s']:.4g}/{row['t_dec_s']:.4g}")
                encs.append(float(row["t_enc_s"]))
                decs.append(float(row["t_dec_s"]))
        missing = sum(1 for row in rows if row is None)
        drift = max(_rel_drift(encs), _rel_drift(decs)) if len(encs) > 1 else 0.0
        note = f"drift {drift:.2%}" if not missing else f"{missing} absent"
        print(f"    {label:>10}: {'  '.join(cells)}  ({note})")
        report["routes"][label] = {
            "rows": rows, "absent": missing, "rel_drift": drift,
        }

    flips = 0
    total_points = 0
    for bench_path in args.against or []:
        bench = _load_json(pathlib.Path(bench_path))
        if not bench:
            return _fail(f"cannot read bench record {bench_path!r}")
        detail = bench.get("detail", {})
        points = _profile_points(detail if isinstance(detail, dict) else {})
        if points is None:
            return _fail(
                f"{bench_path!r} has no profile-repriceable sweep points "
                "(need detail.points, or d/ratio/n_slices/per_slice in "
                "detail)"
            )
        for pt in points:
            picks = [_point_pick(pt, prof) for _, prof in profs]
            if any(p is None for p in picks):
                continue
            total_points += 1
            label = picks[0][0]
            keys = [p[1] for p in picks]
            if len(set(keys)) > 1:
                flips += 1
                shown = ", ".join(
                    f"{n} -> {k}" for n, k in zip(names, keys)
                )
                print(f"  FLIP {bench_path} {label}: {shown}")
                report["flips"].append(
                    {"bench": bench_path, "point": label,
                     "picks": dict(zip(names, keys))}
                )
            else:
                print(f"  ok   {bench_path} {label}: all pick {keys[0]}")
    if args.json:
        print(json.dumps(report, indent=2))
    print(
        f"profiles: {flips} plan flip(s) across {total_points} bench "
        f"point(s) from {len(args.against or [])} record(s)"
    )
    if flips:
        print(
            "profiles: REGRESSION: plan selections flip between profiles — "
            "the machines (or the fits) disagree enough to change decisions",
            file=sys.stderr,
        )
        return 1
    return 0


# ---------------------------------------------------------------------- #
# slo (health verdict, exit-gated)
# ---------------------------------------------------------------------- #


def cmd_slo(args) -> int:
    """`slo RUN --spec slo.json`: replay the run's metrics.jsonl tick
    stream through a fresh HealthMonitor and print the per-tenant verdict
    table. Exit 1 when any tenant ends in BREACH — the gate a CI job or a
    bench claim can hang a "healthy at N clients/s" statement on. The
    monitor consumes only recorded rows, so re-running the command on the
    same run dir is bitwise-repeatable."""
    run = _resolve_run(args.run)
    if run is None:
        return _fail(f"no run directory under {args.run!r}")
    from deepreduce_tpu_torch.slo import HealthMonitor, SLOSpec

    try:
        spec = SLOSpec.load(args.spec)
    except ValueError as e:
        return _fail(str(e))
    if spec.is_noop:
        print(f"slo: run {run.name}: spec {args.spec} sets no targets — "
              "nothing to monitor (degenerate spec, monitor is a no-op)")
        return 0
    hist = _history(run)
    rows = [
        r for r in hist
        if isinstance(r.get("clients"), (int, float))
        or isinstance(r.get("clients_t"), list)
    ]
    if not rows:
        return _fail(
            f"run {run.name} has no federated tick rows (clients / "
            "clients_t) for the SLO monitor"
        )
    monitor = HealthMonitor(spec)
    tenants = 1
    rates: Dict[int, List[float]] = {}
    prev_ts: Optional[float] = None
    try:
        for i, r in enumerate(rows):
            tick = (
                int(r["round"])
                if isinstance(r.get("round"), (int, float))
                else i
            )
            ts = r.get("ts")
            dt = None
            if (isinstance(ts, (int, float))
                    and isinstance(prev_ts, (int, float)) and ts > prev_ts):
                dt = ts - prev_ts
            if isinstance(ts, (int, float)):
                prev_ts = ts
            if isinstance(r.get("clients_t"), list):
                T = len(r["clients_t"])
                tenants = max(tenants, T)
                for t in range(T):

                    def pick(key):
                        v = r.get(key)
                        if isinstance(v, list) and t < len(v):
                            return v[t]
                        return None

                    rep = {
                        "clients": pick("clients_t"),
                        "checksum_failures": pick("checksum_failures_t"),
                        "buffer_fill": pick("buffer_fill_t"),
                        "w_rel_err": pick("w_rel_err_t"),
                    }
                    hl = r.get("staleness_hist_t")
                    if (isinstance(hl, list) and t < len(hl)
                            and isinstance(hl[t], list)):
                        rep["staleness_hist"] = hl[t]
                    if dt and rep["clients"] is not None:
                        rep["clients_per_sec"] = float(rep["clients"]) / dt
                        rates.setdefault(t, []).append(
                            rep["clients_per_sec"]
                        )
                    monitor.observe(tick, rep, tenant=t)
            else:
                rep = {
                    "clients": r.get("clients"),
                    "checksum_failures": r.get("checksum_failures"),
                    "buffer_fill": r.get("buffer_fill"),
                    "w_rel_err": r.get("w_rel_err"),
                }
                if isinstance(r.get("staleness_hist"), list):
                    rep["staleness_hist"] = r["staleness_hist"]
                if isinstance(r.get("pop_hist"), list):
                    rep["pop_hist"] = r["pop_hist"]
                if dt and isinstance(r.get("clients"), (int, float)):
                    rep["clients_per_sec"] = float(r["clients"]) / dt
                    rates.setdefault(0, []).append(rep["clients_per_sec"])
                monitor.observe(tick, rep)
    except ValueError as e:
        return _fail(f"run {run.name}: {e}")

    verdicts = [monitor.verdict(t) for t in range(tenants)]
    states = [v["state"] for v in verdicts]
    if args.json:
        print(json.dumps(
            {
                "run": run.name,
                "spec": spec.to_dict(),
                "ticks": len(rows),
                "events": monitor.events,
                "verdicts": verdicts,
            },
            indent=2,
        ))
        return 1 if "BREACH" in states else 0
    print(f"slo: run {run.name}  spec {args.spec}  "
          f"({len(rows)} tick(s), {tenants} tenant(s))")
    if monitor.events:
        print(f"  {len(monitor.events)} health transition(s):")
        for ev in monitor.events:
            detail = ""
            if ev["value"] is not None:
                detail = f"  {ev['value']:.6g} vs {ev['threshold']:.6g}"
            print(
                f"    tick {ev['tick']} tenant {ev['tenant']}: "
                f"{ev['from_state']} -> {ev['to_state']} "
                f"({ev['trigger']}){detail}"
            )
    else:
        print("  0 health transitions")
    for v in verdicts:
        t = v["tenant"]
        print(f"  tenant {t}: {v['state']}")
        if t in rates:
            print(f"    clients_per_sec: {_fmt_dist(_dist(rates[t]))}")
        for key, row in v["targets"].items():
            if row["value"] is None:
                shown = "(no data)"
            else:
                shown = f"{row['value']:.6g} vs {row['threshold']:.6g}"
            burn = ""
            if row["burn_fast"] is not None:
                burn = (f"  burn fast {row['burn_fast']:.3g}x / "
                        f"slow {row['burn_slow']:.3g}x")
            flag = "ok" if row["ok"] else "VIOLATED"
            print(f"    {key}: {shown}{burn}  {flag}")
    if "BREACH" in states:
        print("slo: BREACH — at least one tenant ends outside its SLO",
              file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------- #
# bench-history (longitudinal ledger view)
# ---------------------------------------------------------------------- #


def cmd_bench_history(args) -> int:
    """`bench-history [DIR]`: one provenance-stamped trend row per
    committed BENCH_*.json record, ordered by the round number parsed
    from the filename. Modern records carry metric/value/unit/platform
    (+ optional provenance lists and profile_sha256); the r01–r05 raw-log
    records and the TPU midround record render as `legacy` rows from
    their parsed/headline payloads. A record matching NONE of those
    shapes exits 2 — the ledger is an interface, not a junk drawer."""
    import re

    root = pathlib.Path(args.dir)
    paths = sorted(root.glob("BENCH_*.json"))
    if not paths:
        return _fail(f"no BENCH_*.json records under {root}")
    rows: List[Dict[str, Any]] = []
    for path in paths:
        try:
            rec = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            return _fail(f"{path.name}: unreadable bench record: {e}")
        m = re.search(r"_r(\d+)", path.stem)
        row: Dict[str, Any] = {
            "round": int(m.group(1)) if m else -1,
            "file": path.name,
        }
        detail = rec.get("detail")
        sha = rec.get("profile_sha256")
        if sha is None and isinstance(detail, dict):
            sha = detail.get("profile_sha256")
        if isinstance(rec.get("metric"), str):
            prov = rec.get("provenance")
            if isinstance(prov, dict):
                has_mod = bool(prov.get("modeled"))
                has_meas = bool(prov.get("measured"))
                stamp = (
                    "modeled+measured" if has_mod and has_meas
                    else "modeled" if has_mod
                    else "measured" if has_meas
                    else "unstamped"
                )
            else:
                stamp = "unstamped"
            row.update(
                metric=rec["metric"],
                value=rec.get("value"),
                unit=rec.get("unit", ""),
                platform=rec.get("platform", "?"),
                provenance=stamp,
            )
        elif {"cmd", "rc", "n"} <= set(rec):
            parsed = rec.get("parsed")
            parsed = parsed if isinstance(parsed, dict) else {}
            row.update(
                metric=parsed.get("metric", "(raw log)"),
                value=parsed.get("value"),
                unit=parsed.get("unit", ""),
                platform=rec.get("platform", "?"),
                provenance="legacy",
            )
        elif (isinstance(rec.get("headline"), dict)
              and isinstance(rec["headline"].get("metric"), str)):
            h = rec["headline"]
            row.update(
                metric=h["metric"],
                value=h.get("value"),
                unit=h.get("unit", ""),
                platform=rec.get("platform", "?"),
                provenance="legacy",
            )
        else:
            return _fail(
                f"{path.name}: schema-less bench record — carries neither "
                "a 'metric' headline, a raw-log (cmd/rc/n) shape, nor a "
                "'headline' block"
            )
        if sha:
            row["profile_sha256"] = sha
        rows.append(row)
    rows.sort(key=lambda r: (r["round"], r["file"]))
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    print(f"bench-history: {len(rows)} record(s) under {root}")
    for row in rows:
        val = (
            f" = {row['value']:.6g}{row['unit']}"
            if isinstance(row["value"], (int, float))
            else ""
        )
        sha = (
            f"  profile:{str(row['profile_sha256'])[:12]}"
            if "profile_sha256" in row
            else ""
        )
        print(
            f"  r{row['round']:02d}  {row['file']:<28} "
            f"{row['metric']}{val}  [{row['platform']}]  "
            f"{row['provenance']}{sha}"
        )
    return 0


# ---------------------------------------------------------------------- #
# trace
# ---------------------------------------------------------------------- #


def _x_intervals(events, *, name: str = "", prefix: str = ""):
    """Sorted (start, end) µs intervals of the complete ("X") span events
    matching an exact name or a name prefix."""
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        n = e.get("name", "")
        if name and n != name:
            continue
        if prefix and not n.startswith(prefix):
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if isinstance(ts, (int, float)) and isinstance(dur, (int, float)):
            out.append((float(ts), float(ts) + float(dur)))
    out.sort()
    return out


def _trace_overlap(run: pathlib.Path, events, threshold: float) -> int:
    """`trace RUN --overlap`: wall-clock overlap fraction between the
    forward+backward spans and the per-bucket exchange dispatch spans.

    Each `train/forward_backward` interval is one step; the
    `exchange/bucket/*` spans starting in [step_i, step_{i+1}) belong to
    step i, and the step's overlap fraction is the share of their total
    duration that falls INSIDE the forward_backward interval. Streaming
    runs (cfg.stream_exchange) dispatch every bucket from the backward
    pass, so the fraction is ~1; barrier/pipeline runs dispatch from
    `train/exchange` after backward completes, so it is 0 — which makes
    the threshold a CI gate that the overlap structurally happened.
    Exits 1 below `--overlap-threshold`, 2 when the run has no usable
    span structure (no trace, no forward_backward span, no bucket spans).

    Composed runs on the (dcn, ici) mesh (cfg.stream_exchange AND
    cfg.hier) nest two more spans inside each bucket dispatch:
    `exchange/ici` (the bucket's dense slice-mean psum, run in the
    pre_encode slot) and `exchange/dcn` (the compressed gather half).
    When those spans are present the report attributes each leg to its
    forward_backward step window separately and the gate takes the
    MINIMUM fraction across bucket/dcn/ici — a composed run only passes
    when BOTH legs actually dispatched from inside backprop, not just
    the bucket wrapper. Flat streaming runs have no leg spans and keep
    the historical single-fraction behavior.
    """
    fb = _x_intervals(events, name="train/forward_backward")
    buckets = _x_intervals(events, prefix="exchange/bucket/")
    legs = {
        "dcn": _x_intervals(events, name="exchange/dcn"),
        "ici": _x_intervals(events, name="exchange/ici"),
    }
    if not fb:
        return _fail(
            f"run {run.name} has no train/forward_backward spans "
            "(telemetry off, or trace.json missing)"
        )
    if not buckets:
        return _fail(
            f"run {run.name} has no exchange/bucket/* spans — overlap "
            "needs the bucketed exchange (cfg.bucket_bytes)"
        )
    per_step = []
    tot_dur = tot_in = 0.0
    for i, (s, e) in enumerate(fb):
        nxt = fb[i + 1][0] if i + 1 < len(fb) else float("inf")
        mine = [(bs, be) for bs, be in buckets if s <= bs < nxt]
        if not mine:
            continue
        dur = sum(be - bs for bs, be in mine)
        inside = sum(
            max(0.0, min(be, e) - max(bs, s)) for bs, be in mine
        )
        tot_dur += dur
        tot_in += inside
        per_step.append((i, len(mine), inside / dur if dur else 0.0))
    if not per_step:
        return _fail(
            f"run {run.name}: no exchange/bucket/* span falls in any "
            "forward_backward step window"
        )
    frac = tot_in / tot_dur if tot_dur else 0.0
    # hierarchical leg attribution: same step-windowed accounting per leg
    leg_fracs = {}
    for leg, spans_ in legs.items():
        if not spans_:
            continue
        l_dur = l_in = 0.0
        for i, (s, e) in enumerate(fb):
            nxt = fb[i + 1][0] if i + 1 < len(fb) else float("inf")
            mine = [(ls, le) for ls, le in spans_ if s <= ls < nxt]
            l_dur += sum(le - ls for ls, le in mine)
            l_in += sum(
                max(0.0, min(le, e) - max(ls, s)) for ls, le in mine
            )
        leg_fracs[leg] = l_in / l_dur if l_dur else 0.0
    gate = min([frac, *leg_fracs.values()])
    print(f"overlap: run {run.name}")
    print(
        f"  forward_backward spans: {len(fb)}   "
        f"exchange/bucket spans: {len(buckets)}"
    )
    for i, n, f in per_step:
        print(f"  step {i}: {n} bucket dispatches, overlap fraction {f:.3f}")
    if leg_fracs:
        print(
            "  composed legs: "
            + "   ".join(
                f"exchange/{leg}: {len(legs[leg])} spans, "
                f"fraction {f:.3f}"
                for leg, f in sorted(leg_fracs.items())
            )
        )
    flag = "ok" if gate >= threshold else "BELOW THRESHOLD"
    print(
        f"  overall: {tot_in:.1f}us of {tot_dur:.1f}us bucket-dispatch time "
        f"inside forward_backward  (fraction {frac:.3f}"
        + (
            f", gate min over legs {gate:.3f}" if leg_fracs else ""
        )
        + f", threshold {threshold:g})  {flag}"
    )
    return 0 if gate >= threshold else 1


def cmd_trace(args) -> int:
    run = _resolve_run(args.run)
    if run is None:
        return _fail(f"no run directory under {args.run!r}")
    trace = _load_json(run / "trace.json")
    events = list(trace.get("traceEvents", []))
    if args.overlap:
        return _trace_overlap(run, events, args.overlap_threshold)
    hist = _history(run)
    # per-step metrics become counter tracks next to the span rows; their
    # wall clock is rebased so step 0 aligns with the trace origin
    ts0 = next((r["ts"] for r in hist if "ts" in r), None)
    for rec in hist:
        if "ts" not in rec:
            continue
        for key, val in rec.items():
            if key in ("step", "ts") or not isinstance(val, (int, float)):
                continue
            events.append(
                {
                    "name": key,
                    "ph": "C",
                    "ts": round((rec["ts"] - ts0) * 1e6, 3),
                    "pid": 1,
                    "tid": 0,
                    "args": {key: float(val)},
                }
            )
    # per-tick staleness percentiles become counter tracks of their own:
    # the logged staleness_hist rows are lists (skipped by the scalar
    # counter loop above), so read the exact discrete quantiles off each
    # tick's histogram — the Perfetto view of the SLO plane's tail signal
    st_rows = [
        r for r in hist
        if "ts" in r and isinstance(r.get("staleness_hist"), list)
        and r["staleness_hist"]
    ]
    if st_rows and ts0 is not None:
        from deepreduce_tpu_torch.telemetry.device_metrics import hist_quantile

        for rec in st_rows:
            ts = round((rec["ts"] - ts0) * 1e6, 3)
            for q, name in ((0.50, "fed_staleness_p50"),
                            (0.95, "fed_staleness_p95"),
                            (0.99, "fed_staleness_p99")):
                events.append(
                    {"name": name, "ph": "C", "ts": ts, "pid": 1, "tid": 0,
                     "args": {name: float(
                         hist_quantile(rec["staleness_hist"], q)
                     )}}
                )
    # per-tick per-class participation shares become counter tracks too
    # (fed_pop_share_c{k}): the pop_hist rows are lists like the staleness
    # histograms, so derive each class's share per tick
    pop_rows = [
        r for r in hist
        if "ts" in r and isinstance(r.get("pop_hist"), list)
        and r["pop_hist"]
    ]
    if pop_rows and ts0 is not None:
        for rec in pop_rows:
            ts = round((rec["ts"] - ts0) * 1e6, 3)
            total = max(sum(float(v) for v in rec["pop_hist"]), 1.0)
            for k, v in enumerate(rec["pop_hist"]):
                name = f"fed_pop_share_c{k}"
                events.append(
                    {"name": name, "ph": "C", "ts": ts, "pid": 1, "tid": 0,
                     "args": {name: float(v) / total}}
                )
    # SLO health transitions (health.jsonl) become global instant markers,
    # anchored like ctrl decisions: the records carry no wall clock by
    # design, so map tick -> ts via the metrics.jsonl round column
    hpath = run / "health.jsonl"
    if hpath.exists() and ts0 is not None:
        round_ts = {
            int(r["round"]): r["ts"]
            for r in hist
            if isinstance(r.get("round"), (int, float)) and "ts" in r
        }
        max_known = max(round_ts) if round_ts else 0
        with open(hpath) as f:
            hrecs = [json.loads(ln) for ln in f if ln.strip()]
        for rec in hrecs:
            tick = int(rec.get("tick", 0))
            anchor = tick if tick in round_ts else min(tick, max_known)
            while anchor > 0 and anchor not in round_ts:
                anchor -= 1
            ts = round((round_ts.get(anchor, ts0) - ts0) * 1e6, 3)
            events.append(
                {
                    "name": (
                        f"slo {rec.get('from_state')}->"
                        f"{rec.get('to_state')} tenant "
                        f"{rec.get('tenant')} ({rec.get('trigger')})"
                    ),
                    "ph": "i", "s": "g", "ts": ts, "pid": 1, "tid": 0,
                    "args": {
                        "trigger": rec.get("trigger"),
                        "value": rec.get("value"),
                        "threshold": rec.get("threshold"),
                    },
                }
            )
    # adaptive-controller decisions ride along as their own counter tracks
    # (ladder index + active ratio) plus global instant markers at each
    # switch; decision steps are mapped to wall time via metrics.jsonl
    decs = _decisions(run)
    if decs and ts0 is not None:
        step_ts = {
            int(r["step"]): r["ts"]
            for r in hist
            if isinstance(r.get("step"), (int, float)) and "ts" in r
        }
        max_known = max(step_ts) if step_ts else 0
        for d in decs:
            step = int(d.get("step", 0))
            # decisions carry no wall clock by design (bitwise replay);
            # anchor at the nearest logged step at or before the decision
            anchor = step if step in step_ts else min(step, max_known)
            while anchor > 0 and anchor not in step_ts:
                anchor -= 1
            ts = round((step_ts.get(anchor, ts0) - ts0) * 1e6, 3)
            for name, val in (
                ("ctrl_ladder_index", d.get("new_index")),
                ("ctrl_ratio", d.get("new_ratio")),
            ):
                if isinstance(val, (int, float)):
                    events.append(
                        {"name": name, "ph": "C", "ts": ts, "pid": 1, "tid": 0,
                         "args": {name: float(val)}}
                    )
            if d.get("switched"):
                events.append(
                    {
                        "name": (
                            f"ctrl switch {d.get('old_index')}->"
                            f"{d.get('new_index')} ({d.get('rationale')})"
                        ),
                        "ph": "i", "s": "g", "ts": ts, "pid": 1, "tid": 0,
                        "args": {
                            "trigger": d.get("trigger"),
                            "old_ratio": d.get("old_ratio"),
                            "new_ratio": d.get("new_ratio"),
                        },
                    }
                )
    if not events:
        summ = _load_json(run / "summary.json")
        if _telemetry_off(run, summ):
            print(
                f"telemetry: run {run.name}: telemetry was off for this run — "
                "no span trace or metrics to export (re-run with --telemetry)"
            )
            return 0
        return _fail(f"run {run.name} has neither trace.json events nor metrics")
    if not trace.get("traceEvents"):
        print(
            f"telemetry: note: run {run.name} has no span trace "
            "(telemetry was off or trace.json missing); exporting metric "
            "counters only",
            file=sys.stderr,
        )
    events.sort(key=lambda e: e.get("ts", 0.0))
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    if args.out and args.out != "-":
        with open(args.out, "w") as f:
            json.dump(merged, f)
        print(f"wrote {len(events)} events -> {args.out}")
    else:
        json.dump(merged, sys.stdout)
        print()
    return 0


# ---------------------------------------------------------------------- #


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepreduce_tpu_torch.telemetry",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary", help="digest one run")
    p.add_argument("run", help="run dir or tracking root (latest run)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--include-warmup", action="store_true",
                   help="keep compile-dominated warmup step times in the "
                        "statistics (dropped by default)")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("compare", help="diff two runs, or a run vs a bench record")
    p.add_argument("run_a", nargs="?", default="")
    p.add_argument("run_b", nargs="?", default="")
    p.add_argument("--against", default="", metavar="BENCH.json",
                   help="committed bench record (e.g. BENCH_DECODE_r06.json); "
                        "matched on the run's decode_strategy")
    p.add_argument("--tol", type=float, default=0.10,
                   help="step-time regression tolerance (default 10%%)")
    p.add_argument("--ctrl", action="store_true",
                   help="adaptive-vs-fixed mode: RUN_A is the adaptive run, "
                        "RUN_B the fixed baseline; compares cumulative wire "
                        "volume at matched (running-min) loss and exits 1 "
                        "when adaptive spent >= wire")
    p.add_argument("--profile", action="append", default=[],
                   metavar="PROFILE.json",
                   help="fitted machine profile (telemetry calibrate --out); "
                        "with --against, re-prices the bench claim under the "
                        "profile and reports static-vs-calibrated pick "
                        "disagreements (no runs needed); pass twice to "
                        "compare two fitted profiles' picks instead")
    p.add_argument("--include-warmup", action="store_true",
                   help="keep compile-dominated warmup step times in the "
                        "statistics (dropped by default)")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser(
        "calibrate",
        help="fit a machine profile (bw/t_enc/t_dec/compute) from a run's "
             "telemetry",
    )
    p.add_argument("run", help="tracking run dir with --telemetry artifacts")
    p.add_argument("--out", default="", metavar="PROFILE.json",
                   help="write the fitted profile record here")
    p.add_argument("--json", action="store_true",
                   help="print the full profile record instead of the digest")
    p.add_argument("--include-warmup", action="store_true",
                   help="keep compile-dominated warmup steps in the fit "
                        "(skews the step-time target; default drops them)")
    p.add_argument("--tol", type=float, default=0.05,
                   help="max |predicted - measured| / measured step time "
                        "before exiting 1 (default 5%%)")
    p.add_argument("--require-fitted", action="append", default=[],
                   metavar="PARAM",
                   help="exit 1 unless this parameter (e.g. bw_ici) came "
                        "out of the fit rather than the static constants; "
                        "repeatable — the CI gate that a hierarchical run "
                        "actually identified its ICI leg")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser(
        "profiles",
        help="cross-profile drift sentinel: parameter/route drift between "
             "saved machine profiles and which committed bench plan "
             "selections flip between them (exit 1 on any flip)",
    )
    p.add_argument("profiles", nargs="+", metavar="PROFILE.json",
                   help="two or more saved machine profiles to compare")
    p.add_argument("--against", action="append", default=[],
                   metavar="BENCH.json",
                   help="committed bench record whose sweep points are "
                        "re-selected under every profile; repeatable — any "
                        "point whose pick differs between profiles exits 1")
    p.add_argument("--json", action="store_true",
                   help="also print the machine-readable drift report")
    p.set_defaults(fn=cmd_profiles)

    p = sub.add_parser(
        "slo",
        help="per-tenant SLO verdict table from a run's tick stream; "
             "exits 1 when any tenant ends in BREACH",
    )
    p.add_argument("run", help="run dir or tracking root (latest run)")
    p.add_argument("--spec", required=True, metavar="SLO.json",
                   help="schema-validated SLOSpec file (slo/spec.py)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable verdicts/events instead of the "
                        "table")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "bench-history",
        help="longitudinal view of the committed BENCH_*.json ledger: one "
             "provenance-stamped trend row per round (exit 2 on a "
             "schema-less record)",
    )
    p.add_argument("dir", nargs="?", default=".",
                   help="directory holding BENCH_*.json (default: .)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable rows")
    p.set_defaults(fn=cmd_bench_history)

    p = sub.add_parser("trace", help="merged Chrome trace JSON (Perfetto)")
    p.add_argument("run")
    p.add_argument("--out", default="-", help="output path ('-' = stdout)")
    p.add_argument("--overlap", action="store_true",
                   help="report the wall-clock overlap fraction between "
                        "train/forward_backward and exchange/bucket/* spans "
                        "instead of exporting the trace; exits 1 below "
                        "--overlap-threshold (the streaming-exchange CI gate)")
    p.add_argument("--overlap-threshold", type=float, default=0.5,
                   metavar="FRAC",
                   help="minimum acceptable overlap fraction for --overlap "
                        "(default 0.5; streaming runs sit at ~1, barrier "
                        "runs at 0)")
    p.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
