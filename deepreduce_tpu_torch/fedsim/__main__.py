"""Fedsim CLI: small-cohort round smoke-check with churn, chaos and resume,
ported from `deepreduce_tpu/fedsim/__main__.py`.

    python -m deepreduce_tpu_torch.fedsim check --device cpu --track_dir RUN

`check` runs a short client-sharded federated run (W in-process workers of
a `collectives.InProcessGroup`, or one worker on the card) with `FaultPlan`
churn and wire corruption under payload checksums, and checks that

- params stay finite and the model converges toward the linear teacher,
- churned cohort slots were recorded (live count < cohort on fault rounds),
- corrupted uplinks were caught by the checksum instead of poisoning the
  server mean,
- a mid-run checkpoint restores bitwise: save after round R, keep running,
  then restore into a fresh driver and replay; the replayed state must
  equal the uninterrupted run's exactly,

with `--async` the buffered ingest tick (a mid-buffer checkpoint, staleness
observed, the on-device histogram exact), `--population` a two-class skewed
population with per-class latency rows, `--slo` the SLO health monitor
(its `health.jsonl` valid, the run ending healthy, the trail replayed
bitwise after the resume) and `--tenants T` the multi-tenant tick (a tenant
leaving and rejoining, its state frozen meanwhile, a mid-fill checkpoint
resumed bitwise, a restore under another tenant count refused). It writes
a `tracking.Run` directory (`config.json`, `metrics.jsonl` with one row a
round, `summary.json` with the round rates and the telemetry accumulators'
rows, which `python -m deepreduce_tpu_torch.telemetry summary` renders)
and, with `--slo`, `health.jsonl` there, and prints a JSON report; exit 0
iff every check holds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from deepreduce_tpu_torch import tracking


def _build_cfg(**overrides):
    from deepreduce_tpu_torch.config import DeepReduceConfig

    base = dict(
        deepreduce="index",
        index="bloom",
        bloom_blocked="mod",
        compress_ratio=0.25,
        fpr=0.01,
        memory="residual",
        min_compress_size=8,
        telemetry=True,
    )
    base.update(overrides)
    return DeepReduceConfig(**base)


POP_SPEC = (
    '{"version": 1, "num_labels": 4, "label_shift": 0.05, '
    '"classes": ['
    '{"name": "fast", "weight": 3.0, "data_alpha": 2.0, '
    '"latency": "0.6,0.3,0.1"}, '
    '{"name": "slow", "weight": 1.0, "data_alpha": 0.2, '
    '"data_bias": 4.0, "latency": "0.2,0.5,0.3", '
    '"local_steps_mult": 2.0}]}'
)


def check_overrides(args) -> dict:
    """The config knobs of `check`: churn, chaos under checksums, and the
    async, population and multi-tenant arms."""
    C = args.clients_per_round
    o = dict(
        fed=True,
        fed_num_clients=args.num_clients,
        fed_clients_per_round=C,
        fed_local_steps=2,
        resilience=True,
        fault_plan="3@1,5@2:4",
        drop_rate=0.05,
        payload_checksum=True,
        chaos_corrupt_rate=0.2,
    )
    if args.use_async or args.tenants >= 1:
        # K > 2 cohorts: the buffer fills across ticks (the mid-run
        # checkpoint lands mid-buffer); 3 latency levels: staleness nonzero
        o.update(fed_async=True, fed_async_k=int(2.2 * C), fed_async_alpha=0.5, fed_async_latency="0.5,0.3,0.2")
    if args.population:
        o.update(pop_spec=POP_SPEC)
    if args.tenants >= 1:
        T = args.tenants
        # a heterogeneous fleet: odd tenants run half cohorts, so their K
        # stays reachable (about 1.3 cohorts an apply against 2.2)
        o.update(
            fed_tenants=T,
            fed_mt_k=",".join(str(int((2.2 - 1.55 * (t % 2)) * C)) for t in range(T)),
            fed_mt_alpha=",".join("0" if t % 2 else "0.5" for t in range(T)),
            fed_mt_latency=";".join("0.5,0.3,0.2" if t % 2 == 0 else "0.6,0.4" for t in range(T)),
            fed_mt_cohort=",".join(str(C if t % 2 == 0 else max(C // 2, 1)) for t in range(T)),
        )
    return o


def _default_slo_spec(cfg):
    """The embedded churn+chaos smoke spec for `check --slo` without
    --slo_spec: targets the smoke MUST satisfy (it ends healthy), sized
    to the check's known geometry — chaos corrupts ~20% of uplinks
    against a 50% error budget, the 3-level latency draw keeps p95 under
    the distribution depth, and the buffer never holds more than a few
    cohorts between applies."""
    targets = {
        "min_clients_per_round": 1.0,
        "checksum_failure_budget": 0.5,
        "convergence_band": 2.0,
        "convergence_residency_min": 0.5,
    }
    if cfg.fed_async:
        from deepreduce_tpu_torch.fedsim.round import parse_latency

        depth = len(parse_latency(cfg.fed_async_latency))
        targets["staleness_p95_max"] = float(depth)
        targets["buffer_fill_max"] = float(4 * cfg.fed_async_k)
    return {
        "version": 1,
        "window_ticks": 4,
        "fast_window_ticks": 2,
        "slow_window_ticks": 6,
        "hysteresis_ticks": 2,
        "targets": targets,
    }


def _slo_monitor(args, cfg, run_dir):
    """(monitor, spec) for `check --slo`, logging to RUN/health.jsonl."""
    from deepreduce_tpu_torch.slo import HealthLog, HealthMonitor, SLOSpec

    spec = SLOSpec.load(args.slo_spec) if args.slo_spec else SLOSpec.from_dict(_default_slo_spec(cfg))
    return HealthMonitor(spec, log=HealthLog(f"{run_dir}/health.jsonl")), spec


def _slo_report(rec, w_rel_err):
    """The deterministic per-tick report the monitor consumes: only fields
    that are pure functions of (state, key), never wall-clock, so the
    resumed replay regenerates them bitwise."""
    rep = {
        "clients": rec.get("clients"),
        "checksum_failures": rec.get("checksum_failures"),
        "buffer_fill": rec.get("buffer_fill"),
        "w_rel_err": w_rel_err,
    }
    for key in ("staleness_hist", "pop_hist"):
        if isinstance(rec.get(key), list):
            rep[key] = rec[key]
    return rep


def _host(m) -> dict:
    """A round's metrics on the host: scalars as floats, vectors as lists
    (per tenant, rows of lists)."""
    return {k: v.tolist() if v.dim() else float(v) for k, v in m.items()}


def _sims(args, cfg, run_dir):
    """One `FedSim` per worker (in-process workers on the CPU, one worker on
    the card) and the linear problem."""
    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.fedsim.sim import FedSim, synthetic_linear_problem

    fed = cfg.fed_config()
    dim, batch = 32, 8
    params0, data_fn, loss_fn = synthetic_linear_problem(dim, batch, fed.local_steps, device=args.device)
    W = args.num_workers if args.device == "cpu" else 1
    group = InProcessGroup(W) if W > 1 else None

    def build():
        sims = [FedSim(loss_fn, cfg, fed, 0.1, data_fn, group=None if group is None else group.member(w),
                       client_chunk=2, device=args.device) for w in range(W)]
        return sims, [s.init(params0) for s in sims]

    return group, build, dim


def _steps(group, sims, states, key):
    """One round on every worker (in lockstep threads when there are
    several): [(state, metrics)] by worker."""
    if group is None:
        return [sims[0].step(states[0], key)]
    return group.run(lambda m, s: sims[m.rank].step(s, key), states)


def _equal(a, b) -> bool:
    import torch

    from deepreduce_tpu_torch.checkpoint import _split_state

    ta, ha = _split_state(a)
    tb, hb = _split_state(b)
    return ha == hb and ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)


def _run_check(args):
    import torch

    from deepreduce_tpu_torch import checkpoint
    from deepreduce_tpu_torch.fedsim.sim import teacher
    from deepreduce_tpu_torch.resilience import stream

    cfg = _build_cfg(**check_overrides(args))
    fed = cfg.fed_config()
    run = tracking.Run(args.track_dir, name="check", config={"fed": fed.__dict__, "codec": cfg.codec_params()},
                       tags=["fedsim", "check"])
    group, build, dim = _sims(args, cfg, run.dir)
    sims, states = build()
    w_true = teacher(dim, args.device)

    def w_rel(params):
        return float(torch.linalg.norm(params["w"] - w_true) / torch.linalg.norm(w_true))

    monitor = spec = None
    saved_slo = None
    events_at_save = 0
    if args.slo:
        monitor, spec = _slo_monitor(args, cfg, run.dir)
    rounds_hist = []
    ckpt = f"{run.dir}/ckpt"
    mid = args.rounds // 2
    save_at = saved_fill = saved_stale = None
    for r in range(args.rounds):
        out = _steps(group, sims, states, stream.key(args.seed, r))
        states = [s for s, _ in out]
        rec = _host(out[0][1])
        rec["w_rel_err"] = w_rel(states[0].params)
        rounds_hist.append(rec)
        run.log({"round": r, **rec})
        if monitor is not None:
            monitor.observe(r, _slo_report(rec, rec["w_rel_err"]))
        buf = states[0].buffer
        if buf is not None:
            # save at the first mid-run tick where the buffer is MID-FILL
            want = save_at is None and r + 1 >= mid and float(buf.count) > 0 and float(buf.stale_sum) > 0
        else:
            want = r + 1 == mid
        if want:
            save_at = r + 1
            if buf is not None:
                saved_fill, saved_stale = float(buf.count), float(buf.stale_sum)
            if monitor is not None:
                saved_slo = json.dumps(monitor.state_dict(), sort_keys=True)
                events_at_save = len(monitor.events)
                (run.dir / "slo_state.json").write_text(saved_slo)
            for w, s in enumerate(states):
                checkpoint.save(f"{ckpt}.{w}", s, config=cfg)
    if save_at is None:
        save_at = args.rounds

    # resume: restore into FRESH drivers and replay the remaining rounds
    sims2, templates = build()
    states2 = [checkpoint.restore(f"{ckpt}.{w}", t, config=cfg) for w, t in enumerate(templates)]
    monitor2 = None
    if monitor is not None and saved_slo is not None:
        from deepreduce_tpu_torch.slo import HealthMonitor

        monitor2 = HealthMonitor(spec)
        monitor2.load_state_dict(json.loads(saved_slo))
    for r in range(save_at, args.rounds):
        out = _steps(group, sims2, states2, stream.key(args.seed, r))
        states2 = [s for s, _ in out]
        if monitor2 is not None:
            monitor2.observe(r, _slo_report(_host(out[0][1]), w_rel(states2[0].params)))
    resumed_equal = all(_equal(a, b) for a, b in zip(states, states2))

    summary = sims[0].summary(states[0])
    run.finish(summary)
    w_err = w_rel(states[0].params)
    C = fed.clients_per_round
    checks = {
        "params_finite": all(bool(torch.isfinite(x).all()) for s in states for x in s.params.values()),
        "model_converging": w_err < 0.9,
        "churn_recorded": any(rec["clients"] < C for rec in rounds_hist),
        "checksum_failures_caught": sum(rec["checksum_failures"] for rec in rounds_hist) > 0.0,
        "uplink_accounted": all(rec["uplink_bytes"] > 0 for rec in rounds_hist),
        "resume_bitwise": resumed_equal,
    }
    if cfg.fed_async:
        checks.update({
            "staleness_observed": any(rec.get("staleness_mean", 0.0) > 0 for rec in rounds_hist),
            # the on-device histogram is EXACT: its mass is the accepted count
            "staleness_hist_exact": all(abs(sum(rec["staleness_hist"]) - rec["clients"]) < 1e-3
                                        for rec in rounds_hist),
            "buffer_applied": sum(rec.get("applied", 0.0) for rec in rounds_hist) >= 1.0,
            "checkpoint_mid_buffer": bool(saved_fill and saved_stale),
        })
    pop_total = []
    if args.population:
        K = len(rounds_hist[0]["pop_hist"])
        pop_total = [sum(rec["pop_hist"][k] for rec in rounds_hist) for k in range(K)]
        checks.update({
            "pop_hist_exact": all(abs(sum(rec["pop_hist"]) - rec["clients"]) < 1e-3 for rec in rounds_hist),
            "pop_all_classes_served": all(t > 0 for t in pop_total),
        })
    if args.slo:
        from deepreduce_tpu_torch.slo import HealthLog, validate_health_stream

        logged = HealthLog.read(f"{run.dir}/health.jsonl")
        try:
            validate_health_stream(logged)
            stream_valid = True
        except ValueError:
            stream_valid = False
        lines = lambda recs: [json.dumps(x, sort_keys=True) for x in recs]  # noqa: E731
        tail = lines(monitor.events[events_at_save:])
        tail2 = lines(monitor2.events[events_at_save:]) if monitor2 is not None else tail
        checks.update({
            "slo_end_healthy": monitor.healthy(),
            "slo_stream_valid": stream_valid and lines(logged) == lines(monitor.events),
            "slo_resume_bitwise": tail == tail2,
        })
    report = {
        "ok": all(checks.values()),
        "checks": checks,
        "rounds": args.rounds,
        "w_rel_err": w_err,
        "clients_per_sec": summary.get("clients_per_sec"),
        "run_dir": str(run.dir),
        "config": {"fed_num_clients": fed.num_clients, "fed_clients_per_round": C, "fault_plan": cfg.fault_plan,
                   "chaos_corrupt_rate": cfg.chaos_corrupt_rate},
    }
    if cfg.fed_async:
        from deepreduce_tpu_torch.slo import hist_quantile

        depth = max(len(rec["staleness_hist"]) for rec in rounds_hist)
        total = [sum(rec["staleness_hist"][d] for rec in rounds_hist) for d in range(depth)]
        report["async"] = {
            "staleness_hist_total": total,
            "staleness_p50": hist_quantile(total, 0.50),
            "staleness_p95": hist_quantile(total, 0.95),
            "staleness_p99": hist_quantile(total, 0.99),
            "applies": sum(rec["applied"] for rec in rounds_hist),
            "checkpoint_buffer_fill": saved_fill,
            "checkpoint_stale_sum": saved_stale,
        }
    if args.population:
        grand = max(sum(pop_total), 1.0)
        report["population"] = {"pop_hist_total": pop_total, "pop_shares": [t / grand for t in pop_total]}
    if args.slo:
        report["slo"] = {"state": monitor.state_of(0), "events": len(monitor.events),
                         "health_jsonl": f"{run.dir}/health.jsonl", "verdict": monitor.verdict(0)}
    return report


def _run_mt_check(args):
    """Multi-tenant smoke: T heterogeneous async populations through the one
    tick; a tenant leaves for two ticks and rejoins (its state frozen
    meanwhile), a mid-fill checkpoint with the tenants at different buffer
    levels resumes bitwise under the same mask schedule, and a restore
    under another tenant count fails fast."""
    import torch

    from deepreduce_tpu_torch import checkpoint
    from deepreduce_tpu_torch.fedsim.sim import teacher
    from deepreduce_tpu_torch.resilience import stream

    T = args.tenants
    overrides = check_overrides(args)
    cfg = _build_cfg(**overrides)
    fed = cfg.fed_config()
    C = fed.clients_per_round
    cohorts = [float(c) for c in overrides["fed_mt_cohort"].split(",")]
    run = tracking.Run(args.track_dir, name="mt-check",
                       config={"fed": fed.__dict__, "fed_tenants": T, "codec": cfg.codec_params()},
                       tags=["fedsim", "mt", "check"])
    group, build, dim = _sims(args, cfg, run.dir)
    sims, states = build()
    w_true = teacher(dim, args.device)
    monitor = None
    if args.slo:
        monitor, _ = _slo_monitor(args, cfg, run.dir)
    leave = set(range(args.rounds - 3, args.rounds - 1)) if T > 1 else set()

    def mask_for(r):
        return [not (t == T - 1 and r in leave) for t in range(T)]

    def w_errs(state):
        return [float(torch.linalg.norm(state.params["w"][t] - w_true) / torch.linalg.norm(w_true)) for t in range(T)]

    rounds_hist = []
    ckpt = f"{run.dir}/ckpt"
    mid = args.rounds // 2
    save_at = saved_fills = saved_stales = None
    frozen, frozen_ok = None, True
    for r in range(args.rounds):
        want = mask_for(r)
        if list(states[0].active) != want:
            if frozen is None and not all(want):
                frozen = {n: p[T - 1].clone() for n, p in states[0].params.items()}
            states = [sims[w].set_active(s, want) for w, s in enumerate(states)]
        out = _steps(group, sims, states, stream.key(args.seed, r))
        states = [s for s, _ in out]
        if frozen is not None and not all(states[0].active):
            frozen_ok = frozen_ok and all(torch.equal(states[0].params[n][T - 1], frozen[n]) for n in frozen)
        m = _host(out[0][1])
        rec = {f"{k}_t": v for k, v in m.items()}
        for k in ("clients", "uplink_bytes", "checksum_failures", "applied", "buffer_fill"):
            rec[k] = float(sum(m[k]))
        rec["staleness_mean"] = float(sum(m["staleness_mean"]) / T)
        rec["w_rel_err_t"] = w_errs(states[0])
        rounds_hist.append(rec)
        run.log({"round": r, **rec})
        if monitor is not None:
            for t in range(T):
                monitor.observe(r, {"clients": rec["clients_t"][t], "checksum_failures": rec["checksum_failures_t"][t],
                                    "buffer_fill": rec["buffer_fill_t"][t], "w_rel_err": rec["w_rel_err_t"][t],
                                    "staleness_hist": rec["staleness_hist_t"][t]}, tenant=t)
        if save_at is None and r + 1 >= mid:
            fills = states[0].buffer.count.tolist()
            stales = states[0].buffer.stale_sum.tolist()
            if min(fills) > 0 and min(stales) > 0 and len(set(fills)) > 1:
                save_at, saved_fills, saved_stales = r + 1, fills, stales
                for w, s in enumerate(states):
                    checkpoint.save(f"{ckpt}.{w}", s, config=cfg)
    if save_at is None:
        save_at = args.rounds

    sims2, templates = build()
    resumed_equal = t_mismatch_fast = False
    if save_at < args.rounds:
        states2 = [checkpoint.restore(f"{ckpt}.{w}", t, config=cfg) for w, t in enumerate(templates)]
        for r in range(save_at, args.rounds):
            want = mask_for(r)
            if list(states2[0].active) != want:
                states2 = [sims2[w].set_active(s, want) for w, s in enumerate(states2)]
            out = _steps(group, sims2, states2, stream.key(args.seed, r))
            states2 = [s for s, _ in out]
        resumed_equal = all(_equal(a, b) for a, b in zip(states, states2))
        bad = _build_cfg(**{**overrides, "fed_tenants": T + 1, "fed_mt_cohort": "", "fed_mt_k": "",
                            "fed_mt_alpha": "", "fed_mt_latency": ""})
        try:
            checkpoint.restore(f"{ckpt}.0", templates[0], config=bad)
        except ValueError as e:
            t_mismatch_fast = "tenant-geometry" in str(e)

    summary = sims[0].summary(states[0])
    run.finish(summary)
    errs = w_errs(states[0])
    checks = {
        "params_finite": all(bool(torch.isfinite(x).all()) for s in states for x in s.params.values()),
        "model_converging": max(errs) < 0.9,
        "cohorts_respected": all(rec["clients_t"][t] <= cohorts[t] for rec in rounds_hist for t in range(T)),
        "uplink_accounted": all(rec["uplink_bytes"] > 0 for rec in rounds_hist),
        "staleness_observed": any(rec["staleness_mean"] > 0 for rec in rounds_hist),
        "fleet_applied": sum(rec["applied"] for rec in rounds_hist) >= 1.0,
        "checkpoint_mid_fill_distinct": bool(saved_fills and min(saved_fills) > 0 and len(set(saved_fills)) > 1
                                             and saved_stales and min(saved_stales) > 0),
        "resume_bitwise": resumed_equal,
        "frozen_slot_bitwise": frozen_ok and frozen is not None,
        "t_mismatch_fails_fast": t_mismatch_fast,
    }
    if args.slo:
        from deepreduce_tpu_torch.slo import HealthLog, validate_health_stream

        try:
            validate_health_stream(HealthLog.read(f"{run.dir}/health.jsonl"))
            valid = True
        except ValueError:
            valid = False
        checks.update({"slo_end_healthy": monitor.healthy(), "slo_stream_valid": valid})
    report = {
        "ok": all(checks.values()),
        "checks": checks,
        "rounds": args.rounds,
        "tenants": T,
        "w_rel_err_per_tenant": errs,
        "clients_per_sec": summary.get("clients_per_sec"),
        "run_dir": str(run.dir),
        "config": {k: overrides[k] for k in ("fed_tenants", "fed_mt_k", "fed_mt_alpha", "fed_mt_latency",
                                             "fed_mt_cohort")},
    }
    if args.slo:
        report["slo"] = {"states": {str(t): s for t, s in monitor.final_states().items()},
                         "events": len(monitor.events), "health_jsonl": f"{run.dir}/health.jsonl",
                         "verdicts": {str(t): monitor.verdict(t) for t in range(T)}}
    return report


def cmd_check(args) -> int:
    report = _run_mt_check(args) if args.tenants >= 1 else _run_check(args)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepreduce_tpu_torch.fedsim")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("check", help="cohort round + churn + chaos + resume smoke-check")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the round runs: the card (one worker), or the CPU (--num_workers in-process workers)")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--num_clients", type=int, default=256)
    p.add_argument("--clients_per_round", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=4, help="in-process workers on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--track_dir", type=str, default="fedsim_check")
    p.add_argument("--async", dest="use_async", action="store_true",
                   help="asynchronous buffered mode: staleness-weighted ingest ticks, K-threshold applies, "
                        "mid-buffer bitwise resume")
    p.add_argument("--slo", action="store_true",
                   help="run the SLO health monitor over the tick stream: writes RUN/health.jsonl, resumes the "
                        "monitor's state bitwise, and the check must END healthy")
    p.add_argument("--slo_spec", type=str, default="", help="SLOSpec JSON path for --slo (default: the embedded spec)")
    p.add_argument("--population", action="store_true",
                   help="heterogeneous two-class population with per-class latency rows (implies --async)")
    p.add_argument("--tenants", type=int, default=0,
                   help="multi-tenant smoke: T heterogeneous async populations through the one tick")
    args = ap.parse_args(argv)
    if args.population:
        args.use_async = True
    return cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
