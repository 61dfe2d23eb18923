"""The composition lattice, replayed through the port, ported from
`deepreduce_tpu/analysis/lattice.py`.

The JAX package probes the full cross-product of its flagship feature axes
(communicator x decode x buckets x stream x rs_mode x hier x resilience x
ctrl x fed x fed_async x fed_mt x population: 73,728 cells) and commits the
outcome as MATRIX.json: each cell legal, or rejected at the config stage or
the exchanger build with a reason code; each legal cell's traced program
with its collective inventory and wire bytes. This module runs the same
cells, in the same order and with the same config kwargs (`cell_kwargs`),
through the port:

- the config stage: the port's `DeepReduceConfig(**kwargs)`;
- the build stage: the exchanger, streamed exchange or `FedSim` the cell's
  harness builds (`build_cell`);
- each distinct legal program (memoised on `trace_fingerprint`, the ctrl
  knobs stripped, so the port's labels are MATRIX.json's) runs one
  exchange, streamed step or round under the recorder and the census
  (`audit.run_flat`, `run_hier`, `run_stream`, `run_fed`).

`compare_matrix` holds the port's report to MATRIX.json, read as data:
every cell's legality, stage and reason code; every trace's collectives
by axis and wire bytes, with JAX's static counts turned into a run's
(`jax_run_inventory`: loop trips applied and the stated deviations,
`DEVIATIONS`). It does not hold `jaxpr_hash`, `peak_bytes` or
`collective_residency`: those are XLA's.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig, PORT_REASON_CODES, reason_code_of

SCHEMA = "deepreduce_tpu/analysis-report/v1"  # MATRIX.json's
PORT_SCHEMA = "deepreduce_tpu_torch/matrix-replay/v1"

# (axis, labels) in the JAX package's cell order
AXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("communicator", ("allgather", "allreduce", "qar", "sparse_rs")),
    ("decode", ("loop", "vmap", "ring")),
    ("buckets", ("off", "on")),
    ("stream", ("off", "on")),
    ("rs_mode", ("sparse", "adaptive", "quantized", "sketch", "oktopk", "auto")),
    ("hier", ("off", "dense", "qar_ici", "auto_dcn")),
    ("resilience", ("off", "on")),
    ("ctrl", ("off", "on")),
    ("fed", ("off", "on")),
    ("fed_async", ("off", "on")),
    ("fed_mt", ("off", "on")),
    ("population", ("off", "on")),
)

# host-side only (the jx-ctrl-ladder off-identity): stripped from the
# trace fingerprint, so cells differing in them share one trace
_CTRL_KWARGS = ("ctrl", "ctrl_ladder", "telemetry")

# the stated deviations: where a run of the port differs from JAX's traced
# program by design. id -> what differs and why
DEVIATIONS: Dict[str, str] = {
    "qar-packed": "qar sends each phase's int8 levels and float32 norms in one buffer: 1 all_to_all and 1 "
                  "all_gather a leg where JAX has 2 of each",
    "hier-ici-one-all-reduce": "the dense slice mean is one all_reduce of the flat gradient; JAX psums each "
                               "leaf (XLA's combiner may fuse them)",
    "per-tensor-one-gather": "fused=False gathers each tensor's payload bytes in one all_gather; JAX gathers "
                             "each payload leaf",
    "fed-mt-wire-scalars": "the multi-tenant tick's all_reduce carries every tenant's wire scalars; JAX vmaps "
                           "them unbatched, one copy: +4(T-1)s_static B",
    "fed-mt-per-tenant-encode": "the multi-tenant tick runs each tenant's local half in turn: 2 selections a "
                                "tenant where JAX's vmap stages 2",
    "chaos-host-events": "chaos events are host decisions keyed by (seed, step, worker): the injector's ops run "
                         "on the steps where one fires (the retrace check leaves them out)",
}

# loop trips: a traced loop's collective is one eqn; a run makes one call
# a trip
TRIPS: Dict[str, str] = {
    "ring-decode": "the ring decode's ppermute: one hop before a fori_loop of W - 2 trips with one hop each "
                   "(deepreduce_tpu/comm_ring.py): 2 static eqns, W - 1 hops a run",
}


def iter_cells():
    """Every cell as {axis: label}, in the product order of MATRIX.json."""
    names = [n for n, _ in AXES]
    for combo in itertools.product(*(vals for _, vals in AXES)):
        yield dict(zip(names, combo))


def n_cells() -> int:
    out = 1
    for _, vals in AXES:
        out *= len(vals)
    return out


def cell_kwargs(cell: Dict[str, str]) -> Dict[str, Any]:
    """Config kwargs of one cell: the JAX package's `cell_kwargs`, key for
    key and value for value (the trace labels hash them)."""
    from deepreduce_tpu_torch.analysis.audit import _BUCKET_BYTES, _CTRL_LADDER, _FLAGSHIP

    comm = cell["communicator"]
    if comm == "allgather":
        kw: Dict[str, Any] = dict(memory="residual", **_FLAGSHIP)
    elif comm in ("allreduce", "qar"):
        kw = dict(communicator=comm, compressor="none", memory="none", deepreduce=None)
    else:
        kw = dict(communicator="sparse_rs", compressor="topk", memory="none", deepreduce=None, compress_ratio=0.02)
    kw["decode_strategy"] = cell["decode"]
    if cell["decode"] == "vmap":
        kw["decode_batch"] = 4
    if cell["buckets"] == "on":
        kw["bucket_bytes"] = _BUCKET_BYTES
    if cell["stream"] == "on":
        kw["stream_exchange"] = True
    if cell["rs_mode"] != "sparse":
        kw["rs_mode"] = cell["rs_mode"]
    if cell["hier"] != "off":
        kw["hier"] = True
        if cell["hier"] == "qar_ici":
            kw["hier_ici"] = "qar"
        elif cell["hier"] == "auto_dcn":
            kw["hier_dcn"] = "auto"
    if cell["resilience"] == "on":
        if comm == "sparse_rs":
            kw.update(resilience=True)  # no fused layout: checksum and chaos are allgather knobs
        else:
            kw.update(resilience=True, payload_checksum=True, chaos_corrupt_rate=0.2)
    if cell["ctrl"] == "on":
        kw.update(ctrl=True, telemetry=True, ctrl_ladder=_CTRL_LADDER)
    if cell["fed"] == "on":
        kw.update(fed=True, fed_num_clients=64, fed_clients_per_round=16, fed_local_steps=2)
    if cell["fed_async"] == "on":
        kw.update(fed_async=True, fed_async_k=8, fed_async_alpha=0.5, fed_async_latency="0.6,0.3,0.1")
    if cell["fed_mt"] == "on":
        kw.update(fed_tenants=2)
    if cell["population"] == "on":
        kw.update(
            pop_spec='{"version": 1, "num_labels": 8, "classes": ['
            '{"name": "bulk", "weight": 3.0, "data_alpha": 0.5}, '
            '{"name": "skewed", "weight": 1.0, "data_alpha": 0.1, '
            '"data_bias": 4.0}]}'
        )
    return kw


def trace_fingerprint(kw: Dict[str, Any], harness: str) -> str:
    """The harness and every kwarg that can reach the program (ctrl knobs
    stripped), hashed as the JAX package hashes them."""
    eff = {k: v for k, v in sorted(kw.items()) if k not in _CTRL_KWARGS}
    blob = json.dumps({"harness": harness, "kw": eff}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def harness_name(cell: Dict[str, str]) -> str:
    if cell["fed"] == "on":
        return "fed"
    if cell["stream"] == "on":
        return "stream"
    if cell["hier"] != "off":
        return "hier"
    return "flat"


def wire_mode(cfg: DeepReduceConfig) -> Optional[str]:
    if cfg.communicator == "sparse_rs":
        return "collective"
    if cfg.communicator == "allgather" and cfg.fused:
        return "ring" if cfg.decode_strategy == "ring" else "allgather"
    return None


def cell_slug(cell: Dict[str, str]) -> str:
    return "/".join(f"{n}={cell[n]}" for n, _ in AXES)


# ---------------------------------------------------------------------- #
# the stages
# ---------------------------------------------------------------------- #


def probe_partition(cell: Dict[str, str]):
    """The config stage: ("legal", cfg, kw) or ("rejected", "config",
    exception name, reason code)."""
    kw = cell_kwargs(cell)
    try:
        cfg = DeepReduceConfig(**kw)
    except ValueError as e:
        return ("rejected", "config", type(e).__name__, reason_code_of(e))
    return ("legal", cfg, kw)


def _shapes(bucket_bytes: Optional[int]) -> Dict[str, Tuple[int, ...]]:
    """The gradient leaves a cell's harness exchanges."""
    from deepreduce_tpu_torch.analysis.audit import _BUCKET_LEAVES

    if bucket_bytes is not None:
        return {n: (s,) for n, s in _BUCKET_LEAVES.items()}
    return {"g": (4096,)}


def build_cell(cfg: DeepReduceConfig, harness: str) -> None:
    """The build stage: construct what the cell's harness runs, on worker 0
    of its in-process group (no collective runs). Raises the build's
    ConfigError or ValueError."""
    from deepreduce_tpu_torch.collectives import InProcessGrid, InProcessGroup
    from deepreduce_tpu_torch.comm import GradientExchanger
    from deepreduce_tpu_torch.comm_stream import StreamingExchange
    from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger

    if harness == "fed":
        from deepreduce_tpu_torch.fedsim.sim import FedSim, synthetic_linear_problem

        fed = cfg.fed_config()
        params0, data_fn, loss_fn = synthetic_linear_problem(512, 4, fed.local_steps, device="cpu")
        FedSim(loss_fn, cfg, fed, 0.1, data_fn, group=InProcessGroup(8).member(0), device="cpu")
        return
    shapes = _shapes(cfg.bucket_bytes)
    if cfg.hier:
        ici, dcn = InProcessGrid(2, 4).member(0)
        ex = HierarchicalExchanger(shapes, cfg, ici=ici, dcn=dcn, device="cpu")
    else:
        ex = GradientExchanger(shapes, cfg, device="cpu", group=InProcessGroup(8).member(0))
    if harness == "stream":
        StreamingExchange(ex)


def trace_cell(label: str, cfg: DeepReduceConfig, harness: str, device="cpu"):
    """One run of the cell's program under the recorder and the census
    (rank 0's census), held to the rules its JAX harness arms: the wire
    accounting (dcn-filtered under hier), the census rules, the streamed
    order."""
    from deepreduce_tpu_torch.analysis import audit
    from deepreduce_tpu_torch.analysis.rules import AuditContext

    leaves = audit._BUCKET_LEAVES if cfg.bucket_bytes is not None else None
    kw = dict(label=label, num_workers=audit.NUM_WORKERS)
    if harness == "fed":
        run = audit.run_fed(cfg, census_ranks=(0,), device=device)
        kw.update(wire_mode="collective", expected_wire_bytes=run.payload_bytes)
    elif harness == "stream":
        run = audit.run_stream(cfg, census_ranks=(0,), device=device)
        kw.update(wire_mode="allgather", expected_wire_bytes=run.payload_bytes,
                  expect_stream_buckets=audit._BUCKET_COUNT)
        if cfg.hier:
            kw.update(wire_axis="dcn", num_workers=2)
    elif harness == "hier":
        run = audit.run_hier(cfg, leaves=leaves, census_ranks=(0,), device=device)
        mode = wire_mode(cfg)
        kw.update(wire_mode=mode, expected_wire_bytes=run.payload_bytes if mode else None, wire_axis="dcn",
                  num_workers=2)
    else:
        masks = [[True] * audit.NUM_WORKERS] if cfg.resilience else None
        run = audit.run_flat(cfg, leaves=leaves, masks=masks, census_ranks=(0,), device=device)
        mode = wire_mode(cfg)
        kw.update(wire_mode=mode, expected_wire_bytes=run.payload_bytes if mode else None)
    return audit.check_trace(AuditContext(**kw), run)


_HARNESSES = ("flat", "hier", "stream", "fed")


def probe_cell(cell: Dict[str, str], memo: Dict[str, Any], stats: Optional[Dict[str, int]] = None,
               traces: bool = True, device="cpu"):
    """(entry, (label, record) or None) of one cell: the config stage, then
    for a config-legal cell the build stage and (with `traces`) one run,
    both memoised on the trace fingerprint."""
    part = probe_partition(cell)
    if part[0] == "rejected":
        _, stage, exc, code = part
        return {"status": "rejected", "stage": stage, "exception": exc, "reason_code": code}, None
    _, cfg, kw = part
    harness = harness_name(cell)
    fp = trace_fingerprint(kw, harness)
    label = f"lat:{fp[:12]}"
    if fp not in memo:
        try:
            build_cell(cfg, harness)
        except ConfigError as e:
            memo[fp] = ({"status": "rejected", "stage": "build", "exception": type(e).__name__,
                         "reason_code": e.reason_code}, None)
        except ValueError as e:
            memo[fp] = ({"status": "rejected", "stage": "build", "exception": type(e).__name__,
                         "reason_code": None}, None)
        else:
            memo[fp] = ({"status": "legal", "trace": label}, trace_cell(label, cfg, harness, device) if traces else None)
    elif stats is not None:
        stats["cache_hits"] = stats.get("cache_hits", 0) + 1
    entry, record = memo[fp]
    return entry, (None if record is None else (label, record))


def build_matrix(progress: Optional[Callable[[str], None]] = None, stats: Optional[Dict[str, int]] = None,
                 traces: bool = True, device="cpu") -> Dict[str, Any]:
    """Every cell through the port: `entries` the distinct outcomes,
    `cells` each cell's entry index (MATRIX.json's order), `traces` one
    record per distinct program run (empty without `traces`)."""
    memo: Dict[str, Any] = {}
    entries: List[Dict[str, Any]] = []
    entry_index: Dict[str, int] = {}
    cells: List[int] = []
    trace_meta: Dict[str, Dict[str, Any]] = {}
    violations: List[Dict[str, str]] = []
    done = 0
    for cell in iter_cells():
        entry, traced = probe_cell(cell, memo, stats, traces, device)
        key = json.dumps(entry, sort_keys=True)
        if key not in entry_index:
            entry_index[key] = len(entries)
            entries.append(entry)
        cells.append(entry_index[key])
        if entry["status"] == "rejected" and entry["reason_code"] is None:
            violations.append({"rule": "matrix-codeless-rejection", "where": cell_slug(cell),
                               "detail": "rejected without a machine-readable reason_code"})
        if traced is not None and traced[0] not in trace_meta:
            label, record = traced
            meta = record.to_dict()
            meta.pop("label", None)
            meta["violations"] = [v.to_dict() for v in record.violations]
            meta["config"] = {k: v for k, v in sorted(cell_kwargs(cell).items()) if k not in _CTRL_KWARGS}
            meta["harness"] = harness_name(cell)
            trace_meta[label] = meta
            violations.extend(meta["violations"])
        done += 1
        if progress is not None and done % 8192 == 0:
            progress(f"{done}/{n_cells()} cells probed, {len(trace_meta)} distinct traces")
    if stats is not None:
        stats["cells_probed"] = done
        stats["distinct_traces"] = len(trace_meta)
    n_legal = sum(1 for i in cells if entries[i]["status"] == "legal")
    return {
        "schema": PORT_SCHEMA,
        "axes": [[name, list(vals)] for name, vals in AXES],
        "entries": entries,
        "cells": cells,
        "traces": trace_meta,
        "violations": violations,
        "summary": {
            "cells": len(cells),
            "legal": n_legal,
            "rejected": len(cells) - n_legal,
            "distinct_traces": len(trace_meta),
            "reason_codes": sorted({e["reason_code"] for e in entries
                                    if e["status"] == "rejected" and e["reason_code"]}),
            "violations": len(violations),
        },
    }


def load_report(path: Path, *, expect_schema: str = SCHEMA) -> Dict[str, Any]:
    """A committed report (MATRIX.json, ANALYSIS.json), read as data, its
    schema checked."""
    try:
        report = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"cannot load report {path}: {e}") from e
    if report.get("schema") != expect_schema:
        raise ValueError(f"{path} carries schema {report.get('schema')!r}, expected {expect_schema!r}")
    return report


# ---------------------------------------------------------------------- #
# JAX's static inventory -> a run's
# ---------------------------------------------------------------------- #


def _tenant_scalars(kw: Dict[str, Any]) -> int:
    return 2 if (kw.get("payload_checksum") or kw.get("chaos_corrupt_rate")) else 4


def jax_run_inventory(meta: Dict[str, Any], *, W: int = 8, payload_leaves: Optional[int] = None):
    """(collectives by axis, payload bytes, [trip and deviation ids]) a run
    of the port makes for a MATRIX.json trace: JAX's static counts with the
    loop trips applied (`TRIPS`) and the stated deviations (`DEVIATIONS`).
    A deviation rewrites a count only where JAX's is the one its reason
    predicts: one psum a gradient leaf (the harness's leaves), one
    all_gather a payload leaf (`payload_leaves` over all tensors, as the
    port's codecs lay them out); any other count is left to differ."""
    kw, harness = meta["config"], meta["harness"]
    n_tensors = len(_shapes(kw.get("bucket_bytes")))
    by_axis = copy.deepcopy(meta.get("collectives_by_axis") or {})
    payload = meta.get("payload_bytes")
    applied: List[str] = []
    comm = kw.get("communicator", "allgather")
    hier = bool(kw.get("hier"))
    if comm == "allgather" and kw.get("fused", True) and kw.get("decode_strategy") == "ring":
        for per in by_axis.values():
            if per.get("ppermute") == 2:
                per["ppermute"] = W - 1
                applied.append("ring-decode")
    qar_axes = ([("dcn" if hier else "data")] if comm == "qar" else []) + (
        ["ici"] if hier and kw.get("hier_ici") == "qar" else [])
    for ax in qar_axes:
        per = by_axis.get(ax, {})
        if per.get("all_gather") == 2 and per.get("all_to_all") == 2:
            per["all_gather"] = per["all_to_all"] = 1
            applied.append("qar-packed")
    if hier and harness != "stream" and kw.get("hier_ici", "dense") == "dense":
        per = by_axis.get("ici", {})
        if n_tensors > 1 and per.get("psum") == n_tensors:
            per["psum"] = 1
            applied.append("hier-ici-one-all-reduce")
    if comm == "allgather" and not kw.get("fused", True):
        for per in by_axis.values():
            if payload_leaves and per.get("all_gather") == payload_leaves:
                per["all_gather"] = n_tensors
                applied.append("per-tensor-one-gather")
    T = int(kw.get("fed_tenants") or 0)
    if T > 1 and payload is not None:
        payload += 4 * (T - 1) * _tenant_scalars(kw)
        applied.append("fed-mt-wire-scalars")
    return by_axis, payload, applied


def compare_matrix(baseline: Dict[str, Any], fresh: Dict[str, Any], *, limit: int = 25,
                   traces: bool = True) -> Tuple[List[str], Dict[str, int]]:
    """(differences, {trip or deviation id: traces it applied to}) between
    MATRIX.json (`baseline`) and the port's replay (`fresh`): legality,
    stage and reason code of every cell; with `traces`, every legal trace's
    collectives by axis and payload bytes. A cell the port turns away with
    one of its own reason codes (`config.PORT_REASON_CODES`) is counted
    under `port-code:<code>`, not as a difference."""
    diffs: List[str] = []
    used: Dict[str, int] = {}
    if baseline.get("axes") != fresh.get("axes"):
        return ["axes differ: the lattice itself moved"], used
    if len(baseline["cells"]) != len(fresh["cells"]):
        return [f"cell count {len(baseline['cells'])} -> {len(fresh['cells'])}"], used

    def note(msg: str) -> None:
        if len(diffs) < limit:
            diffs.append(msg)
        elif len(diffs) == limit:
            diffs.append("... (more differences suppressed)")

    seen: set = set()
    for cell, i_old, i_new in zip(iter_cells(), baseline["cells"], fresh["cells"]):
        old, new = baseline["entries"][i_old], fresh["entries"][i_new]
        if new["status"] == "rejected" and new.get("reason_code") in PORT_REASON_CODES:
            key = f"port-code:{new['reason_code']}"
            used[key] = used.get(key, 0) + 1
            continue
        if old["status"] != new["status"]:
            note(f"{cell_slug(cell)}: {old['status']} in MATRIX.json, {new['status']} in the port "
                 f"({new.get('reason_code') or old.get('reason_code')})")
            continue
        if old["status"] == "rejected":
            if (old["stage"], old["reason_code"]) != (new["stage"], new["reason_code"]):
                note(f"{cell_slug(cell)}: {old['stage']}/{old['reason_code']} in MATRIX.json, "
                     f"{new['stage']}/{new['reason_code']} in the port")
            continue
        if old["trace"] != new["trace"]:
            note(f"{cell_slug(cell)}: trace {old['trace']} in MATRIX.json, {new['trace']} in the port")
            continue
        if not traces or old["trace"] in seen:
            continue
        seen.add(old["trace"])
        want_axes, want_pb, applied = jax_run_inventory(baseline["traces"][old["trace"]])
        got = fresh["traces"].get(new["trace"])
        if got is None:
            note(f"{old['trace']}: not run")
            continue
        for a in applied:
            used[a] = used.get(a, 0) + 1
        got_axes = got.get("collectives_by_axis") or {}
        if got_axes != want_axes:
            note(f"{old['trace']} ({got['harness']}): collectives {got_axes}, JAX's run {want_axes}")
        if want_pb is not None and got.get("payload_bytes") != want_pb:
            note(f"{old['trace']} ({got['harness']}): payload {got.get('payload_bytes')} B, JAX's {want_pb} B")
    return diffs, used


def compare_analysis(baseline: Dict[str, Any], records) -> Tuple[List[str], Dict[str, int]]:
    """(differences, {trip or deviation id: records}) between ANALYSIS.json's
    traces and the port's audit records of the same labels: collectives
    (by axis where JAX records them) and payload bytes, JAX's static counts
    turned into a run's as in `compare_matrix`."""
    jax = {t["label"]: t for t in baseline["jaxpr_audit"]["traces"]}
    diffs: List[str] = []
    used: Dict[str, int] = {}
    for r in records:
        t = jax.get(r.label)
        if t is None or r.config is None:
            continue
        meta = {"config": r.config, "harness": r.harness,
                "collectives_by_axis": t.get("collectives_by_axis") or {"data": t["collectives"]}
                if t["collectives"] else {}, "payload_bytes": t.get("payload_bytes")}
        want_axes, want_pb, applied = jax_run_inventory(meta, payload_leaves=r.extra.get("payload_leaves"))
        for a in applied:
            used[a] = used.get(a, 0) + 1
        got_axes = r.collectives_by_axis or {}
        if got_axes != want_axes:
            diffs.append(f"{r.label}: collectives {got_axes}, JAX's run {want_axes}")
        if want_pb is not None and r.payload_bytes != want_pb:
            diffs.append(f"{r.label}: payload {r.payload_bytes} B, JAX's {want_pb} B")
    return diffs, used
