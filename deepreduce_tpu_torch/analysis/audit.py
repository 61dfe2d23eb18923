"""The run-time audit of the port's traces, ported from
`deepreduce_tpu/analysis/jaxpr_audit.py`.

Where the JAX package traces a program to a jaxpr on an abstract 8-way
mesh, the port runs it: W = 8 lockstep workers of a
`collectives.InProcessGroup` (threads; on the card their tensors lie on the
one card), each with its collectives wrapped in a `recorder.Recorder` and
its ops under a `census.Census`. A harness runs one exchange (`run_flat`,
`run_hier`), one streamed step (`run_stream`) or one federated round
(`run_fed`) per step it is given; `check_trace` holds what it recorded to
an `AuditContext`:

- the collective inventory by op, flat and by axis (`jx-collective-count`),
  and the operand bytes against `payload_bytes()` (`jx-wire-accounting`);
- the census: selections (`jx-codec-count`), host reads outside the host
  codecs (`jx-callback`), float64 outside its sites (`jx-f64`), float64
  on the wire or an aggregate in another dtype (`jx-dtype-flow`), gathers
  in the mod query (`jx-gather-in-mod-query`), each streamed bucket's
  encode -> all_gather -> decode order (`jx-token-dominance`);
- on the card, the host syncs the sync watch saw at package sites outside
  the host codecs (`jx-callback`, `census.SyncWatch`);
- over steps with other gradient values (and masks): the same census hash
  (`jx-retrace`, `jx-dynamic-shape`), the same collective sequence
  (`jx-collective-schedule`), and draws that are a function of (seed,
  step, label) (`jx-key-lineage`).

`audit_specs` lists every label of the JAX package's ANALYSIS.json that has
a port counterpart (`quick`: the tier-1 subset), `audit_all` runs them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.analysis import census as cen
from deepreduce_tpu_torch.analysis import recorder as rec
from deepreduce_tpu_torch.analysis.rules import (
    F64_SITES,
    HOST_SYNC_SITES,
    R_CALIB_RESELECT,
    R_CALLBACK,
    R_CODEC_COUNT,
    R_COLLECTIVE_COUNT,
    R_COLLECTIVE_SCHEDULE,
    R_CTRL_LADDER,
    R_DTYPE_FLOW,
    R_DYNAMIC_SHAPE,
    R_F64,
    R_GATHER_IN_MOD_QUERY,
    R_KEY_LINEAGE,
    R_RESILIENCE_OFF,
    R_RETRACE,
    R_TOKEN_DOMINANCE,
    R_WIRE_ACCOUNTING,
    AuditContext,
    Violation,
)
from deepreduce_tpu_torch.collectives import InProcessGrid, InProcessGroup
from deepreduce_tpu_torch.config import DeepReduceConfig

AXIS = "data"
NUM_WORKERS = 8  # the audit's width, the JAX audit mesh's
GRID = (2, 4)  # (dcn, ici): the hierarchical harness's slices and workers a slice
STEP = 3  # the step the traces run (the second and third runs: STEP + 1, STEP again)

# the JAX package's audited configurations (jaxpr_audit.py)
_CTRL_LADDER = "0.01,0.02,0.05"
_FLAGSHIP = dict(
    deepreduce="index",
    index="bloom",
    bloom_blocked="mod",
    compress_ratio=0.02,
    fpr=0.01,
    min_compress_size=100,
)
# one embedding-style leaf alone in its bucket and five small ones: at
# 4,800 B a bucket the partition is three buckets
_BUCKET_LEAVES = {"emb": 3000, "w1": 900, "w2": 700, "b1": 300, "b2": 150, "b3": 50}
_BUCKET_BYTES = 4800
_BUCKET_COUNT = 3

# host codecs whose host round trips are the design
CALLBACK_WHITELIST = ("bloom_native", "integer_native", "polyfit_host", "huffman", "gzip")


@dataclasses.dataclass
class TraceRecord:
    """One audited run: its violations and what it recorded (rank 0's
    first step)."""

    label: str
    violations: List[Violation]
    collectives: Dict[str, int]
    census_hash: str
    payload_bytes: Optional[int] = None
    collectives_by_axis: Optional[Dict[str, Dict[str, int]]] = None
    selections: int = 0
    ops: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the config and harness that ran (ANALYSIS.json's comparison reads them)
    config: Optional[Dict[str, Any]] = None
    harness: str = "flat"

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "label": self.label,
            "violations": [v.to_dict() for v in self.violations],
            "collectives": self.collectives,
            "census_hash": self.census_hash,
            "selections": self.selections,
            "ops": self.ops,
        }
        if self.payload_bytes is not None:
            out["payload_bytes"] = self.payload_bytes
        if self.collectives_by_axis:
            out["collectives_by_axis"] = self.collectives_by_axis
        out.update(self.extra)
        return out


# ---------------------------------------------------------------------- #
# the draws of a run
# ---------------------------------------------------------------------- #


class StreamLog:
    """Inside it, every call of the package's stream functions
    (`sparse.per_tensor_stream`, `codecs.bloom.selection_stream`) is
    recorded as (function, its arguments, the stream): every draw of a
    codec, a route or a random policy is keyed by one of them."""

    def __init__(self):
        self.draws: List[Tuple[str, tuple, Any]] = []
        self._saved: List[Tuple[Any, str, Any]] = []

    def __enter__(self):
        from deepreduce_tpu_torch import sparse
        from deepreduce_tpu_torch.codecs import bloom

        for owner, name in ((sparse, "per_tensor_stream"), (bloom, "selection_stream")):
            orig = getattr(owner, name)

            def logged(*args, _orig=orig, _name=name, **kw):
                out = _orig(*args, **kw)
                self.draws.append((_name, args + tuple(sorted(kw.items())), out))
                return out

            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith("deepreduce_tpu_torch") and getattr(mod, name, None) is orig:
                    self._saved.append((mod, name, orig))
                    setattr(mod, name, logged)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        self._saved = []


def _by_step_worker(draws) -> Dict[Tuple[int, int], Dict[tuple, Any]]:
    """{(step, worker): {label: stream}} of the per-tensor streams and
    {(step, -1): ...} of the step-keyed selection streams."""
    out: Dict[Tuple[int, int], Dict[tuple, Any]] = {}
    for fn, args, stream in draws:
        if fn == "per_tensor_stream":
            seed, name, step, worker = args[:4]
            out.setdefault((int(step), int(worker)), {}).setdefault((fn, seed, name), set()).add(stream)
        else:
            seed, step = args[:2]
            out.setdefault((int(step), -1), {}).setdefault((fn, seed), set()).add(stream)
    return out


def key_lineage_violations(label: str, draws, steps) -> List[Violation]:
    """`jx-key-lineage` over a run of `steps`: within a (step, worker) each
    label has one stream and no two labels share one; a step run twice
    draws the same streams; the next step draws none of the step's."""
    got = _by_step_worker(draws)
    bad: List[str] = []
    for (step, worker), labels in sorted(got.items(), key=str):
        seen: Dict[Any, tuple] = {}
        for lab, streams in labels.items():
            if len(streams) > 1 and steps.count(step) < 2:
                bad.append(f"{lab} drew {len(streams)} streams at step {step}")
            for s in streams:
                if s in seen and seen[s] != lab:
                    bad.append(f"{seen[s]} and {lab} share the stream {s} at step {step} (worker {worker})")
                seen.setdefault(s, lab)
        if steps.count(step) > 1:
            for lab, streams in labels.items():
                if len(streams) != 1:
                    bad.append(f"{lab}: the replayed step {step} drew another stream")
    for (step, worker), labels in got.items():
        nxt = got.get((step + 1, worker), {})
        for lab, streams in labels.items():
            if lab in nxt and streams & nxt[lab]:
                bad.append(f"{lab} drew the same stream at steps {step} and {step + 1}")
    if not bad:
        return []
    return [Violation(R_KEY_LINEAGE, label, f"{len(bad)} draw fault(s) (first: {bad[0]})")]


# ---------------------------------------------------------------------- #
# harnesses
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class Run:
    """What a harness recorded: `tapes[i][r]` is worker r's tape of step i
    (None where no census ran there), `outputs[i][r]` its result,
    `payload_bytes` the exchange's, `draws` the stream log, `syncs` the
    package sites of the host syncs on the card (`census.SyncWatch`; None
    off the card)."""

    steps: Tuple[int, ...]
    tapes: List[List[rec.Tape]]
    outputs: List[List[Any]]
    payload_bytes: Optional[int]
    width: int
    draws: list
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    syncs: Optional[List[Tuple[str, str, int]]] = None


def _values(shape, seed: int, device) -> torch.Tensor:
    """The harness's gradient values, drawn on the host: `seed` folds the
    step, the worker (or the slice) and the leaf."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _shapes(d: int, leaves: Optional[Dict[str, int]]) -> Dict[str, Tuple[int, ...]]:
    return {"g": (d,)} if leaves is None else {n: (int(s),) for n, s in leaves.items()}


def _steps_of(work, n_workers: int, steps, run_group, census_ranks, device, mode_of=None) -> Run:
    """Run `work(member, r, i, step, tape, mode, state)` for each step on
    every worker, each step under a fresh tape and a census on
    `census_ranks` (all when None), or the mode `mode_of(r)` where given,
    the whole run under a `census.SyncWatch`. Worker 0's `state["extra"]`
    becomes the run's `extra`."""
    census_ranks = range(n_workers) if census_ranks is None else census_ranks
    tapes = [[rec.Tape() for _ in range(n_workers)] for _ in steps]
    outputs: List[List[Any]] = [[None] * n_workers for _ in steps]
    with StreamLog() as log:
        def body(member, r):
            state = {}
            for i, step in enumerate(steps):
                tape = tapes[i][r]
                if mode_of is not None:
                    mode = mode_of(r)
                else:
                    mode = cen.Census(tape) if r in census_ranks else contextlib.nullcontext()
                outputs[i][r] = work(member, r, i, step, tape, mode, state)
            return state.get("payload_bytes"), state.get("extra", {})

        with cen.SyncWatch(device) as syncs:
            (pb, extra), *_ = run_group(body, list(range(n_workers)))
    return Run(tuple(steps), tapes, outputs, pb, n_workers, log.draws, extra, syncs.sites)


def run_flat(
    cfg: DeepReduceConfig,
    *,
    d: int = 4096,
    leaves: Optional[Dict[str, int]] = None,
    steps=(STEP,),
    W: int = NUM_WORKERS,
    masks: Optional[List[Optional[List[bool]]]] = None,
    profile=None,
    device="cpu",
    census_ranks=None,
    mode_of=None,
) -> Run:
    """One `GradientExchanger.exchange` a step on W in-process workers.
    `masks[i]` is step i's participation mask (None: no mask). The run's
    `extra["payload_leaves"]` counts the payload leaves of all tensors."""
    from deepreduce_tpu_torch.comm import GradientExchanger

    shapes = _shapes(d, leaves)

    def work(member, r, i, step, tape, mode, state):
        if "ex" not in state:
            state["ex"] = GradientExchanger(shapes, cfg, device=device, group=rec.Recorder(member, AXIS, tape),
                                            profile=profile)
            state["res"] = ({n: torch.zeros(s, device=device) for n, s in shapes.items()}
                            if cfg.memory == "residual" else None)
            state["payload_bytes"] = int(state["ex"].payload_bytes())
            state["extra"] = {"payload_leaves": sum(len(lay.specs) for lay in state["ex"].layouts.values())}
            if state["ex"].chaos is not None:
                _mark_chaos(state["ex"], state)
        ex = state["ex"]
        ex.coll.tape = state["tape"] = tape
        grads = {n: _values(s, step * 131 + r * 17 + k, device) for k, (n, s) in enumerate(sorted(shapes.items()))}
        mask = None if masks is None or masks[i] is None else torch.tensor(masks[i], device=device)
        with mode:
            agg, state["res"], _ = ex.exchange(grads, state["res"], step=step, mask=mask)
        return {n: (g.dtype, a.dtype) for n, (g, a) in ((n, (grads[n], agg[n])) for n in grads)}

    return _steps_of(work, W, steps, lambda f, a: InProcessGroup(W).run(f, a), census_ranks, device, mode_of)


def _mark_chaos(ex, state) -> None:
    """Bracket the chaos injector's work on the worker's tape ('chaos<',
    'chaos>'): its events are host decisions keyed by (seed, step, worker),
    so the ops between the marks differ from step to step by design."""
    perturb = ex.perturb

    def marked(buf, **kw):
        state["tape"].mark("chaos<")
        try:
            return perturb(buf, **kw)
        finally:
            state["tape"].mark("chaos>")

    ex.perturb = marked


def steady_ops(tape: rec.Tape) -> List[cen.Op]:
    """The tape's ops outside the chaos injector's brackets."""
    out, inside = [], False
    for kind, item in tape.events:
        if kind == "mark" and item in ("chaos<", "chaos>"):
            inside = item == "chaos<"
        elif kind == "op" and not inside:
            out.append(item)
    return out


def run_hier(
    cfg: DeepReduceConfig,
    *,
    leaves: Optional[Dict[str, int]] = None,
    steps=(STEP,),
    device="cpu",
    census_ranks=None,
    mode_of=None,
) -> Run:
    """One `HierarchicalExchanger.exchange` a step on the in-process
    (dcn, ici) = GRID grid, d = 4,096 or `leaves`; the ici and dcn members
    are recorded under their axis names on one tape."""
    from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger

    shapes = _shapes(4096, leaves)
    n_slices, per_slice = GRID
    W = n_slices * per_slice

    def work(member, r, i, step, tape, mode, state):
        ici, dcn = member
        if "ex" not in state:
            state["ici"], state["dcn"] = rec.Recorder(ici, "ici", tape), rec.Recorder(dcn, "dcn", tape)
            state["ex"] = HierarchicalExchanger(shapes, cfg, ici=state["ici"], dcn=state["dcn"], device=device)
            state["res"] = ({n: torch.zeros(s, device=device) for n, s in shapes.items()}
                            if cfg.memory == "residual" else None)
            state["payload_bytes"] = int(state["ex"].payload_bytes())
        state["ici"].tape = state["dcn"].tape = tape
        # the replicas of a slice see one gradient, as data-parallel
        # replicas of one shard would after the slice mean
        grads = {n: _values(s, step * 131 + (r // per_slice) * 17 + k, device)
                 for k, (n, s) in enumerate(sorted(shapes.items()))}
        with mode:
            agg, state["res"], _ = state["ex"].exchange(grads, state["res"], step=step)
        return {n: (grads[n].dtype, agg[n].dtype) for n in grads}

    return _steps_of(work, W, steps, lambda f, a: InProcessGrid(*GRID).run(f, a), census_ranks, device, mode_of)


class _Leaves(torch.nn.Module):
    """One parameter per leaf; loss(batch) = sum(p * batch[n]): each leaf's
    gradient is its batch row, as in the JAX package's streaming audit."""

    def __init__(self, shapes, device):
        super().__init__()
        self.p = torch.nn.ParameterDict({n: torch.nn.Parameter(torch.zeros(s, device=device))
                                         for n, s in shapes.items()})

    def loss(self, batch):
        return sum(torch.sum(p * batch[n]) for n, p in self.p.items())


def run_stream(
    cfg: DeepReduceConfig,
    *,
    leaves: Optional[Dict[str, int]] = None,
    steps=(STEP,),
    device="cpu",
    census_ranks=None,
    mode_of=None,
) -> Run:
    """One streamed forward, backward and exchange a step
    (`StreamingExchange.value_and_grad_exchange`) over the bucket census,
    flat at W = 8 or over the (2, 4) grid with `cfg.hier`. Each bucket's
    dispatch and decode are marked on the worker's tape ('enc b', 'dec b')
    and the dispatcher thread runs under a fork of the worker's census."""
    from deepreduce_tpu_torch.comm import GradientExchanger
    from deepreduce_tpu_torch.comm_stream import StreamingExchange
    from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger

    shapes = _shapes(0, leaves or _BUCKET_LEAVES)
    hier = bool(cfg.hier)
    n_slices, per_slice = GRID
    W = n_slices * per_slice if hier else NUM_WORKERS

    def work(member, r, i, step, tape, mode, state):
        if "stream" not in state:
            if hier:
                ici, dcn = member
                state["colls"] = [rec.Recorder(ici, "ici", tape), rec.Recorder(dcn, "dcn", tape)]
                ex = HierarchicalExchanger(shapes, cfg, ici=state["colls"][0], dcn=state["colls"][1], device=device)
            else:
                state["colls"] = [rec.Recorder(member, AXIS, tape)]
                ex = GradientExchanger(shapes, cfg, device=device, group=state["colls"][0])
            state["stream"] = StreamingExchange(ex)
            state["model"] = _Leaves(shapes, device)
            state["res"] = {n: torch.zeros(s, device=device) for n, s in shapes.items()}
            state["payload_bytes"] = int(ex.payload_bytes())
            _mark_buckets(state["stream"].bucketed, state)
        for c in state["colls"]:
            c.tape = tape
        state["tape"], state["mode"] = tape, mode
        row = (r // per_slice) if hier else r
        batch = {n: _values(s, step * 131 + row * 17 + k, device)
                 for k, (n, s) in enumerate(sorted(shapes.items()))}
        named = dict(state["model"].p.items())
        with mode:
            _, grads, agg, state["res"], _ = state["stream"].value_and_grad_exchange(
                state["model"].loss, named, batch, state["res"], step=step)
        return {n: (grads[n].dtype, agg[n].dtype) for n in grads}

    def group_run(f, a):
        return InProcessGrid(*GRID).run(f, a) if hier else InProcessGroup(W).run(f, a)

    return _steps_of(work, W, steps, group_run, census_ranks, device, mode_of)


def _mark_buckets(bucketed, state) -> None:
    """Mark each bucket's dispatch ('enc b') and decode ('dec b') on the
    worker's current tape; the dispatch, on the dispatcher thread, runs
    under a fork of the worker's mode (its census)."""
    dispatch, decode_sum = bucketed.run_streaming_bucket, bucketed.fused.decode_sum
    label_of = {s.label: b for b, s in enumerate(bucketed.specs)}

    def marked_dispatch(b, *args, **kw):
        state["tape"].mark(f"enc {b}")
        mode = state["mode"]
        with mode.fork() if hasattr(mode, "fork") else contextlib.nullcontext():
            return dispatch(b, *args, **kw)

    def marked_decode(unit, *args, **kw):
        state["tape"].mark(f"dec {label_of[unit]}")
        return decode_sum(unit, *args, **kw)

    bucketed.run_streaming_bucket = marked_dispatch
    bucketed.fused.decode_sum = marked_decode


def fed_payload_law(cfg: DeepReduceConfig, n: int, D: int, K: int, T: int, per_class_latency: bool) -> int:
    """The operand bytes of the round's one all_reduce: sync 4(n + 6 + K),
    async 4(n + 7 + D + K) (+4D with per-class latency rows), the JAX
    package's laws (`jaxpr_audit.audit_fedsim_*`). T tenants send T
    single-tenant members, 4T(n + s_batched + s_static): JAX's vmap sends
    the s_static tenant-invariant wire scalars once
    (`lattice.DEVIATIONS['fed-mt-wire-scalars']`)."""
    if T >= 1:
        data_dep = bool(cfg.payload_checksum or cfg.chaos_corrupt_rate)
        s_batched = (3 + D if cfg.fed_async else 2) + (2 if data_dep else 0)
        return 4 * T * (n + s_batched + (2 if data_dep else 4))
    if not cfg.fed_async:
        return 4 * (n + 6 + K)
    return 4 * (n + 7 + D + K + (D if per_class_latency else 0))


def run_fed(
    cfg: DeepReduceConfig,
    *,
    steps=(STEP,),
    device="cpu",
    census_ranks=None,
    mode_of=None,
) -> Run:
    """One `FedSim.step` (a round, or an async or multi-tenant tick) a step
    on W = 8 in-process workers over the linear problem (d = 512, batches
    of 4): the JAX package's fed harness."""
    from deepreduce_tpu_torch.fedsim.sim import FedSim, synthetic_linear_problem

    fed = cfg.fed_config()

    def work(member, r, i, step, tape, mode, state):
        if "fs" not in state:
            params0, data_fn, loss_fn = synthetic_linear_problem(512, 4, fed.local_steps, device=device)
            state["coll"] = rec.Recorder(member, AXIS, tape)
            fs = FedSim(loss_fn, cfg, fed, 0.1, data_fn, group=state["coll"], device=device)
            state["fs"], state["st"] = fs, fs.init(params0)
            n = sum(p.numel() for p in params0.values())
            T = fs.tenants
            D = len(fs.mt_latency[0]) if T >= 1 and cfg.fed_async else len(fs.latency_probs)
            K = fs.pop.num_classes if fs.pop is not None else 0
            state["payload_bytes"] = fed_payload_law(cfg, n, D, K, T, fs.pop_latency_rows is not None)
        state["coll"].tape = tape
        with mode:
            state["st"], metrics = state["fs"].step(state["st"], step)
        return None

    return _steps_of(work, NUM_WORKERS, steps, lambda f, a: InProcessGroup(NUM_WORKERS).run(f, a), census_ranks,
                     device, mode_of)


# ---------------------------------------------------------------------- #
# the checks
# ---------------------------------------------------------------------- #


def _token_dominance(label: str, events, n_buckets: int) -> List[Violation]:
    """Each bucket b: its 'enc b' mark, then its all_gather (the b-th on the
    exchange's axis), then its 'dec b' mark."""
    order: Dict[str, int] = {}
    gathers = 0
    for i, (kind, item) in enumerate(events):
        if kind == "mark":
            order.setdefault(item, i)
        elif kind == "coll" and item.op == "all_gather" and item.axis in (AXIS, "dcn"):
            order.setdefault(f"gather {gathers}", i)
            gathers += 1
    bad = []
    for b in range(n_buckets):
        e, g, dec = (order.get(f"enc {b}"), order.get(f"gather {b}"), order.get(f"dec {b}"))
        if e is None or g is None or dec is None or not e < g < dec:
            bad.append(f"bucket {b}: encode@{e} gather@{g} decode@{dec}")
    if gathers != n_buckets:
        bad.append(f"{gathers} gathers for {n_buckets} buckets")
    if not bad:
        return []
    return [Violation(R_TOKEN_DOMINANCE, label, "streamed order broken: " + "; ".join(bad))]


def check_calls(ctx: AuditContext, calls: List[rec.Call], width: int) -> List[Violation]:
    """`jx-collective-count` and `jx-wire-accounting` over one step's
    recorded calls."""
    out: List[Violation] = []
    diffs = []
    if ctx.expect_collectives is not None:
        got = rec.counts(calls)
        for prim in sorted(set(rec.COLLECTIVE_PRIMS) | set(ctx.expect_collectives) | set(got)):
            want, have = ctx.expect_collectives.get(prim, 0), got.get(prim, 0)
            if want != have:
                diffs.append(f"{prim}: want {want}, got {have}")
    if ctx.expect_collectives_by_axis is not None:
        by_axis, spec = rec.counts_by_axis(calls), ctx.expect_collectives_by_axis
        for ax in sorted(set(by_axis) - set(spec)):
            diffs.append(f"axis {ax!r}: {sum(by_axis[ax].values())} collective(s) on an axis the contract does "
                         "not mention")
        for ax in sorted(spec):
            have_ax = by_axis.get(ax, {})
            for prim in sorted(set(rec.COLLECTIVE_PRIMS) | set(spec[ax]) | set(have_ax)):
                want, have = spec[ax].get(prim, 0), have_ax.get(prim, 0)
                if want != have:
                    diffs.append(f"{ax}/{prim}: want {want}, got {have}")
    if diffs:
        out.append(Violation(R_COLLECTIVE_COUNT, ctx.label, "collective inventory mismatch: " + "; ".join(diffs)))
    if ctx.wire_mode is not None and ctx.expected_wire_bytes is not None:
        on = [c for c in calls if ctx.wire_axis is None or c.axis == ctx.wire_axis]
        want = ctx.expected_wire_bytes
        if ctx.wire_mode == "allgather":
            moved = rec.operand_bytes(on, ops=("all_gather",))
            if moved != want:
                out.append(Violation(R_WIRE_ACCOUNTING, ctx.label,
                                     f"all_gather operands move {moved} B/worker but payload_bytes() reports {want} B"))
        elif ctx.wire_mode == "collective":
            moved = rec.operand_bytes(on)
            if moved != want:
                out.append(Violation(R_WIRE_ACCOUNTING, ctx.label,
                                     f"collective operands move {moved} B/worker but payload_bytes() reports {want} B"))
        elif ctx.wire_mode == "ring":
            hops = [c.nbytes for c in on if c.op == "ppermute"]
            w = ctx.num_workers or width
            if not hops:
                out.append(Violation(R_WIRE_ACCOUNTING, ctx.label, "ring run made no ppermute hops"))
            elif len(set(hops)) > 1:
                out.append(Violation(R_WIRE_ACCOUNTING, ctx.label,
                                     f"ring hops forward different buffer sizes: {sorted(set(hops))}"))
            elif hops[0] * (w - 1) != want or sum(hops) != want:
                out.append(Violation(R_WIRE_ACCOUNTING, ctx.label,
                                     f"{len(hops)} ring hops of {hops[0]} B; (W-1)*B = {hops[0] * (w - 1)} B, "
                                     f"moved {sum(hops)} B, payload_bytes() {want} B"))
        else:
            raise ValueError(f"unknown wire_mode {ctx.wire_mode!r}")
    for c in calls:
        if c.dtype in ("float64", "complex128"):
            out.append(Violation(R_DTYPE_FLOW, ctx.label, f"a {c.dtype} operand on the wire ({c.op} on {c.axis})"))
            break
    return out


def check_ops(ctx: AuditContext, ops: List[cen.Op]) -> List[Violation]:
    """The census rules over one worker-step's ops."""
    out: List[Violation] = []
    f64 = cen.outside(ops, F64_SITES, f64=True)
    if f64:
        out.append(Violation(R_F64, ctx.label, f"{len(f64)} float64 op(s) outside the listed sites "
                                               f"(first: {cen.site_text(f64[0])})"))
    if not ctx.allow_host_syncs:
        reads = cen.outside(ops, HOST_SYNC_SITES, host_reads=True)
        if reads:
            out.append(Violation(R_CALLBACK, ctx.label, f"{len(reads)} host read(s) outside the host codecs "
                                                        f"(first: {cen.site_text(reads[0])})"))
    if ctx.expect_codec_invocations is not None:
        got = cen.selections(ops)
        if got != ctx.expect_codec_invocations:
            out.append(Violation(R_CODEC_COUNT, ctx.label,
                                 f"{got} selection(s) (sparse.top_order's sort) but the trace contracts exactly "
                                 f"{ctx.expect_codec_invocations}"))
    if ctx.forbid_gather:
        n = cen.count(ops, cen.GATHER_OPS)
        if n:
            out.append(Violation(R_GATHER_IN_MOD_QUERY, ctx.label,
                                 f"{n} gather/index op(s) in a run contracted to be gather-free"))
    return out


def _dtype_flow(ctx: AuditContext, outputs) -> List[Violation]:
    for per_worker in outputs:
        for dtypes in per_worker:
            for name, (g, a) in (dtypes or {}).items():
                if g != a:
                    return [Violation(R_DTYPE_FLOW, ctx.label, f"{name}: a {g} gradient aggregates to {a}")]
    return []


def _across_steps(ctx: AuditContext, run: Run, ranks) -> List[Violation]:
    """`jx-retrace` / `jx-dynamic-shape` (census hashes) and
    `jx-collective-schedule` (call sequences) over the run's steps. The
    census compares the steps after the first where there are three or
    more (a first call fills caches, the checksum weights, once, as a trace
    computes its constants once), outside the chaos injector's brackets."""
    out: List[Violation] = []
    later = range(1, len(run.steps)) if len(run.steps) > 2 else range(len(run.steps))
    for r in ranks:
        texts = [[op.text() for op in steady_ops(run.tapes[i][r])] for i in later]
        names = [[t.split("|")[0] for t in x] for x in texts]
        if any(n != names[0] for n in names[1:]):
            out.append(Violation(R_RETRACE, ctx.label, f"worker {r}: the op sequence differs between steps "
                                                       f"{[run.steps[i] for i in later]} "
                                                       f"({[len(n) for n in names]} ops)"))
            break
        if any(t != texts[0] for t in texts[1:]):
            out.append(Violation(R_DYNAMIC_SHAPE, ctx.label, f"worker {r}: op shapes or dtypes differ between "
                                                             f"steps {run.steps}"))
            break
    for r in range(run.width):
        seqs = [rec.schedule(run.tapes[i][r].calls) for i in range(len(run.steps))]
        if any(s != seqs[0] for s in seqs[1:]):
            out.append(Violation(R_COLLECTIVE_SCHEDULE, ctx.label,
                                 f"worker {r}: the collective sequence differs between steps {run.steps} "
                                 f"({[len(s) for s in seqs]} calls)"))
            break
    return out


def _first_found(check, cases) -> List[Violation]:
    """The violations of the first case `check` finds any in."""
    for case in cases:
        found = check(*case)
        if found:
            return found
    return []


def check_trace(ctx: AuditContext, run: Run, census_ranks=(0,)) -> TraceRecord:
    """Every rule the context arms, over a harness's run, each step; the
    record holds rank 0's first step, and the run's host syncs on the card
    (`card_syncs`, None off the card)."""
    steps = range(len(run.steps))
    violations = _first_found(lambda i, r: check_calls(ctx, run.tapes[i][r].calls, run.width),
                              [(i, r) for i in steps for r in range(run.width)])
    violations += _first_found(lambda i, r: check_ops(ctx, cen.ops_of(run.tapes[i][r])),
                               [(i, r) for i in steps for r in census_ranks])
    syncs = [] if run.syncs is None or ctx.allow_host_syncs else [
        site for site in run.syncs if not cen.at_site(site, HOST_SYNC_SITES)]
    if syncs:
        violations.append(Violation(R_CALLBACK, ctx.label, f"{len(syncs)} host sync(s) on the card outside the host "
                                                           f"codecs (first: {syncs[0][0]}:{syncs[0][2]} "
                                                           f"({syncs[0][1]}))"))
    calls0 = run.tapes[0][0].calls
    if ctx.expect_stream_buckets is not None:
        violations.extend(_token_dominance(ctx.label, run.tapes[0][0].events, ctx.expect_stream_buckets))
    violations.extend(_dtype_flow(ctx, run.outputs))
    if len(run.steps) > 1:
        violations.extend(_across_steps(ctx, run, census_ranks))
    if ctx.require_key_lineage:
        violations.extend(key_lineage_violations(ctx.label, run.draws, list(run.steps)))
    ops0 = cen.ops_of(run.tapes[0][0])
    return TraceRecord(
        label=ctx.label,
        violations=violations,
        collectives=rec.counts(calls0),
        census_hash=cen.census_hash(ops0),
        payload_bytes=run.payload_bytes,
        collectives_by_axis=rec.counts_by_axis(calls0) or None,
        selections=cen.selections(ops0),
        ops=len(ops0),
        extra=dict(run.extra, host_reads=sum(op.host for op in ops0),
                   card_syncs=None if run.syncs is None else len(run.syncs)),
    )


# ---------------------------------------------------------------------- #
# the audited labels
# ---------------------------------------------------------------------- #

def _tagged(record: TraceRecord, cfg: DeepReduceConfig, harness: str) -> List[TraceRecord]:
    record.config, record.harness = dataclasses.asdict(cfg), harness
    return [record]


AUDIT_STEPS = (STEP, STEP + 1, STEP)  # other values, the next step, the step replayed
# the workers whose ops the audit's census records (the recorder records
# every worker's collectives): worker 0; a second census costs as much again
# as the run without one
CENSUS_RANKS = (0,)
MASKS = [None, [True] * 5 + [False] + [True] * 2, None]  # with_mask runs: a dropped worker on the second step


def audit_exchange(label: str, cfg: DeepReduceConfig, *, d: int = 4096, leaves=None, expect=None,
                   wire_mode=None, expect_codec=None, with_mask: bool = False, profile=None, device="cpu",
                   steps=AUDIT_STEPS) -> List[TraceRecord]:
    """The flat exchange over three steps (two values, a replay) on W = 8
    workers; `with_mask` runs all-live, one-dropped and all-live masks."""
    masks = ([[True] * NUM_WORKERS, MASKS[1], [True] * NUM_WORKERS][: len(steps)] if with_mask else None)
    run = run_flat(cfg, d=d, leaves=leaves, steps=steps, masks=masks, profile=profile, device=device,
                   census_ranks=CENSUS_RANKS)
    ctx = AuditContext(label=label, expect_collectives=expect, wire_mode=wire_mode,
                       expected_wire_bytes=run.payload_bytes if wire_mode else None, num_workers=NUM_WORKERS,
                       expect_codec_invocations=expect_codec, require_key_lineage=True)
    return _tagged(check_trace(ctx, run, census_ranks=CENSUS_RANKS), cfg, "flat")


def audit_hier_exchange(label: str, cfg: DeepReduceConfig, *, leaves=None, expect_by_axis=None, wire_mode=None,
                        expect_codec=None, device="cpu", steps=AUDIT_STEPS) -> List[TraceRecord]:
    run = run_hier(cfg, leaves=leaves, steps=steps, device=device, census_ranks=CENSUS_RANKS)
    ctx = AuditContext(label=label, expect_collectives_by_axis=expect_by_axis, wire_mode=wire_mode,
                       expected_wire_bytes=run.payload_bytes if wire_mode else None, wire_axis="dcn",
                       num_workers=2, expect_codec_invocations=expect_codec, require_key_lineage=True)
    return _tagged(check_trace(ctx, run, census_ranks=CENSUS_RANKS), cfg, "hier")


def audit_stream(label: str, cfg: DeepReduceConfig, *, device="cpu", steps=AUDIT_STEPS) -> List[TraceRecord]:
    run = run_stream(cfg, steps=steps, device=device, census_ranks=CENSUS_RANKS)
    if cfg.hier:
        expect = dict(expect_collectives_by_axis={"ici": {"psum": _BUCKET_COUNT}, "dcn": {"all_gather": _BUCKET_COUNT}},
                      wire_axis="dcn", num_workers=2)
    else:
        expect = dict(expect_collectives={"all_gather": _BUCKET_COUNT}, num_workers=NUM_WORKERS)
    ctx = AuditContext(label=label, wire_mode="allgather", expected_wire_bytes=run.payload_bytes,
                       expect_codec_invocations=_BUCKET_COUNT, expect_stream_buckets=_BUCKET_COUNT,
                       require_key_lineage=True, **expect)
    return _tagged(check_trace(ctx, run, census_ranks=CENSUS_RANKS), cfg, "stream")


def audit_fed(label: str, cfg: DeepReduceConfig, *, device="cpu", steps=AUDIT_STEPS) -> List[TraceRecord]:
    run = run_fed(cfg, steps=steps, device=device, census_ranks=CENSUS_RANKS)
    # two selections a round (the S2C delta's, the cohort's batched one), a
    # tenant's in turn (`lattice.DEVIATIONS['fed-mt-per-tenant-encode']`)
    ctx = AuditContext(label=label, expect_collectives={"psum": 1}, wire_mode="collective",
                       expected_wire_bytes=run.payload_bytes, num_workers=NUM_WORKERS,
                       expect_codec_invocations=2 * max(1, int(cfg.fed_tenants or 0)), require_key_lineage=True)
    return _tagged(check_trace(ctx, run, census_ranks=CENSUS_RANKS), cfg, "fed")


def audit_codec(label: str, cfg: DeepReduceConfig, *, d: int = 8192, name: str = "g",
                device="cpu") -> List[TraceRecord]:
    """One TensorCodec's encode and decode, each under the census, twice
    (two gradient values): a codec unit has no collective; a host codec may
    read on the host."""
    from deepreduce_tpu_torch.wrappers import TensorCodec

    codec = TensorCodec((d,), cfg, name=name, device=device)
    host = (cfg.index in CALLBACK_WHITELIST and cfg.deepreduce in ("index", "both")) or (
        cfg.value in CALLBACK_WHITELIST and cfg.deepreduce in ("value", "both"))
    records = []
    tapes_e, tapes_d, payloads = [], [], []
    with StreamLog() as log, cen.SyncWatch(device) as syncs:
        for i, step in enumerate((STEP, STEP + 1)):
            t = _values((d,), 11 + i, device)
            tape = rec.Tape()
            with cen.Census(tape):
                p = codec.encode(t, step=step)
            tapes_e.append(tape)
            tape = rec.Tape()
            with cen.Census(tape):
                dec = codec.decode(p, step=step)
            tapes_d.append(tape)
            payloads.append((t.dtype, dec.dtype))
    for stage, tapes in (("encode", tapes_e), ("decode", tapes_d)):
        ctx = AuditContext(label=f"{label}/{stage}", expect_collectives={}, allow_host_syncs=host)
        run = Run((STEP, STEP + 1), [[t] for t in tapes], [[{"g": payloads[0]}], [{"g": payloads[1]}]], None, 1,
                  log.draws, syncs=syncs.sites)
        records.append(check_trace(ctx, run))
    return records


def audit_mod_query(*, d: int = 8192, k: int = 163, device="cpu") -> List[TraceRecord]:
    """The mod-blocked universe query, contracted gather-free."""
    from deepreduce_tpu_torch.codecs import bloom

    meta = bloom.BloomMeta.create(k, d, policy="leftmost", blocked="mod")
    words = torch.from_numpy(np.random.default_rng(5).integers(0, 2 ** 31, meta.m_bits // 32).astype(np.uint32)
                             .view(np.int32)).to(device)
    tape = rec.Tape()
    with cen.SyncWatch(device) as syncs, cen.Census(tape):
        bloom.query_universe(words, meta)
    ctx = AuditContext(label="query:bloom-mod", expect_collectives={}, forbid_gather=True)
    return [check_trace(ctx, Run((STEP,), [[tape]], [[None]], None, 1, [], syncs=syncs.sites))]


def _hash_of(run: Run) -> str:
    return cen.census_hash(cen.ops_of(run.tapes[0][0]))


def audit_resilience_off(*, d: int = 4096, device="cpu") -> List[TraceRecord]:
    """Resilience off must equal the run with every seam patched out (chaos
    perturb the identity, no participation mask, the checksum verify a
    constant): `jx-resilience-off-identical` on the census hashes."""
    from deepreduce_tpu_torch import comm as comm_mod
    from deepreduce_tpu_torch.resilience import chaos as chaos_mod
    from deepreduce_tpu_torch.resilience import faults as faults_mod

    cfg = DeepReduceConfig(memory="residual", decode_strategy="loop", **_FLAGSHIP)
    off = run_flat(cfg, d=d, device=device, census_ranks=(0,))
    patches = [
        (chaos_mod.ChaosInjector, "perturb", lambda self, buf, **kw: buf),
        (faults_mod, "participation_mask", lambda *a, **kw: None),
        (comm_mod.PayloadLayout, "verify", lambda self, rows: torch.ones(rows.shape[:-1], device=rows.device)),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, repl in patches:
            setattr(obj, attr, repl)
        absent = run_flat(cfg, d=d, device=device, census_ranks=(0,))
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)
    h_off, h_absent = _hash_of(off), _hash_of(absent)
    violations = []
    if h_off != h_absent:
        violations.append(Violation(R_RESILIENCE_OFF, "resilience:off-identical",
                                    f"resilience-off run ({h_off}) differs from the seam-free run ({h_absent})"))
    calls = off.tapes[0][0].calls
    return [TraceRecord("resilience:off-identical", violations, rec.counts(calls), h_off)]


def audit_ctrl_ladder(*, d: int = 4096, device="cpu") -> List[TraceRecord]:
    """One distinct census hash per ladder rung, each rung's exchanger a
    fresh one at that operating point, and ctrl off identical at rung 0."""
    from deepreduce_tpu_torch.controller.ladder import Ladder

    base = dict(memory="residual", decode_strategy="loop", **_FLAGSHIP)
    cfg = DeepReduceConfig(telemetry=True, ctrl=True, ctrl_ladder=_CTRL_LADDER, **base)
    ladder = Ladder.parse(cfg.ctrl_ladder)
    records, hashes = [], []
    for i in range(len(ladder)):
        (r,) = audit_exchange(f"ctrl:ladder[{i}]", ladder.apply(cfg, i), d=d, expect={"all_gather": 1},
                              wire_mode="allgather", device=device, steps=(STEP,))
        hashes.append(r.census_hash)
        records.append(r)
    violations = []
    if len(set(hashes)) != len(ladder):
        violations.append(Violation(R_CTRL_LADDER, "ctrl:ladder-cardinality",
                                    f"{len(ladder)} rungs ran {len(set(hashes))} distinct programs ({hashes})"))
    pt = ladder[0]
    off = DeepReduceConfig(telemetry=True, **{**base, "compress_ratio": pt.ratio,
                                              **({} if pt.fpr is None else {"fpr": pt.fpr})})
    (r_off,) = audit_exchange("ctrl:off-identical", off, d=d, expect={"all_gather": 1}, wire_mode="allgather",
                              device=device, steps=(STEP,))
    if r_off.census_hash != hashes[0]:
        violations.append(Violation(R_CTRL_LADDER, "ctrl:off-identical",
                                    f"ctrl=True at rung 0 ({hashes[0]}) differs from the fixed config at the same "
                                    f"point ({r_off.census_hash})"))
    records.append(r_off)
    records.append(TraceRecord("ctrl:ladder-cardinality", violations, {},
                               hashlib.sha256("".join(hashes).encode()).hexdigest()[:16]))
    return records


def audit_calib_reselect(*, device="cpu") -> List[TraceRecord]:
    """A profile that restates the static constants
    (`costmodel.static_profile()`) changes no pick of `select_rs_mode` and
    `select_hier_plan` over the JAX package's sweep, and an 'auto' exchange
    built with it runs the same program as one built without."""
    from deepreduce_tpu_torch import costmodel

    prof = costmodel.static_profile()
    violations, picks = [], []
    for d in (4096, 4_053_428):
        for ratio in (0.001, 0.01, 0.1):
            for W in (8, 32):
                base = costmodel.select_rs_mode(d, W, ratio)
                with_p = costmodel.select_rs_mode(d, W, ratio, profile=prof)
                picks.append(f"rs:{d}:{W}:{ratio}:{base}")
                if base != with_p:
                    violations.append(Violation(R_CALIB_RESELECT, "calib:selector-identity",
                                                f"select_rs_mode(d={d}, W={W}, ratio={ratio}) flipped {base!r} -> "
                                                f"{with_p!r} under static_profile()"))
            for n_slices, per_slice in ((8, 4), (2, 16)):
                base = costmodel.select_hier_plan(d, n_slices, per_slice, ratio)
                with_p = costmodel.select_hier_plan(d, n_slices, per_slice, ratio, profile=prof)
                picks.append(f"hier:{d}:{n_slices}x{per_slice}:{ratio}:{base['ici']}+{base['dcn']}")
                if (base["ici"], base["dcn"]) != (with_p["ici"], with_p["dcn"]) or base["table"] != with_p["table"]:
                    violations.append(Violation(R_CALIB_RESELECT, "calib:selector-identity",
                                                f"select_hier_plan(d={d}, {n_slices}x{per_slice}, ratio={ratio}) "
                                                "moved under static_profile()"))
    cfg = DeepReduceConfig(communicator="sparse_rs", compressor="topk", memory="none", deepreduce=None,
                           compress_ratio=0.01, rs_mode="auto")
    (r_off,) = audit_exchange("calib:auto-no-profile", cfg, device=device, steps=(STEP,))
    (r_on,) = audit_exchange("calib:auto-static-profile", cfg, profile=prof, device=device, steps=(STEP,))
    if r_off.census_hash != r_on.census_hash:
        violations.append(Violation(R_CALIB_RESELECT, "calib:program-identity",
                                    f"rs_mode='auto' with static_profile() ({r_on.census_hash}) differs from the "
                                    f"profile-free run ({r_off.census_hash})"))
    digest = hashlib.sha256("".join([r_off.census_hash, r_on.census_hash] + picks).encode()).hexdigest()[:16]
    return [r_off, r_on, TraceRecord("calib:reselect-identity", violations, {}, digest)]


_POP_SPEC = ('{"version": 1, "num_labels": 8, "classes": [{"name": "bulk", "weight": 3.0, "data_alpha": 0.5}, '
             '{"name": "skewed", "weight": 1.0, "data_alpha": 0.1, "data_bias": 4.0, "local_steps_mult": 2.0}]}')
_POP_LATENCY = ('{"version": 1, "num_labels": 8, "classes": [{"name": "bulk", "weight": 3.0, "data_alpha": 0.5, '
                '"latency": "0.6,0.3,0.1"}, {"name": "skewed", "weight": 1.0, "data_alpha": 0.1, "data_bias": 4.0, '
                '"latency": "0.2,0.5,0.3"}]}')
_FED = dict(memory="residual", fed=True, fed_num_clients=64, fed_clients_per_round=16, fed_local_steps=2,
            **_FLAGSHIP)
_ASYNC = dict(fed_async=True, fed_async_k=40, fed_async_alpha=0.5, fed_async_latency="0.5,0.3,0.2")

# ANALYSIS.json labels the port has no counterpart for, and why
NOT_PORTED = {
    "hier:fused-loop-keyed": "the port's replicas draw alike by construction (streams keyed by the dcn rank): "
                             "there is no key-repair gather to audit",
}


def audit_specs(quick: bool = False, device="cpu",
                steps=AUDIT_STEPS) -> List[Tuple[str, Callable[[], List[TraceRecord]]]]:
    """(label, thunk) per audited configuration, in the JAX package's
    order. `quick` keeps the tier-1 subset: the mod query, the flagship
    codec and the fused exchange's loop, vmap and ring decodes and the
    bucketed one. The exchanges, streamed steps and rounds run `steps`."""
    C = DeepReduceConfig
    specs: List[Tuple[str, Callable[[], List[TraceRecord]]]] = []

    def add(label, thunk):
        specs.append((label, thunk))

    add("query:bloom-mod", lambda: audit_mod_query(device=device))
    add("codec:bloom-mod", lambda: audit_codec("codec:bloom-mod", C(**_FLAGSHIP), device=device))
    add("exchange:fused-loop", lambda: audit_exchange(
        "exchange:fused-loop", C(memory="residual", decode_strategy="loop", **_FLAGSHIP),
        expect={"all_gather": 1}, wire_mode="allgather", expect_codec=1, device=device, steps=steps))
    add("exchange:bucketed-loop", lambda: audit_exchange(
        "exchange:bucketed-loop", C(memory="residual", decode_strategy="loop", bucket_bytes=_BUCKET_BYTES,
                                    **_FLAGSHIP),
        leaves=_BUCKET_LEAVES, expect={"all_gather": _BUCKET_COUNT}, wire_mode="allgather",
        expect_codec=_BUCKET_COUNT, device=device, steps=steps))
    add("exchange:fused-vmap", lambda: audit_exchange(
        "exchange:fused-vmap", C(memory="residual", decode_strategy="vmap", decode_batch=4, **_FLAGSHIP),
        expect={"all_gather": 1}, wire_mode="allgather", device=device, steps=steps))
    add("exchange:fused-ring", lambda: audit_exchange(
        "exchange:fused-ring", C(memory="residual", decode_strategy="ring", **_FLAGSHIP),
        expect={"ppermute": NUM_WORKERS - 1}, wire_mode="ring", device=device, steps=steps))
    if quick:
        return specs
    add("exchange:fused-loop-resilient", lambda: audit_exchange(
        "exchange:fused-loop-resilient", C(memory="residual", decode_strategy="loop", resilience=True,
                                           payload_checksum=True, chaos_corrupt_rate=0.2, **_FLAGSHIP),
        expect={"all_gather": 1}, wire_mode="allgather", with_mask=True, device=device, steps=steps))
    add("resilience:off-identical", lambda: audit_resilience_off(device=device))
    add("hier:fused-loop", lambda: audit_hier_exchange(
        "hier:fused-loop", C(memory="residual", decode_strategy="loop", hier=True, **_FLAGSHIP),
        expect_by_axis={"ici": {"psum": 1}, "dcn": {"all_gather": 1}}, wire_mode="allgather", expect_codec=1,
        device=device, steps=steps))
    add("codec:bloom", lambda: audit_codec("codec:bloom", C(deepreduce="index", index="bloom", compress_ratio=0.02,
                                                            fpr=0.01, min_compress_size=100), device=device))
    add("codec:bloom-hash", lambda: audit_codec("codec:bloom-hash", C(
        deepreduce="index", index="bloom", bloom_blocked="hash", compress_ratio=0.02, fpr=0.01,
        min_compress_size=100), device=device))
    add("codec:bloom-mod-p0", lambda: audit_codec("codec:bloom-mod-p0", C(policy="p0", **_FLAGSHIP), device=device))
    add("codec:bloom-direct", lambda: audit_codec("codec:bloom-direct", C(
        compressor="topk_sampled", bloom_threshold_insert=True, **_FLAGSHIP), device=device))
    for idx in ("rle", "integer", "huffman"):
        add(f"codec:{idx}", lambda idx=idx: audit_codec(f"codec:{idx}", C(
            deepreduce="index", index=idx, compress_ratio=0.02, min_compress_size=100), device=device))
    for idx in ("bloom_native", "integer_native"):
        add(f"codec:{idx}", lambda idx=idx: audit_codec(f"codec:{idx}", C(
            deepreduce="index", index=idx, compress_ratio=0.02, fpr=0.01, min_compress_size=100), device=device))
    for val in ("polyfit", "doubleexp", "qsgd", "gzip", "polyfit_host"):
        add(f"codec:{val}", lambda val=val: audit_codec(f"codec:{val}", C(
            deepreduce="value", value=val, compress_ratio=0.02, min_compress_size=100), device=device))
    add("codec:polyseg", lambda: audit_codec("codec:polyseg", C(
        deepreduce="value", value="polyseg", compress_ratio=0.02, min_compress_size=100), name="conv_kernel",
        device=device))
    add("codec:both-modbloom-qsgd", lambda: audit_codec("codec:both-modbloom-qsgd", C(
        **{**_FLAGSHIP, "deepreduce": "both", "value": "qsgd", "policy": "p0"}), device=device))
    add("exchange:bucketed-vmap", lambda: audit_exchange(
        "exchange:bucketed-vmap", C(memory="residual", decode_strategy="vmap", decode_batch=4,
                                    bucket_bytes=_BUCKET_BYTES, **_FLAGSHIP),
        leaves=_BUCKET_LEAVES, expect={"all_gather": _BUCKET_COUNT}, wire_mode="allgather",
        expect_codec=_BUCKET_COUNT, device=device, steps=steps))
    add("exchange:per-tensor", lambda: audit_exchange(
        "exchange:per-tensor", C(fused=False, memory="none", **_FLAGSHIP), expect={"all_gather": 1},
        wire_mode="allgather", device=device, steps=steps))
    add("exchange:dense-allreduce", lambda: audit_exchange(
        "exchange:dense-allreduce", C(communicator="allreduce", compressor="none", memory="none", deepreduce=None),
        expect={"psum": 1}, device=device, steps=steps))
    add("exchange:qar", lambda: audit_exchange(
        "exchange:qar", C(communicator="qar", compressor="none", memory="none", deepreduce=None),
        expect={"all_to_all": 1, "all_gather": 1}, device=device, steps=steps))
    rs = dict(communicator="sparse_rs", compressor="topk", memory="none", deepreduce=None, compress_ratio=0.02)
    for mode, expect in (("sparse", {"all_to_all": 1, "all_gather": 1}),
                         ("adaptive", {"all_to_all": 1, "all_gather": 1}),
                         ("quantized", {"pmax": 1, "reduce_scatter": 1, "all_gather": 1}),
                         ("sketch", {"psum": 1, "all_gather": 1})):
        label = "exchange:sparse_rs" if mode == "sparse" else f"exchange:sparse_rs-{mode}"
        kw = {} if mode == "sparse" else {"rs_mode": mode}
        add(label, lambda label=label, kw=kw, expect=expect: audit_exchange(
            label, C(**rs, **kw), expect=expect, wire_mode="collective", device=device, steps=steps))
    add("hier:qar-ici", lambda: audit_hier_exchange(
        "hier:qar-ici", C(memory="residual", decode_strategy="loop", hier=True, hier_ici="qar", **_FLAGSHIP),
        expect_by_axis={"ici": {"all_to_all": 1, "all_gather": 1}, "dcn": {"all_gather": 1}},
        wire_mode="allgather", device=device, steps=steps))
    add("hier:bucketed-dcn", lambda: audit_hier_exchange(
        "hier:bucketed-dcn", C(memory="residual", decode_strategy="loop", hier=True, bucket_bytes=_BUCKET_BYTES,
                               **_FLAGSHIP),
        leaves=_BUCKET_LEAVES, expect_by_axis={"ici": {"psum": 1}, "dcn": {"all_gather": _BUCKET_COUNT}},
        wire_mode="allgather", expect_codec=_BUCKET_COUNT, device=device, steps=steps))
    add("hier:quantized-dcn", lambda: audit_hier_exchange(
        "hier:quantized-dcn", C(**rs, rs_mode="quantized", hier=True),
        expect_by_axis={"ici": {"psum": 1}, "dcn": {"pmax": 1, "reduce_scatter": 1, "all_gather": 1}},
        wire_mode="collective", device=device, steps=steps))
    add("fedsim:round", lambda: audit_fed("fedsim:round", C(**_FED), device=device, steps=steps))
    add("codec:countsketch", lambda: audit_codec("codec:countsketch", C(
        deepreduce="value", value="countsketch", compress_ratio=0.02, min_compress_size=100), device=device))
    add("ctrl:ladder", lambda: audit_ctrl_ladder(device=device))
    add("exchange:streaming", lambda: audit_stream("exchange:streaming", C(
        memory="residual", decode_strategy="loop", bucket_bytes=_BUCKET_BYTES, stream_exchange=True, **_FLAGSHIP),
        device=device, steps=steps))
    add("calib:reselect", lambda: audit_calib_reselect(device=device))
    add("exchange:sparse_rs-oktopk", lambda: audit_exchange(
        "exchange:sparse_rs-oktopk", C(**rs, rs_mode="oktopk"), expect={"psum": 1, "all_to_all": 1, "all_gather": 1},
        wire_mode="collective", device=device, steps=steps))
    add("fedsim:async-round", lambda: audit_fed("fedsim:async-round", C(**_FED, **_ASYNC), device=device, steps=steps))
    for T in (2, 4):
        add(f"fedsim:multi-tenant-T{T}", lambda T=T: audit_fed(
            f"fedsim:multi-tenant-T{T}", C(**_FED, **_ASYNC, fed_tenants=T), device=device, steps=steps))
    add("exchange:stream-hier", lambda: audit_stream("exchange:stream-hier", C(
        memory="residual", decode_strategy="loop", bucket_bytes=_BUCKET_BYTES, stream_exchange=True, hier=True,
        **_FLAGSHIP), device=device, steps=steps))
    for mode, expect in (("sparse", {"all_to_all": 1, "all_gather": 1}),
                         ("quantized", {"pmax": 1, "reduce_scatter": 1, "all_gather": 2}),
                         ("oktopk", {"psum": 1, "all_to_all": 1, "all_gather": 1})):
        label = f"exchange:sparse_rs-{mode}-masked"
        add(label, lambda label=label, mode=mode, expect=expect: audit_exchange(
            label, C(**rs, rs_mode=mode, resilience=True), expect=expect, wire_mode="collective", with_mask=True,
            device=device, steps=steps))
    add("fedsim:population", lambda: audit_fed("fedsim:population", C(**_FED, pop_spec=_POP_SPEC), device=device, steps=steps))
    add("fedsim:population-async", lambda: audit_fed(
        "fedsim:population-async", C(**_FED, **_ASYNC, pop_spec=_POP_SPEC), device=device, steps=steps))
    add("fedsim:population-latency", lambda: audit_fed(
        "fedsim:population-latency", C(**_FED, **_ASYNC, pop_spec=_POP_LATENCY), device=device, steps=steps))
    return specs


def audit_all(quick: bool = False, device="cpu", labels=None,
              steps=AUDIT_STEPS) -> Tuple[List[TraceRecord], List[Violation]]:
    """Run every audit spec (or those named in `labels`)."""
    records: List[TraceRecord] = []
    for label, thunk in audit_specs(quick=quick, device=device, steps=steps):
        if labels is None or label in labels:
            records.extend(thunk())
    return records, [v for r in records for v in r.violations]
