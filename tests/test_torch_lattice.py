"""The composition lattice replayed through the port, held to the JAX
package's committed MATRIX.json (read as data): every cell's legality,
stage and reason code; every one of the 86 distinct legal programs' run
inventory (collectives by op and axis) and wire bytes, JAX's static counts
turned into a run's by the loop trips (derived here from JAX's own jaxpr for
the ring decode) and the stated deviations; and the exchanger's build-check
order, whose repair moved 72 cells to JAX's reason code."""

import json
import os

import jax
import pytest

from deepreduce_tpu.analysis import jaxpr_audit as ja
from deepreduce_tpu.analysis.rules import COLLECTIVE_PRIMS, _subjaxprs, eqn_axes
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu_torch.analysis import audit, lattice
from deepreduce_tpu_torch.analysis import recorder as rec
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRIX = lattice.load_report(os.path.join(REPO, "MATRIX.json"))


@pytest.fixture(scope="module")
def stages():
    """The config and build stages of all 73,728 cells, no runs."""
    return lattice.build_matrix(traces=False)


@pytest.fixture(scope="module")
def replay():
    """Every cell, with one run of each distinct legal program."""
    stats = {}
    return lattice.build_matrix(stats=stats, traces=True), stats


def test_config_and_build_stages_equal_matrix(stages):
    diffs, used = lattice.compare_matrix(MATRIX, stages, traces=False)
    assert diffs == []
    assert used == {}  # no cell turned away with a code of the port's own
    s, m = stages["summary"], MATRIX["summary"]
    assert (s["cells"], s["legal"], s["rejected"]) == (73_728, 108, 73_620)
    assert s["reason_codes"] == m["reason_codes"]
    assert len(m["reason_codes"]) == 23
    build = {e["reason_code"] for e in stages["entries"] if e.get("stage") == "build"}
    assert build == {"build-buckets-need-fused-allgather", "build-buckets-vs-ring",
                     "build-decode-strategy-needs-fused-allgather"}
    assert stages["violations"] == []


def _regression_cells():
    """The cells both build fences refuse: buckets on, a vmap or ring decode,
    a communicator other than the fused allgather; config-legal."""
    out = []
    for i, cell in enumerate(lattice.iter_cells()):
        if cell["buckets"] != "on" or cell["decode"] == "loop":
            continue
        entry = MATRIX["entries"][MATRIX["cells"][i]]
        if entry.get("stage") == "build" and entry["reason_code"] == "build-buckets-need-fused-allgather" and (
                cell["communicator"] != "allgather"):
            out.append(cell)
    return out


REGRESSION = _regression_cells()


def test_build_order_regression_covers_72_cells():
    assert len(REGRESSION) == 72
    assert sum(c["hier"] == "off" for c in REGRESSION) == 56


@pytest.mark.parametrize("cell", REGRESSION, ids=lattice.cell_slug)
def test_build_order_matches_jax(cell):
    """The bucket fences come before the decode-strategy fence, as in the
    JAX package: the cell gets MATRIX.json's code from the port's build."""
    part = lattice.probe_partition(cell)
    assert part[0] == "legal"
    with pytest.raises(ConfigError) as e:
        lattice.build_cell(part[1], lattice.harness_name(cell))
    assert e.value.reason_code == "build-buckets-need-fused-allgather"


def _points_cells():
    """The flat, unstreamed regression cells with bucket_points in place of
    bucket_bytes (a stream needs buckets), one a distinct config."""
    seen, out = set(), []
    for cell in REGRESSION:
        kw = lattice.cell_kwargs(cell)
        kw.pop("bucket_bytes")
        key = json.dumps(kw, sort_keys=True)
        if cell["hier"] == cell["stream"] == "off" and key not in seen:
            seen.add(key)
            out.append(cell)
    return out


@pytest.mark.parametrize("cell", _points_cells(), ids=lattice.cell_slug)
def test_bucket_points_fence_before_decode_fence(cell):
    """bucket_points without bucket_bytes, on a vmap or ring decode off the
    fused allgather: both packages refuse it with the bucket-points code,
    which JAX checks before the decode strategy's."""
    import jax.numpy as jnp

    from deepreduce_tpu.comm import GradientExchanger as JExchanger
    from deepreduce_tpu.config import ConfigError as JConfigError
    from deepreduce_tpu_torch.collectives import InProcessGroup
    from deepreduce_tpu_torch.comm import GradientExchanger

    kw = lattice.cell_kwargs(cell)
    kw.pop("bucket_bytes")
    points = [(0.02, 0.01)] * 3
    with pytest.raises(JConfigError) as je:
        JExchanger({"g": jnp.zeros(4096)}, JConfig(**kw), num_workers=8, bucket_points=points)
    with pytest.raises(ConfigError) as te:
        GradientExchanger({"g": (4096,)}, DeepReduceConfig(**kw), device="cpu", group=InProcessGroup(8).member(0),
                          bucket_points=points)
    assert te.value.reason_code == je.value.reason_code == "build-bucket-points-need-buckets"


def test_replay_equals_matrix_with_stated_deviations(replay):
    report, stats = replay
    diffs, used = lattice.compare_matrix(MATRIX, report)
    assert diffs == []
    assert report["violations"] == []
    assert stats["distinct_traces"] == 86 == len(MATRIX["traces"])
    assert set(used) <= set(lattice.DEVIATIONS) | set(lattice.TRIPS)
    # the ring decode's two traces, the qar legs, the hier per-leaf psums,
    # the multi-tenant ticks
    assert used == {"ring-decode": 2, "qar-packed": 15, "hier-ici-one-all-reduce": 14, "fed-mt-wire-scalars": 4}


@pytest.mark.parametrize("label", sorted(MATRIX["traces"]))
def test_trace_inventory_and_bytes_equal_matrix(replay, label):
    report, _ = replay
    meta = MATRIX["traces"][label]
    got = report["traces"][label]
    assert got["harness"] == meta["harness"]
    assert got["violations"] == []
    want_axes, want_pb, _ = lattice.jax_run_inventory(meta)
    assert got["collectives_by_axis"] == want_axes
    flat = {}
    for per in want_axes.values():
        for op, n in per.items():
            flat[op] = flat.get(op, 0) + n
    assert got["collectives"] == flat
    if want_pb is not None:
        assert got["payload_bytes"] == want_pb


def test_trace_labels_are_matrix_fingerprints(replay):
    """The port hashes the cells' kwargs as the JAX package does: its run
    labels are MATRIX.json's trace labels, and the memo strips the ctrl
    knobs."""
    report, stats = replay
    assert set(report["traces"]) == set(MATRIX["traces"])
    assert stats["cache_hits"] == 73
    for label, meta in report["traces"].items():
        assert meta["config"] == MATRIX["traces"][label]["config"]


# ---------------------------------------------------------------------- #
# loop trips, from JAX's own jaxpr
# ---------------------------------------------------------------------- #


def _trip_weighted(jaxpr, mult=1, out=None):
    """{axis: {prim: calls a run makes}} of a jaxpr: each collective eqn
    weighted by the trips of the scans around it (a fori_loop with static
    bounds lowers to a scan); a collective under a while has no static
    trip count and fails."""
    out = {} if out is None else out
    inner = getattr(jaxpr, "jaxpr", None)
    if inner is not None and hasattr(inner, "eqns"):
        jaxpr = inner
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in COLLECTIVE_PRIMS:
            for ax in eqn_axes(eqn):
                per = out.setdefault(ax, {})
                per[name] = per.get(name, 0) + mult
        m = mult * eqn.params["length"] if name == "scan" else mult
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                if name == "while":
                    assert _trip_weighted(sub) == {}, "a collective under a while loop"
                else:
                    _trip_weighted(sub, m, out)
    return out


def _jax_jaxpr(cfg, **kw):
    captured = {}

    def grab(label, fn, args, ctx, **_):
        captured["jaxpr"] = jax.make_jaxpr(fn)(*args)
        return ja.TraceRecord(label=label, violations=[], collectives={}, jaxpr_hash="")

    orig = ja.trace_and_check
    ja.trace_and_check = grab
    try:
        ja.audit_exchange("probe", cfg, **kw)
    finally:
        ja.trace_and_check = orig
    return captured["jaxpr"]


RING = [
    ("lat:26a72c62260c", {}),
    ("lat:fc7687f0444e", dict(resilience=True, payload_checksum=True, chaos_corrupt_rate=0.2)),
]


@pytest.mark.parametrize("label,knobs", RING, ids=[r[0] for r in RING])
def test_ring_trip_count_from_jax_jaxpr(label, knobs):
    """JAX's ring decode: 2 static ppermutes (one before, one inside a loop
    of W - 2 trips), W - 1 = 7 hops a run, derived from the jaxpr; the port's
    law and the port's recorder give the same."""
    meta = MATRIX["traces"][label]
    assert meta["collectives_by_axis"] == {"data": {"ppermute": 2}}
    jcfg = JConfig(memory="residual", decode_strategy="ring", **ja._FLAGSHIP, **knobs)
    weighted = _trip_weighted(_jax_jaxpr(jcfg, wire_mode="ring", with_mask=bool(knobs)))
    assert weighted == {"data": {"ppermute": ja.NUM_WORKERS - 1}}
    law, pb, applied = lattice.jax_run_inventory(meta)
    assert law == weighted and applied == ["ring-decode"]
    cfg = DeepReduceConfig(memory="residual", decode_strategy="ring", **audit._FLAGSHIP, **knobs)
    run = audit.run_flat(cfg, masks=[[True] * 8] if knobs else None, census_ranks=())
    calls = run.tapes[0][0].calls
    assert rec.counts_by_axis(calls) == weighted
    assert sum(c.nbytes for c in calls) == pb == meta["payload_bytes"]


@pytest.mark.parametrize("label", ["lat:e27587666f0b", "lat:026b98a9929b"])
def test_loop_free_traces_keep_their_static_counts(label):
    """The fused and bucketed loop decodes have no collective in a loop:
    the trip-weighted count of JAX's jaxpr is the static one."""
    meta = MATRIX["traces"][label]
    cfg = meta["config"]
    leaves = ja._BUCKET_LEAVES if cfg.get("bucket_bytes") else None
    weighted = _trip_weighted(_jax_jaxpr(JConfig(**cfg), leaves=leaves, wire_mode="allgather"))
    assert weighted == meta["collectives_by_axis"]
    assert lattice.jax_run_inventory(meta)[2] == []


# ---------------------------------------------------------------------- #
# the comparison itself
# ---------------------------------------------------------------------- #


def test_compare_catches_a_moved_cell(stages):
    moved = json.loads(json.dumps(stages))
    i = next(k for k, e in enumerate(moved["entries"]) if e.get("reason_code") == "build-buckets-vs-ring")
    j = next(k for k, e in enumerate(moved["entries"]) if e.get("reason_code") == "hier-vs-ring")
    n = moved["cells"].index(i)
    moved["cells"][n] = j
    diffs, _ = lattice.compare_matrix(MATRIX, moved, traces=False)
    assert len(diffs) == 1 and "build-buckets-vs-ring" in diffs[0] and "hier-vs-ring" in diffs[0]


def test_compare_counts_port_codes_as_deviations(stages):
    moved = json.loads(json.dumps(stages))
    moved["entries"].append({"status": "rejected", "stage": "config", "exception": "ConfigError",
                             "reason_code": "not-ported"})
    moved["cells"][0] = len(moved["entries"]) - 1
    diffs, used = lattice.compare_matrix(MATRIX, moved, traces=False)
    assert diffs == [] and used == {"port-code:not-ported": 1}


def test_compare_catches_an_inventory_change(replay):
    report, _ = replay
    moved = json.loads(json.dumps(report))
    moved["traces"]["lat:e27587666f0b"]["collectives_by_axis"] = {"data": {"all_gather": 2}}
    moved["traces"]["lat:0c57c827bff2"]["payload_bytes"] += 4
    diffs, _ = lattice.compare_matrix(MATRIX, moved)
    assert len(diffs) == 2


HIER_PER_LEAF = "lat:0d070a877a35"  # hier, dense ici, 6 leaves in 3 buckets: JAX psums each leaf


def test_deviations_apply_only_at_jax_predicted_counts(replay):
    """A stated deviation rewrites JAX's count only where it is the count
    its reason predicts; any other count stays and is reported."""
    meta = json.loads(json.dumps(MATRIX["traces"][HIER_PER_LEAF]))
    assert meta["collectives_by_axis"]["ici"] == {"psum": len(audit._BUCKET_LEAVES)}
    axes, _, applied = lattice.jax_run_inventory(meta)
    assert axes["ici"] == {"psum": 1} and applied == ["hier-ici-one-all-reduce"]
    meta["collectives_by_axis"]["ici"]["psum"] = 5
    axes, _, applied = lattice.jax_run_inventory(meta)
    assert axes["ici"] == {"psum": 5} and applied == []
    baseline = json.loads(json.dumps(MATRIX))
    baseline["traces"][HIER_PER_LEAF] = meta
    diffs, _ = lattice.compare_matrix(baseline, replay[0])
    assert len(diffs) == 1 and HIER_PER_LEAF in diffs[0]
    # fused=False: one all_gather a payload leaf in JAX, one a tensor in the port
    per_tensor = {"config": {"fused": False}, "harness": "flat", "collectives_by_axis": {"data": {"all_gather": 3}},
                  "payload_bytes": 508}
    assert lattice.jax_run_inventory(per_tensor, payload_leaves=3)[:3:2] == ({"data": {"all_gather": 1}},
                                                                            ["per-tensor-one-gather"])
    for leaves in (2, None):
        assert lattice.jax_run_inventory(per_tensor, payload_leaves=leaves)[:3:2] == ({"data": {"all_gather": 3}},
                                                                                     [])
    # qar packs 2 + 2 into 1 + 1, and nothing else
    qar = {"config": {"communicator": "qar"}, "harness": "flat",
           "collectives_by_axis": {"data": {"all_gather": 3, "all_to_all": 2}}, "payload_bytes": None}
    assert lattice.jax_run_inventory(qar)[:3:2] == ({"data": {"all_gather": 3, "all_to_all": 2}}, [])


def test_load_report_checks_the_schema(stages, tmp_path):
    bad = tmp_path / "foreign.json"
    bad.write_text('{"schema": "x"}')
    with pytest.raises(ValueError, match="schema"):
        lattice.load_report(bad)
    assert MATRIX["schema"] == lattice.SCHEMA
    assert stages["schema"] == lattice.PORT_SCHEMA


def test_cell_kwargs_are_jax_kwargs():
    """The port's copy of `cell_kwargs` gives JAX's kwargs in every cell
    (the fingerprints rest on it)."""
    from deepreduce_tpu.analysis import lattice as jl

    assert lattice.AXES == jl.AXES
    for cell in lattice.iter_cells():
        assert lattice.cell_kwargs(cell) == jl.cell_kwargs(cell), lattice.cell_slug(cell)
