"""The port's analysis gate: the shipped package audits clean (AST lint,
every traced label with a port counterpart), each label's run inventory
equals the JAX package's ANALYSIS.json (read as data) with the loop trips and
stated deviations applied, and each rule catches its hazard, planted in a
real run, with exactly one violation carrying the rule's id."""

import json
import os
import subprocess
import sys

import pytest
import torch

from deepreduce_tpu.analysis.rules import ALL_RULE_IDS as JAX_RULE_IDS
from deepreduce_tpu.analysis.ast_lint import R_AST_BRANCH as JAX_AST_BRANCH
from deepreduce_tpu_torch import comm as comm_mod
from deepreduce_tpu_torch.analysis import __main__ as cli
from deepreduce_tpu_torch.analysis import ast_lint, audit, census, lattice, rules
from deepreduce_tpu_torch.analysis import recorder as rec
from deepreduce_tpu_torch.analysis.ast_lint import lint_repo, lint_source
from deepreduce_tpu_torch.analysis.rules import AuditContext
from deepreduce_tpu_torch.config import DeepReduceConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS = lattice.load_report(os.path.join(REPO, "ANALYSIS.json"))
FLAGSHIP = dict(memory="residual", decode_strategy="loop", **audit._FLAGSHIP)
BUCKETED = dict(FLAGSHIP, bucket_bytes=audit._BUCKET_BYTES)


def _only(violations, rule):
    """Exactly one violation, carrying `rule`."""
    assert len(violations) == 1, [v.to_dict() for v in violations]
    assert violations[0].rule == rule
    return violations[0]


@pytest.fixture(scope="module")
def full_audit():
    records, violations = audit.audit_all()
    return {r.label: r for r in records}, violations


# ---------------------------------------------------------------------- #
# the shipped package is clean and agrees with ANALYSIS.json
# ---------------------------------------------------------------------- #


def test_repo_ast_lint_clean():
    assert lint_repo() == []


def test_full_audit_clean(full_audit):
    records, violations = full_audit
    assert violations == [], [v.to_dict() for v in violations]
    jax_labels = {t["label"] for t in ANALYSIS["jaxpr_audit"]["traces"]}
    assert set(records) == jax_labels - set(audit.NOT_PORTED)
    assert len(records) == 76


def test_full_audit_matches_analysis_json(full_audit):
    records, _ = full_audit
    diffs, used = lattice.compare_analysis(ANALYSIS, list(records.values()))
    assert diffs == []
    assert used == {"ring-decode": 1, "per-tensor-one-gather": 1, "qar-packed": 2, "hier-ici-one-all-reduce": 1,
                    "fed-mt-wire-scalars": 2}


LABELS = sorted(t["label"] for t in ANALYSIS["jaxpr_audit"]["traces"] if t["label"] not in audit.NOT_PORTED)


@pytest.mark.parametrize("label", LABELS)
def test_label_inventory_equals_jax(full_audit, label):
    """Each fixed label: no violation, and its collectives (by axis) and wire
    bytes are JAX's, loop trips and stated deviations applied; a codec unit
    makes no collective."""
    records, _ = full_audit
    r = records[label]
    assert r.violations == []
    jax = next(t for t in ANALYSIS["jaxpr_audit"]["traces"] if t["label"] == label)
    if r.config is None:
        assert r.collectives == jax["collectives"]
        return
    diffs, _ = lattice.compare_analysis(ANALYSIS, [r])
    assert diffs == []


def test_codec_counts_and_laws(full_audit):
    records, _ = full_audit
    assert records["exchange:fused-loop"].selections == 1
    assert records["exchange:bucketed-loop"].selections == 3  # O(buckets) for 6 leaves
    assert records["exchange:streaming"].selections == 3
    assert records["fedsim:round"].selections == 2
    assert records["fedsim:multi-tenant-T2"].selections == 4  # a tenant's 2 in turn
    assert records["exchange:fused-ring"].collectives == {"ppermute": 7}
    assert records["fedsim:multi-tenant-T4"].payload_bytes == 8320 + 4 * 3 * 4
    assert records["hier:fused-loop"].collectives_by_axis == {
        "dcn": {"all_gather": 1}, "ici": {"psum": 1}}


def test_analysis_package_imports_no_jax():
    code = ("import sys, deepreduce_tpu_torch.analysis, deepreduce_tpu_torch.analysis.__main__,"
            " deepreduce_tpu_torch.analysis.audit, deepreduce_tpu_torch.analysis.lattice,"
            " deepreduce_tpu_torch.analysis.memory, deepreduce_tpu_torch.analysis.ast_lint;"
            " bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'deepreduce_tpu')];"
            " assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


# ---------------------------------------------------------------------- #
# each rule catches its hazard, planted in a real run
# ---------------------------------------------------------------------- #


def _fused_run(**kw):
    return audit.run_flat(DeepReduceConfig(**FLAGSHIP), census_ranks=(0,), **kw)


def test_two_collective_fused_exchange_caught(monkeypatch):
    gather = comm_mod.GradientExchanger.gather

    def twice(self, buf):
        self.coll.all_gather(buf)
        return gather(self, buf)

    monkeypatch.setattr(comm_mod.GradientExchanger, "gather", twice)
    run = _fused_run()
    ctx = AuditContext(label="fused", expect_collectives={"all_gather": 1})
    v = _only(audit.check_trace(ctx, run).violations, rules.R_COLLECTIVE_COUNT)
    assert "all_gather: want 1, got 2" in v.detail


def test_per_axis_collective_inventory_caught():
    run = audit.run_hier(DeepReduceConfig(hier=True, **FLAGSHIP), census_ranks=())
    ok = AuditContext(label="hier", expect_collectives_by_axis={"ici": {"psum": 1}, "dcn": {"all_gather": 1}})
    assert audit.check_trace(ok, run, census_ranks=()).violations == []
    # a contract that names only the dcn leg: the ici psum rides an axis it
    # does not mention
    bad = AuditContext(label="hier", expect_collectives_by_axis={"dcn": {"all_gather": 1}})
    v = _only(audit.check_trace(bad, run, census_ranks=()).violations, rules.R_COLLECTIVE_COUNT)
    assert "'ici'" in v.detail


def test_wire_accounting_mismatch_caught():
    run = _fused_run()
    assert run.payload_bytes == 508
    ctx = AuditContext(label="fused", wire_mode="allgather", expected_wire_bytes=run.payload_bytes + 4)
    v = _only(audit.check_trace(ctx, run).violations, rules.R_WIRE_ACCOUNTING)
    assert "508" in v.detail and "512" in v.detail


def test_wire_accounting_collective_and_ring_modes():
    cfg = DeepReduceConfig(communicator="sparse_rs", compressor="topk", memory="none", deepreduce=None,
                           compress_ratio=0.02, rs_mode="quantized")
    run = audit.run_flat(cfg, census_ranks=())
    ok = AuditContext(label="rs", wire_mode="collective", expected_wire_bytes=run.payload_bytes)
    assert audit.check_trace(ok, run, census_ranks=()).violations == []
    bad = AuditContext(label="rs", wire_mode="collective", expected_wire_bytes=run.payload_bytes - 1)
    _only(audit.check_trace(bad, run, census_ranks=()).violations, rules.R_WIRE_ACCOUNTING)
    ring = audit.run_flat(DeepReduceConfig(**dict(FLAGSHIP, decode_strategy="ring")), census_ranks=())
    ok = AuditContext(label="ring", wire_mode="ring", expected_wire_bytes=ring.payload_bytes)
    assert audit.check_trace(ok, ring, census_ranks=()).violations == []
    short = AuditContext(label="ring", wire_mode="ring", expected_wire_bytes=ring.payload_bytes, num_workers=7)
    _only(audit.check_trace(short, ring, census_ranks=()).violations, rules.R_WIRE_ACCOUNTING)


def test_codec_invocation_count_caught():
    run = audit.run_flat(DeepReduceConfig(**BUCKETED), leaves=audit._BUCKET_LEAVES, census_ranks=(0,))
    ctx = AuditContext(label="bucketed", expect_codec_invocations=len(audit._BUCKET_LEAVES))
    v = _only(audit.check_trace(ctx, run).violations, rules.R_CODEC_COUNT)
    assert v.detail.startswith("3 selection(s)")


def test_f64_outside_the_sites_caught(monkeypatch):
    finish = comm_mod.GradientExchanger.finish

    def widened(self, grads, compensated, mean, own):
        mean = {n: m.double().float() for n, m in mean.items()}
        return finish(self, grads, compensated, mean, own)

    monkeypatch.setattr(comm_mod.GradientExchanger, "finish", widened)
    v = _only(audit.check_trace(AuditContext(label="fused"), _fused_run()).violations, rules.R_F64)
    assert "comm.py" in v.detail


def test_dtype_flow_caught(monkeypatch):
    finish = comm_mod.GradientExchanger.finish

    def f64_out(self, *args):
        agg, res = finish(self, *args)
        return {n: a.double() for n, a in agg.items()}, res

    monkeypatch.setattr(comm_mod.GradientExchanger, "finish", f64_out)
    run = _fused_run()
    found = audit.check_trace(AuditContext(label="fused"), run).violations
    assert {v.rule for v in found} == {rules.R_F64, rules.R_DTYPE_FLOW}
    _only([v for v in found if v.rule == rules.R_DTYPE_FLOW], rules.R_DTYPE_FLOW)


def test_host_read_outside_host_codecs_caught(monkeypatch):
    decode = comm_mod.FusedBuffer.decode_sum

    def reads(self, *args, **kw):
        total, own = decode(self, *args, **kw)
        if float(total.abs().max()) < 0:  # a value read on the host: a sync on the card
            total = -total
        return total, own

    monkeypatch.setattr(comm_mod.FusedBuffer, "decode_sum", reads)
    v = _only(audit.check_trace(AuditContext(label="fused"), _fused_run()).violations, rules.R_CALLBACK)
    assert "_local_scalar_dense" in v.detail and "comm.py" in v.detail
    # a host codec may read on the host
    allowed = AuditContext(label="fused", allow_host_syncs=True)
    assert audit.check_trace(allowed, _fused_run()).violations == []


SYNC = "called a synchronizing CUDA operation"  # torch's sync debug mode's warning


def _as_if_in(path: str, src: str, **names):
    """The function `src` defines, compiled as the code of the file `path`:
    its frames lie there, as a planted line of that module's would."""
    ns = dict(names)
    exec(compile(src, path, "exec"), ns)
    return ns["planted"]


@pytest.mark.parametrize("where,kept,caught", [
    ("comm.py", True, True),  # the exchange itself
    ("codecs/host.py", True, False),  # a listed host-codec site
    ("analysis/audit.py", False, False),  # the harness's own
    (None, False, False),  # a caller's outside the package
])
def test_host_sync_on_the_card_caught_by_its_site(monkeypatch, where, kept, caught):
    """`census.SyncWatch` counts the syncs the sync debug mode warns about
    (off the card, the warning is planted and the mode stubbed): the
    package's are kept, the harness's and a caller's are not; one made in
    the exchange is a `jx-callback` violation, one in a host codec is not."""
    import warnings

    monkeypatch.setattr(census, "watches_syncs", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    path = __file__ if where is None else os.path.join(census.PACKAGE_DIR, where)
    planted = _as_if_in(path, "def planted(self, *args, **kw):\n"
                              "    warnings.warn(SYNC)\n"
                              "    return decode_sum(self, *args, **kw)\n",
                        warnings=warnings, SYNC=SYNC, decode_sum=comm_mod.FusedBuffer.decode_sum)
    monkeypatch.setattr(comm_mod.FusedBuffer, "decode_sum", planted)
    run = _fused_run()
    record = audit.check_trace(AuditContext(label="fused"), run)
    assert record.extra["card_syncs"] == (audit.NUM_WORKERS if kept else 0)
    if caught:
        v = _only(record.violations, rules.R_CALLBACK)
        assert "on the card" in v.detail and "comm.py" in v.detail
    else:
        assert record.violations == []


def test_host_syncs_are_not_counted_off_the_card():
    record = audit.check_trace(AuditContext(label="fused"), _fused_run())
    assert record.extra["card_syncs"] is None and record.violations == []


def test_gather_in_mod_query_caught():
    from deepreduce_tpu_torch.codecs import bloom

    (clean,) = audit.audit_mod_query()
    assert clean.violations == []
    meta = bloom.BloomMeta.create(163, 8192, policy="leftmost", blocked="hash")
    words = torch.zeros(meta.m_bits // 32, dtype=torch.int32)
    tape = rec.Tape()
    with census.Census(tape):
        bloom.query_universe(words, meta)
    ctx = AuditContext(label="query:bloom-hash", forbid_gather=True)
    _only(audit.check_ops(ctx, census.ops_of(tape)), rules.R_GATHER_IN_MOD_QUERY)


def test_retrace_and_dynamic_shape_caught(monkeypatch):
    finish = comm_mod.GradientExchanger.finish

    def drifting(self, grads, compensated, mean, own, *, _calls=[0]):
        _calls[0] += 1
        if _calls[0] > 8:  # after every worker's first step: a zeros whose size grows each call
            torch.zeros(_calls[0])
        return finish(self, grads, compensated, mean, own)

    monkeypatch.setattr(comm_mod.GradientExchanger, "finish", drifting)
    run = _fused_run(steps=audit.AUDIT_STEPS)
    _only(audit._across_steps(AuditContext(label="fused"), run, (0,)), rules.R_DYNAMIC_SHAPE)

    def extra_op(self, grads, compensated, mean, own, *, _calls=[0]):
        _calls[0] += 1
        if _calls[0] % 2:
            torch.zeros(1).add_(1)
        return finish(self, grads, compensated, mean, own)

    monkeypatch.setattr(comm_mod.GradientExchanger, "finish", extra_op)
    run = audit.run_flat(DeepReduceConfig(**FLAGSHIP), steps=audit.AUDIT_STEPS, census_ranks=(0,), W=1)
    _only(audit._across_steps(AuditContext(label="fused"), run, (0,)), rules.R_RETRACE)


def test_clean_steps_agree():
    run = _fused_run(steps=audit.AUDIT_STEPS)
    assert audit._across_steps(AuditContext(label="fused"), run, (0,)) == []


def test_collective_under_a_host_branch_on_values_caught(monkeypatch):
    """A collective that runs only when the gradient's values say so (one
    worker: a lockstep group would wait forever for the others): the
    collective sequence of step 4 differs from step 3's."""
    first = [float(audit._values((4096,), step * 131, "cpu")[0]) for step in (audit.STEP, audit.STEP + 1)]
    threshold = sum(first) / 2
    exchange = comm_mod.GradientExchanger.exchange

    def value_branch(self, grads, residuals, *, step, **kw):
        if float(grads["g"][0]) > threshold:
            self.coll.all_reduce_sum(torch.zeros(1))
        return exchange(self, grads, residuals, step=step, **kw)

    monkeypatch.setattr(comm_mod.GradientExchanger, "exchange", value_branch)
    run = audit.run_flat(DeepReduceConfig(**FLAGSHIP), steps=audit.AUDIT_STEPS, census_ranks=(), W=1)
    v = _only(audit._across_steps(AuditContext(label="fused"), run, ()), rules.R_COLLECTIVE_SCHEDULE)
    assert "collective sequence" in v.detail


def test_token_dominance_caught_and_clean():
    cfg = DeepReduceConfig(stream_exchange=True, **BUCKETED)
    run = audit.run_stream(cfg, census_ranks=(0,))
    events = run.tapes[0][0].events
    assert audit._token_dominance("stream", events, 3) == []
    marks = [item for kind, item in events if kind == "mark"]
    assert marks[:3] == ["enc 0", "enc 1", "enc 2"] and marks[3:] == ["dec 0", "dec 1", "dec 2"]
    # a decode that reads its bucket before the gather was started
    i_dec = next(i for i, (k, item) in enumerate(events) if item == "dec 1")
    i_gather = [i for i, (k, item) in enumerate(events) if k == "coll"][1]
    broken = list(events)
    broken.insert(i_gather, broken.pop(i_dec))
    _only(audit._token_dominance("stream", broken, 3), rules.R_TOKEN_DOMINANCE)
    # the dispatcher thread's encodes were recorded by the census's fork
    assert census.selections(census.ops_of(run.tapes[0][0])) == 3


def _patch_streams(monkeypatch, make):
    """Every module's `per_tensor_stream` replaced by `make(original)`."""
    import sys

    from deepreduce_tpu_torch import sparse

    orig = sparse.per_tensor_stream
    fake = make(orig)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("deepreduce_tpu_torch") and getattr(
                mod, "per_tensor_stream", None) is orig:
            monkeypatch.setattr(mod, "per_tensor_stream", fake)


QAR = dict(communicator="qar", compressor="none", memory="none", deepreduce=None)


def test_key_lineage_clean_and_reused_stream_caught(monkeypatch):
    steps = audit.AUDIT_STEPS
    run = audit.run_flat(DeepReduceConfig(**QAR), steps=steps, census_ranks=())
    assert run.draws and audit.key_lineage_violations("qar", run.draws, list(steps)) == []
    # both phases' streams under one name
    _patch_streams(monkeypatch, lambda orig: lambda seed, name, step, worker: orig(seed, "one", step, worker))
    run = audit.run_flat(DeepReduceConfig(**QAR), steps=steps, census_ranks=())
    v = _only(audit.key_lineage_violations("qar", run.draws, list(steps)), rules.R_KEY_LINEAGE)
    assert "share the stream" in v.detail


def test_key_lineage_step_blind_stream_caught(monkeypatch):
    _patch_streams(monkeypatch, lambda orig: lambda seed, name, step, worker: orig(seed, name, 0, worker))
    run = audit.run_flat(DeepReduceConfig(**QAR), steps=audit.AUDIT_STEPS, census_ranks=())
    v = _only(audit.key_lineage_violations("qar", run.draws, list(audit.AUDIT_STEPS)), rules.R_KEY_LINEAGE)
    assert "same stream at steps" in v.detail


def test_resilience_off_identical_caught(monkeypatch):
    from deepreduce_tpu_torch.resilience import faults

    (clean,) = audit.audit_resilience_off()
    assert clean.violations == []
    exchange = comm_mod.GradientExchanger.exchange

    def seam_residue(self, grads, residuals, *, step, **kw):
        faults.participation_mask(self.num_workers, step, drop_rate=0.1, device="cpu")  # a mask left in the off program
        return exchange(self, grads, residuals, step=step, **kw)

    monkeypatch.setattr(comm_mod.GradientExchanger, "exchange", seam_residue)
    (rec_,) = audit.audit_resilience_off()
    _only(rec_.violations, rules.R_RESILIENCE_OFF)


def test_ctrl_ladder_collision_caught(monkeypatch):
    from deepreduce_tpu_torch.controller.ladder import Ladder

    apply = Ladder.apply
    monkeypatch.setattr(Ladder, "apply", lambda self, cfg, i: apply(self, cfg, 0))  # every rung is rung 0
    records = audit.audit_ctrl_ladder()
    v = _only([v for r in records for v in r.violations], rules.R_CTRL_LADDER)
    assert v.where == "ctrl:ladder-cardinality"


def test_calib_reselect_flip_caught(monkeypatch):
    from deepreduce_tpu_torch import costmodel

    select = costmodel.select_rs_mode

    def biased(*args, profile=None, **kw):
        pick = select(*args, profile=profile, **kw)
        return "sketch" if profile is not None and pick != "sketch" else pick

    monkeypatch.setattr(costmodel, "select_rs_mode", biased)
    records = audit.audit_calib_reselect()
    found = [v for r in records for v in r.violations]
    assert found and {v.rule for v in found} == {rules.R_CALIB_RESELECT}
    assert any(v.where == "calib:program-identity" for v in found)


def test_rule_table_covers_every_jax_rule():
    assert rules.ALL_RULE_IDS == JAX_RULE_IDS
    assert set(rules.RULE_DESCRIPTIONS) == set(rules.ALL_RULE_IDS) == set(rules.PORT_STATUS)
    assert rules.PORT_STATUS[rules.R_DONATION][0] == rules.NOT_APPLICABLE
    assert rules.PORT_STATUS[rules.R_PEAK_BYTES][0] == rules.REPORT
    assert JAX_AST_BRANCH in ast_lint.ALL_AST_RULES


# ---------------------------------------------------------------------- #
# the AST rules
# ---------------------------------------------------------------------- #

CODEC = "deepreduce_tpu_torch/codecs/fake.py"


@pytest.mark.parametrize("src,path,rule", [
    ("import jax.numpy as jnp\n", "deepreduce_tpu_torch/newmod.py", ast_lint.R_AST_COMPAT),
    ("from deepreduce_tpu.codecs import bloom\n", "deepreduce_tpu_torch/newmod.py", ast_lint.R_AST_COMPAT),
    ("import numpy as np\ndef f(x):\n    return x + np.random.normal(size=3)\n", CODEC, ast_lint.R_AST_ENTROPY),
    ("import time\ndef f(x):\n    return x * time.time()\n", "deepreduce_tpu_torch/sparse.py",
     ast_lint.R_AST_ENTROPY),
    ("import torch\ndef f(x):\n    return x + torch.rand(3)\n", "deepreduce_tpu_torch/comm.py",
     ast_lint.R_AST_ENTROPY),
    ("def f(x):\n    return x.uniform_(0, 1)\n", "deepreduce_tpu_torch/qar.py", ast_lint.R_AST_ENTROPY),
    ("import torch\ndef f(x):\n    if torch.max(x) > 0:\n        return x\n    return -x\n", CODEC,
     ast_lint.R_AST_BRANCH),
    ("def f(x):\n    while x.any():\n        x = x - 1\n", CODEC, ast_lint.R_AST_BRANCH),
    ("from deepreduce_tpu_torch.telemetry import spans\ndef f(x):\n    with spans.span('e'):\n        return x\n",
     CODEC, ast_lint.R_AST_SPAN),
    ("def f(p):\n    DumpLogger('d').write(p)\n", CODEC, ast_lint.R_AST_SPAN),
    ("def f(x, mask):\n    if mask[0]:\n        return x\n", "deepreduce_tpu_torch/comm.py", ast_lint.R_AST_MASK),
    ("def f(x, row_weights):\n    while row_weights.sum() > 0:\n        pass\n", "deepreduce_tpu_torch/train.py",
     ast_lint.R_AST_MASK),
], ids=["jax-import", "jax-package-import", "np-random", "time", "torch-rand", "uniform_", "branch-torch",
        "branch-any", "span", "dump-logger", "mask-if", "mask-while"])
def test_ast_catches(src, path, rule):
    _only(lint_source(src, path), rule)


@pytest.mark.parametrize("src,path", [
    # the same sources where the rules do not reach
    ("import torch\ndef f(x):\n    if torch.max(x) > 0:\n        return x\n", "deepreduce_tpu_torch/comm.py"),
    ("from deepreduce_tpu_torch.telemetry import spans\ndef f(x):\n    with spans.span('e'):\n        return x\n",
     "deepreduce_tpu_torch/comm.py"),
    ("import time\ndef f():\n    return time.time()\n", "deepreduce_tpu_torch/driver.py"),
    ("import jax\n", "tests/test_x.py"),
    # presence gates, static reads and seeded draws
    ("def f(x, mask):\n    if mask is not None and len(mask) > 1:\n        return x\n", "deepreduce_tpu_torch/comm.py"),
    ("import torch\ndef f(g):\n    return torch.rand(3, generator=g)\n", "deepreduce_tpu_torch/comm.py"),
    ("import torch\ndef f(x, device):\n    if torch.device(device).type != 'cpu':\n        return x\n", CODEC),
    ("def f(x):\n    span = 3.0\n    return x * span\n", CODEC),
], ids=["branch-outside-codecs", "span-in-comm", "time-in-driver", "jax-in-tests", "mask-presence",
        "seeded-draw", "torch-device", "local-named-span"])
def test_ast_rules_scope_correctly(src, path):
    assert lint_source(src, path) == []


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #


def test_cli_list_covers_every_rule_once(capsys):
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    for rule in JAX_RULE_IDS + ast_lint.ALL_AST_RULES:
        assert sum(line.split()[:1] == [rule] for line in out.splitlines()) == 1, rule
    assert "not applicable" in out and "jx-donation-soundness" in out
    for name in lattice.DEVIATIONS:
        assert name in out


def test_cli_quick_audit_exit_codes(monkeypatch, capsys, tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["audit", "--quick", "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["audit"]["violations"] == [] and len(report["audit"]["traces"]) == 7
    assert "0 lint + 0 audit violations" in capsys.readouterr().out
    # a planted violation: the fused exchange gathers twice
    gather = comm_mod.GradientExchanger.gather

    def twice(self, buf):
        self.coll.all_gather(buf)
        return gather(self, buf)

    monkeypatch.setattr(comm_mod.GradientExchanger, "gather", twice)
    monkeypatch.setattr(audit, "audit_specs", lambda quick=False, device="cpu", steps=audit.AUDIT_STEPS: [
        spec for spec in AUDIT_SPECS(quick=True, device=device, steps=steps) if spec[0] == "exchange:fused-loop"])
    assert cli.main(["audit", "--quick", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "[jx-collective-count]" in err and "[jx-wire-accounting]" in err
    assert cli.main(["audit", "--quick", "--device", "cpu", "--only", "jx-f64"]) == 0


AUDIT_SPECS = audit.audit_specs


def test_cli_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["audit", "--only", "jx-nonsense", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["matrix", "--out", os.path.join(REPO, "MATRIX.json")])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        assert cli.main(["audit", "--quick"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_cli_matrix(tmp_path, capsys):
    out = tmp_path / "matrix.json"
    assert cli.main(["matrix", "--device", "cpu", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "0 differences" in printed and "86 distinct traces run" in printed
    report = json.loads(out.read_text())
    assert report["summary"]["legal"] == 108 and report["comparison"]["differences"] == []


def test_mem_needs_the_card():
    from deepreduce_tpu_torch.analysis import memory

    with pytest.raises(ValueError, match="card"):
        memory.measure("exchange:fused-loop", "cpu")
    assert memory.MEM_LABELS == ("exchange:fused-loop", "exchange:bucketed-loop", "exchange:streaming",
                                 "fedsim:round")
