"""The stage spans inside the port's exchange (`comm.py`, `wrappers.py`) and
the tracer's clock (`telemetry/spans.py`).

With the tracer on, one `Trainer.step` of the benchmark cells' knobs (top-k
with the mod bloom index and residuals, `deepreduce='index'`; DRQSGD-BF-P0,
`deepreduce='both'`) records each stage span under its parent, and the
stage spans cover nearly all of `train/exchange`. With the tracer off the
step records nothing and moves the parameters bitwise as the traced step
does. The dense exchange runs no stage. The tracer stamps its events on the
profiler's clock, and `costmodel.calibrate` fits a trace with the stage
spans as it fits the same trace without them."""

import json

import pytest
import torch

import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import costmodel, models, train
from deepreduce_tpu_torch.telemetry import spans

# each stage span and the span it nests in
PARENT = {
    "exchange/compensate": "train/exchange",
    "exchange/encode": "train/exchange",
    "exchange/encode/sparsify": "exchange/encode",
    "exchange/encode/index": "exchange/encode",
    "exchange/encode/values": "exchange/encode",
    "exchange/encode/qsgd": "exchange/encode",
    "exchange/pack": "train/exchange",
    "exchange/allgather": "train/exchange",
    "exchange/decode": "train/exchange",
    "exchange/decode/unpack": "exchange/decode",
    "exchange/decode/values": "exchange/decode",
    "exchange/decode/index": "exchange/decode",
    "exchange/decode/sparse": "exchange/decode",
    "exchange/decode/sum": "exchange/decode",
    "exchange/finish": "train/exchange",
}
# the innermost spans of the exchange: together they should hold its time
LEAVES = frozenset(PARENT) - {"exchange/encode", "exchange/decode"}
NEW = frozenset(n for n in PARENT if n.count("/") == 2) | {"exchange/compensate", "exchange/finish"}

RESNET = dict(compressor="topk", compress_ratio=0.01, memory="residual", deepreduce="index", index="bloom",
              bloom_blocked="mod", fpr=0.001)
BERT = dict(compressor="topk", compress_ratio=0.001, approx_topk=False, memory="residual", communicator="allgather",
            deepreduce="both", index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod",
            quantum_num=127, bucket_size=512)
ALL_INDEX = {"exchange/compensate", "exchange/encode", "exchange/encode/sparsify", "exchange/encode/index",
             "exchange/pack", "exchange/allgather", "exchange/decode", "exchange/decode/unpack",
             "exchange/decode/index", "exchange/decode/sparse", "exchange/decode/sum", "exchange/finish"}

# (knobs, the exchange spans a step records); the models are wide enough
# that the codecs' work, not the spans' own cost, fills the exchange
CELLS = {
    "resnet_topk_bloom": (RESNET, ALL_INDEX),
    "bert_drqsgd_bf_p0": (BERT, ALL_INDEX | {"exchange/encode/qsgd", "exchange/decode/values"}),
    "polyfit_bloom": (dict(RESNET, deepreduce="both", value="polyfit"),
                      ALL_INDEX | {"exchange/encode/values", "exchange/decode/values"}),
    "countsketch_integer": (dict(RESNET, deepreduce="both", index="integer", value="countsketch"),
                            ALL_INDEX | {"exchange/encode/values", "exchange/decode/values"}),
}


def _trainer(cell: str, knobs: dict):
    if cell.startswith("resnet"):
        model = models.ResNet20(10, 32, seed=1)
        batch = (torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(3)),
                 torch.randint(0, 10, (2,), generator=torch.Generator().manual_seed(4)))
        loss = train.classification_loss(model)
    else:
        model = models.BertEncoder(1024, 128, 1, 2, 512, 8)
        batch = (torch.randint(0, 1024, (2, 9), generator=torch.Generator().manual_seed(3)),)
        loss = train.next_token_loss(model)
    tr = port.Trainer(model, port.DeepReduceConfig(**knobs), lr=0.1, momentum=0.9, device="cpu", loss_fn=loss)
    return tr, tr.init_state(), batch


def _traced_step(tr, state, batch):
    spans.configure(enabled=True, reset=True)
    try:
        state, _, _ = tr.step(state, batch)
    finally:
        spans.configure(enabled=False)
    events = spans.get_tracer().to_chrome_trace()["traceEvents"]
    spans.configure(reset=True)
    return state, events


def _parents(events):
    """Each X event with the name of the innermost event that holds it."""
    ivs = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e["ph"] == "X"),
                 key=lambda t: (t[0], -t[1]))
    out, stack = [], []
    for a, b, name in ivs:
        while stack and stack[-1][1] <= a:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def _coverage(events) -> float:
    """The share of `train/exchange`'s time that the union of the stage
    spans covers."""
    total = sum(e["dur"] for e in events if e["name"] == "train/exchange")
    covered, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] in LEAVES):
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered / total


# the benchmark's two compressed cells: the coverage and bitwise checks
BENCH_CELLS = ["resnet_topk_bloom", "bert_drqsgd_bf_p0"]


@pytest.fixture(scope="module")
def runs():
    """cell -> (its parameters after three untraced steps, or None outside
    BENCH_CELLS; after three traced steps from the same start; the traced
    steps' events), each cell run once for the tests of this module."""
    done = {}

    def get(cell):
        if cell not in done:
            final, traced = {False: None}, []
            for on in (False, True) if cell in BENCH_CELLS else (True,):
                tr, state, batch = _trainer(cell, CELLS[cell][0])
                for _ in range(3):
                    if on:
                        state, events = _traced_step(tr, state, batch)
                        traced.append(events)
                    else:
                        state, _, _ = tr.step(state, batch)
                        assert spans.get_tracer().events == []
                final[on] = {n: p.detach().clone() for n, p in state.params.items()}
            done[cell] = (final[False], final[True], traced)
        return done[cell]

    return get


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_step_records_every_stage_under_its_parent(cell, runs):
    _, expected = CELLS[cell]
    events = runs(cell)[2][-1]  # a step after the first, whose one-time work stays out
    pairs = _parents(events)
    names = {n for n, _ in pairs}
    assert names & set(PARENT) == expected
    for name, parent in pairs:
        if name in PARENT:
            assert parent == PARENT[name], (name, parent)
    if cell in BENCH_CELLS:
        assert _coverage(events) >= 0.95


@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_the_untraced_step_records_nothing_and_moves_the_same_bits(cell, runs):
    untraced, traced, events = runs(cell)
    assert all(events)
    for n, p in untraced.items():
        assert torch.equal(p, traced[n]), n


def test_the_dense_exchange_records_no_stage():
    knobs = dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none")
    tr, state, batch = _trainer("resnet_dense", knobs)
    _, events = _traced_step(tr, state, batch)
    names = {e["name"] for e in events}
    assert "train/exchange" in names and not names & NEW


def test_the_tracer_stamps_the_profilers_clock():
    """A span's `ts` lies within 1 ms of its `record_function` range's
    Kineto start (Unix ns / 1000), once the profiler's first range has
    paid its one-time cost."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    spans.configure(enabled=True, reset=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(8):
                with spans.span(f"clock/{i}"):
                    x = x * 1.5
    finally:
        spans.configure(enabled=False)
    ours = {e["name"]: e["ts"] for e in spans.get_tracer().events}
    spans.configure(reset=True)
    kineto = {e.name(): e.start_ns() / 1e3 for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    for i in range(2, 8):
        name = f"clock/{i}"
        assert abs(ours[name] - kineto[name]) < 1e3, (name, ours[name], kineto[name])


def _run_dir(tmp_path, name: str, stages: bool, route: str):
    """A tracking run directory of five 10 ms steps: forward and backward,
    then an exchange of encode (+ pack), allgather and decode, the ring's
    decode on odd steps, with or without the stage spans inside."""
    run = tmp_path / name / "run"
    run.mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"config": {"workers": 2}}))
    (run / "summary.json").write_text(json.dumps({"telemetry": {"dcn_bytes_per_step": 3000.0}}))
    ev = []

    def x(name, ts, dur, route=None):
        ev.append({"ph": "X", "pid": 1, "tid": 1, "name": name, "ts": ts, "dur": dur,
                   **({"args": {"route": route}} if route else {})})

    for i in range(5):
        t = 1_790_000_000_000_000.0 + i * 20_000
        x("train/step", t, 10_000)
        x("train/forward_backward", t, 4_000)
        x("train/exchange", t + 4_000, 6_000)
        x("exchange/encode", t + 4_200, 2_000, route)
        x("exchange/pack", t + 6_200, 300, route)
        if i % 2:
            x("exchange/ring", t + 6_600, 3_000)
            inner = t + 6_700
        else:
            x("exchange/allgather", t + 6_600, 500, route)
            x("exchange/decode", t + 7_200, 2_500, route)
            inner = t + 7_300
        if stages:
            x("exchange/compensate", t + 4_050, 100)
            x("exchange/encode/sparsify", t + 4_300, 400)
            x("exchange/encode/index", t + 4_750, 1_200)
            x("exchange/encode/qsgd", t + 6_000, 150)
            x("exchange/decode/unpack", inner, 200)
            x("exchange/decode/values", inner + 250, 300)
            x("exchange/decode/index", inner + 600, 1_500)
            x("exchange/decode/sum", inner + 2_150, 100)
            x("exchange/finish", t + 9_800, 150)
    (run / "trace.json").write_text(json.dumps({"traceEvents": ev, "displayTimeUnit": "ms"}))
    return run


@pytest.mark.parametrize("route", [None, "fused"])
def test_calibrate_fits_the_same_profile_with_and_without_the_stages(tmp_path, route):
    with_stages = costmodel.calibrate(_run_dir(tmp_path, "a", True, route)).to_record()
    without = costmodel.calibrate(_run_dir(tmp_path, "b", False, route)).to_record()
    assert with_stages == without
    src = without["source"]
    assert src["encode_s"] > 0 and src["decode_s"] > 0 and src["wire_dcn_s"] > 0 and src["other_s"] > 0
