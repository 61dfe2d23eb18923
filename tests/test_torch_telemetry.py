"""Port parity for telemetry: the span tracer, the on-device accumulators
and their host functions, the Trainer's telemetry carry (W = 1 in process,
W = 4 over gloo ranks), FedSim's accumulators, `tracking.py`, `metrics`'
timer and payload bytes, and the telemetry CLI, against the JAX package on
the CPU with the same inputs.

Counters are float32 running sums of the same per-step terms, so they are
compared bitwise. The compression errors (`err_l2`, `err_cos`) and the
residual norm are reductions over every gradient entry, which XLA sums in
another order than torch, from gradients that already differ in their
last bits (the models' backward): within rtol ERR_RTOL."""

import dataclasses
import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from conftest import shared_mesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from deepreduce_tpu import metrics as jmetrics
from deepreduce_tpu import tracking as jtracking
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.metrics import WireStats as JWireStats
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.telemetry import __main__ as jcli
from deepreduce_tpu.telemetry import device_metrics as jdm
from deepreduce_tpu.telemetry.spans import Tracer as JTracer
from deepreduce_tpu.train import Trainer as JTrainer
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import metrics, tracking
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.telemetry import __main__ as pcli
from deepreduce_tpu_torch.telemetry import device_metrics as pdm
from deepreduce_tpu_torch.telemetry import spans
from deepreduce_tpu_torch.weights import accumulators_from_jax, params_from_jax
from test_telemetry import _decision, _fed_rows, _write_decisions, _write_fed_run, _write_run
from test_torch_fedsim import ASYNC, BASE, CHURN, JaxRun, params0
from test_torch_slice import _cfgs, _jax_flat_params, _jax_uniforms, _t, jax_trainer_state
from torch_ranks import run_telemetry_rank

REPO = pathlib.Path(__file__).resolve().parent.parent
ERR_RTOL = 1e-4


def _placed_state(jtr, batch, mesh):
    """The JAX Trainer's initial state placed as its step's outputs are,
    the residuals sharded over the workers too, so that the second step
    reuses the first step's program."""
    st = jax_trainer_state(jtr, jax.random.PRNGKey(1), batch, mesh)
    return dataclasses.replace(st, residuals=jax.device_put(st.residuals, NamedSharding(mesh, P("data"))))


def _assert_fetch(got, want, *, close=("residual_l2", "err_l2", "err_cos")):
    assert list(got) == list(want)
    for k, v in want.items():
        if k in close:
            np.testing.assert_allclose(got[k], v, rtol=ERR_RTOL, err_msg=k)
        else:
            assert got[k] == v, k


# -- spans ------------------------------------------------------------------ #


def _events(tracer_cls):
    tr = tracer_cls(enabled=True)
    with tr.span("train/step"):
        with tr.span("exchange/encode", route="fused"):
            pass
    tr.counter("rel_volume", {"v": 0.5})
    return tr.to_chrome_trace()


def test_tracers_emit_the_same_schema():
    got, want = _events(spans.Tracer), _events(JTracer)
    assert got.keys() == want.keys() and got["displayTimeUnit"] == want["displayTimeUnit"]
    assert [(e["name"], e["ph"]) for e in got["traceEvents"]] == [(e["name"], e["ph"]) for e in want["traceEvents"]]
    for a, b in zip(got["traceEvents"], want["traceEvents"]):
        assert a.keys() == b.keys()
        assert {k: type(v) for k, v in a.items()} == {k: type(v) for k, v in b.items()}
        assert a.get("args", {}).keys() == b.get("args", {}).keys()
    encode = [e for e in got["traceEvents"] if e["name"] == "exchange/encode"]
    assert encode[0]["args"] == {"route": "fused"} and encode[0]["cat"] == "telemetry"


def test_disabled_tracer_is_one_shared_inert_object(tmp_path):
    spans.configure(enabled=False, reset=True)
    assert spans.span("a") is spans.span("b", route="x") is spans.get_tracer().span("c")
    with spans.span("train/step"):
        pass
    assert spans.get_tracer().events == [] and not spans.enabled()
    spans.configure(enabled=True)
    try:
        with spans.span("train/step"):
            pass
        spans.save(tmp_path / "trace.json")
    finally:
        spans.configure(enabled=False, reset=True)
    assert [e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]] == ["train/step"]


# -- the accumulators' host functions --------------------------------------- #


def _fetch(rng, C=0, D=0, K=0):
    vals = {n: float(np.float32(rng.integers(0, 1000) * 0.5)) for n in pdm.SCALAR_FIELDS}
    vals["bucket_saturated"] = [float(x) for x in rng.integers(0, 9, C)]
    if D:
        vals["staleness_hist"] = [float(x) for x in rng.integers(0, 50, D)]
    if K:
        vals["pop_hist"] = [float(x) for x in rng.integers(0, 50, K)]
    return vals


@pytest.mark.parametrize("C,D,K", [(0, 0, 0), (3, 0, 0), (0, 4, 0), (2, 3, 2)])
def test_fetch_delta_derive_and_hist_quantile_equal_jax(C, D, K):
    rng = np.random.default_rng(C + 10 * D + 100 * K)
    prev = _fetch(rng, C, D, K)
    cur = {k: ([a + b for a, b in zip(v, prev[k])] if isinstance(v, list) else v + prev[k])
           for k, v in _fetch(rng, C, D, K).items()}
    assert pdm.fetch_delta(cur, prev) == jdm.fetch_delta(cur, prev)
    for vals in (cur, pdm.fetch_delta(cur, prev)):
        assert pdm.MetricAccumulators.derive(vals) == jdm.MetricAccumulators.derive(vals)
    for hist in ([5.0, 2.0, 1.0], [0.0, 0.0], [], [1.0], [3.0, 0.0, 7.0, 1.0]):
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert pdm.hist_quantile(hist, q) == jdm.hist_quantile(hist, q)
    with pytest.raises(ValueError, match="mismatch"):
        pdm.fetch_delta({**cur, "bucket_saturated": [0.0] * (C + 1)}, prev)


def test_accumulate_equals_jax_bitwise():
    """Five steps of random terms (wire bits, errors, the histograms)
    through both accumulators: every field's float32 sum bitwise."""
    rng = np.random.default_rng(3)
    jacc = jdm.MetricAccumulators.zeros(num_buckets=3, num_stale_levels=4, num_pop_classes=2)
    pacc = pdm.MetricAccumulators.zeros(num_buckets=3, num_stale_levels=4, num_pop_classes=2, device="cpu")
    for _ in range(5):
        f = lambda: np.float32(rng.normal() * 1e3)  # noqa: E731
        w = [f(), f(), f(), np.float32(rng.integers(0, 3)), f()]
        terms = {k: f() for k in ("residual_l2", "err_l2", "err_cos", "fp_count", "fp_universe", "rs_density",
                                  "rs_oktopk_threshold")}
        vecs = {"bucket_saturated": rng.integers(0, 2, 3).astype(np.float32),
                "staleness_hist": rng.integers(0, 9, 4).astype(np.float32),
                "pop_hist": rng.integers(0, 9, 2).astype(np.float32)}
        jacc = jacc.accumulate(JWireStats(*map(jnp.asarray, w)), live_workers=4.0, dropped_steps=0.0,
                               **{k: jnp.asarray(v) for k, v in {**terms, **vecs}.items()})
        pacc = pacc.accumulate(WireStats(*map(torch.tensor, w)), live_workers=4.0, dropped_steps=0.0,
                               **{k: torch.tensor(v) for k, v in {**terms, **vecs}.items()})
    assert pacc.fetch() == jacc.fetch()
    assert pacc.summary(prev=pacc.fetch()) == jacc.summary(prev=jacc.fetch())
    assert float(pacc.rel_volume()) == float(jacc.rel_volume())
    assert float(pacc.measured_fpr()) == float(jacc.measured_fpr())
    assert accumulators_from_jax(jax.device_get(jacc)).fetch() == jacc.fetch()


# -- the Trainer's carry ---------------------------------------------------- #


class _JMLP(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Dense(64)(x))
        x = nn.relu(nn.Dense(64)(x))
        return nn.Dense(8)(x)


def test_three_telemetry_steps_match_jax_at_w1():
    """DRQSGD-BF-P0 on the JAX check's MLP, JAX's QSGD draws injected: the
    accumulator after 3 steps (counters bitwise, errors within ERR_RTOL),
    both summaries' keys, and the same parameters."""
    from deepreduce_tpu_torch.resilience.__main__ import MLP

    knobs = dict(seed=3, min_compress_size=100, telemetry=True, telemetry_every=3)
    jcfg, tcfg = _cfgs(**knobs)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(3, 16, 32)).astype(np.float32)
    ys = rng.integers(0, 8, size=(3, 16)).astype(np.int32)
    jtr = JTrainer(_JMLP(), jcfg, optax.sgd(0.1, momentum=0.9), shared_mesh(1))
    jstate = _placed_state(jtr, (xs[0], ys[0]), shared_mesh(1))
    tmodel = MLP()
    tmodel.load_flax_params(params_from_jax(_jax_flat_params(jstate.params)))
    ttr = port.Trainer(tmodel, tcfg, lr=0.1, momentum=0.9, device="cpu")
    tstate = ttr.init_state()
    for i in range(3):
        x, y = xs[i], ys[i]
        key = jax.random.PRNGKey(100 + i)
        wkey = jax.random.fold_in(key, 0)
        uniforms = {n: _jax_uniforms(c, per_tensor_key(wkey, n, jnp.asarray(i, jnp.int32)))
                    for n, c in jtr.exchanger.codecs.items() if c.compressed}
        assert len(uniforms) == 3  # the codecs really run
        jstate, _, _ = jtr.step(jstate, (x, y), key)
        tstate, _, _ = ttr.step(tstate, (_t(x), _t(y).long()), uniforms=uniforms)
    got, want = ttr.telemetry.fetch(), jtr.telemetry.fetch()
    _assert_fetch(got, want)
    assert got["steps"] == 3.0 and got["fp_universe"] > 0 and 0.0 < got["err_cos"] < 3.0
    tsum, jsum = ttr.telemetry_summary(), jtr.telemetry_summary()
    assert list(tsum) == list(jsum)
    assert tsum["rel_volume"] == jsum["rel_volume"]
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_three_telemetry_steps_over_four_gloo_ranks_match_jax(tmp_path):
    """The bloom index at top-k 0.05 (no stochastic codec) on the JAX
    check's MLP: four gloo ranks against the JAX Trainer on a 4-device
    mesh, each rank's accumulator the same, and JAX's."""
    world, steps, shard = 4, 3, 8
    knobs = dict(deepreduce="index", index="bloom", compress_ratio=0.05, fpr=0.01, memory="residual",
                 min_compress_size=100, telemetry=True, telemetry_every=3)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(steps, world * shard, 32)).astype(np.float32)
    ys = rng.integers(0, 8, size=(steps, world * shard)).astype(np.int32)
    jtr = JTrainer(_JMLP(), JConfig(**knobs), optax.sgd(0.1, momentum=0.9), shared_mesh(world))
    jstate = _placed_state(jtr, (xs[0], ys[0]), shared_mesh(world))
    params = params_from_jax(_jax_flat_params(jstate.params))
    for i in range(steps):
        jstate, _, _ = jtr.step(jstate, (xs[i], ys[i]), jax.random.PRNGKey(i))
    batches = [[(_t(xs[i, r * shard:(r + 1) * shard]), _t(ys[i, r * shard:(r + 1) * shard]).long())
                for r in range(world)] for i in range(steps)]
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=run_telemetry_rank, args=(r, world, store, outs[r], knobs, params, batches))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120)
        assert not [p.pid for p in procs if p.is_alive()], "ranks still running after 120 s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * world
    got = [torch.load(o) for o in outs]
    for r in range(1, world):
        assert got[r]["fetch"] == got[0]["fetch"]
    want = jtr.telemetry.fetch()
    _assert_fetch(got[0]["fetch"], want)
    assert want["live_workers"] == 3.0 * world and want["fp_universe"] > 0
    jflat = _jax_flat_params(jstate.params)
    for n, p in got[0]["params"].items():
        np.testing.assert_allclose(p.numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_telemetry_off_runs_the_same_step():
    """Telemetry only reads: the parameters after three steps are bitwise
    those of the telemetry-off run, which keeps no accumulator and records
    no span."""
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, 64, size=(3, 4, 6)))
    final = {}
    for tele in (False, True):
        tr = port.Trainer(WordLSTM(64, 8, 16, seed=2), port.DeepReduceConfig(
            compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd", fpr=0.02, policy="p0",
            min_compress_size=100, telemetry=tele), lr=0.1, momentum=0.9, device="cpu")
        st = tr.init_state()
        for i in range(3):
            st, _, _ = tr.step(st, (tok[i, :, :-1], tok[i, :, 1:]))
        final[tele] = {n: p.detach().clone() for n, p in st.params.items()}
        assert (tr.telemetry is None) != tele and (tr.telemetry_summary() == {}) != tele
    assert spans.get_tracer().events == []
    for n, p in final[False].items():
        assert torch.equal(p, final[True][n]), n


# -- FedSim ------------------------------------------------------------------ #


@pytest.mark.parametrize("knobs", [{**BASE, **CHURN}, {**BASE, **CHURN, **ASYNC}], ids=["sync", "async"])
def test_fedsim_accumulators_match_jax_given_its_draws(knobs):
    """Two rounds (ticks) of churn and chaos under checksums: the
    accumulator bitwise JAX's, the summary's telemetry rows equal, and
    the JAX state's accumulator carried across by `weights`."""
    run = JaxRun({**knobs, "telemetry": True}, 2)
    ps = run.sim()
    st = ps.init(params0())
    for r in range(run.rounds):
        st, _ = ps.step(st, r)
    jacc = run.states[-1].telemetry
    assert st.telemetry.fetch() == jacc.fetch()
    got, want = ps.summary(st), run.js.summary(run.states[-1])
    keys = set(jdm.MetricAccumulators.derive(jacc.fetch())) | {"uplink_bytes_per_round"}
    assert keys <= set(got) and keys <= set(want)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    from deepreduce_tpu_torch.weights import fedsim_state_from_jax

    assert fedsim_state_from_jax(run.states[-1]).telemetry.fetch() == jacc.fetch()


# -- tracking and metrics --------------------------------------------------- #


def test_tracking_runs_write_what_jax_writes(tmp_path):
    rec = {"loss": np.float32(1.5), "t": torch.tensor([1.0, float("nan")]), "inf": float("inf"), "step": 3}
    for mod, name in ((tracking, "port"), (jtracking, "jax")):
        with mod.Run(str(tmp_path), name=name, config={"a": 1, "b": [1, 2]}, tags=["x"]) as run:
            run.log({k: (v.numpy() if torch.is_tensor(v) else v) for k, v in rec.items()}, step=0)
            run.log({"loss": 2.0})
        run.finish({"final": float("nan")})
    assert tracking.runs(str(tmp_path)) == jtracking.runs(str(tmp_path)) == ["jax", "port"]
    assert tracking._jsonable(rec) == jtracking._jsonable({k: (v.numpy() if torch.is_tensor(v) else v)
                                                           for k, v in rec.items()})
    assert tracking.config(str(tmp_path), "port")["config"] == jtracking.config(str(tmp_path), "jax")["config"]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"} for r in rows]  # noqa: E731
    assert strip(tracking.history(str(tmp_path), "port")) == strip(jtracking.history(str(tmp_path), "jax"))
    assert tracking.summary(str(tmp_path), "port") == jtracking.summary(str(tmp_path), "jax") == {"final": None}


def test_timed_and_payload_device_bytes(capsys):
    for mod in (metrics, jmetrics):
        sink = {}
        with pytest.raises(RuntimeError):
            with mod.timed("enc", sink=sink):
                raise RuntimeError("boom")
        assert sink["enc"] > 0.0
        with mod.timed("dec", enabled=False):
            pass
        with mod.timed("dec"):
            pass
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["dec time", "dec time"]
    cfg = port.DeepReduceConfig(compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd", fpr=0.02,
                                policy="p0", min_compress_size=100)
    codec = port.TensorCodec((5000,), cfg, device="cpu")
    from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec

    jcodec = JTensorCodec((5000,), JConfig(**cfg.__dict__))
    g = np.random.default_rng(8).normal(size=5000).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jcodec.encode(x, key=jax.random.PRNGKey(0)),
                            jax.ShapeDtypeStruct((5000,), jnp.float32))
    assert metrics.payload_device_bytes(codec.encode(_t(g))) == jmetrics.payload_device_bytes(shapes)


# -- the CLI ---------------------------------------------------------------- #


def _both(argv):
    outs = []
    for main in (pcli.main, jcli.main):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = main(list(argv))
        outs.append((rc, out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1], argv
    return outs[0]


def test_cli_prints_what_the_jax_cli_prints(tmp_path):
    """summary, compare (two runs, --ctrl, a bench record), trace (spans,
    counters, the ctrl tracks, --overlap), calibrate, profiles and slo
    over the same run directories: the same exit codes and bytes."""
    golden = str(REPO / "TRACE_OVERLAP_r15")
    fast = _write_run(tmp_path, "fast", dt=0.1, telemetry={"steps": 5.0, "rel_volume": 0.08})
    slow = _write_run(tmp_path, "slow", dt=0.5)
    adaptive = _write_run(tmp_path, "adaptive", n=12, telemetry={"steps": 12.0})
    _write_decisions(adaptive, [
        _decision(5, switched=True, old_index=2, new_index=1, old_ratio=0.08, new_ratio=0.03,
                  trigger="err_cos_headroom", rationale="move_down"),
        _decision(10, switched=False, old_index=1, new_index=1, old_ratio=0.03, new_ratio=0.03,
                  trigger="in_band", rationale="hold_in_band")])
    fed = _write_fed_run(tmp_path, "fed", rows=_fed_rows())
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"window_ticks": 1, "fast_window_ticks": 1, "slow_window_ticks": 1,
                                "hysteresis_ticks": 1, "targets": {"staleness_p95_max": 0.5}}))
    g, s = tmp_path / "golden.json", tmp_path / "static.json"
    from deepreduce_tpu_torch import costmodel

    costmodel.calibrate(golden).save(g)
    costmodel.static_profile().save(s)
    bench = str(REPO / "BENCH_CALIB_r16.json")
    rcs = [_both(argv)[0] for argv in (
        ["summary", golden], ["summary", str(fast), "--json"], ["summary", str(adaptive)], ["summary", str(fed)],
        ["compare", str(fast), str(slow)], ["compare", str(adaptive), str(slow), "--ctrl"],
        ["compare", str(fast), "--against", str(REPO / "BENCH_DECODE_r06.json")],
        ["trace", golden], ["trace", str(adaptive)], ["trace", golden, "--overlap"],
        ["calibrate", golden], ["profiles", str(g), str(s), "--against", bench],
        ["slo", str(fed), "--spec", str(spec)], ["slo", str(fed), "--spec", str(REPO / "slo.json")],
    )]
    assert 1 in rcs and 0 in rcs
