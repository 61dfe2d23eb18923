"""Port parity for the self-calibrating cost model: `costmodel.calibrate`
and its span tables against the JAX package's on the committed
TRACE_OVERLAP_r15 run and on runs with planted parameters, and the
Trainer's `apply_profile` contracts (a profile that agrees with the static
constants is a no-op; exchangers built == plans visited; rejected under
the controller). Host arithmetic throughout: records compared with `==`."""

import json
import pathlib

import pytest
import torch

from deepreduce_tpu import costmodel as jcostmodel
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import costmodel
from deepreduce_tpu_torch.models import WordLSTM
from test_calibrate import _plant_routed_run, _plant_run

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "TRACE_OVERLAP_r15"


def test_golden_fit_equals_jax():
    prof = costmodel.calibrate(GOLDEN)
    want = jcostmodel.calibrate(GOLDEN)
    assert prof.to_record() == want.to_record()
    assert json.dumps(prof.to_record(), sort_keys=True) == json.dumps(want.to_record(), sort_keys=True)
    costmodel.validate_profile(prof.to_record())
    assert set(prof.fixed) == {"t_dec", "bw_ici"}


@pytest.mark.parametrize("include_warmup", [False, True])
def test_golden_fit_with_and_without_warmup_equals_jax(include_warmup):
    got = costmodel.calibrate(GOLDEN, include_warmup=include_warmup, warmup_k=3.0).to_record()
    assert got == jcostmodel.calibrate(GOLDEN, include_warmup=include_warmup, warmup_k=3.0).to_record()


@pytest.mark.parametrize("plant", [_plant_run, _plant_routed_run])
def test_planted_runs_equal_jax(tmp_path, plant):
    run = plant(tmp_path)
    got, want = costmodel.calibrate(run), jcostmodel.calibrate(run)
    assert got.to_record() == want.to_record()
    # the saved profile loads in the other package
    path = tmp_path / "p.json"
    got.save(path)
    assert jcostmodel.load_profile(path).to_record() == want.to_record()


def test_span_tables_and_self_times_equal_jax():
    for name in ("CAL_ENCODE_SPANS", "CAL_DECODE_SPANS", "CAL_WIRE_DCN_SPANS", "CAL_WIRE_ICI_SPANS",
                 "CAL_COMPUTE_SPANS", "CAL_EXCLUDED_SPANS"):
        assert getattr(costmodel, name) == getattr(jcostmodel, name), name
    events = json.loads((GOLDEN / "trace.json").read_text())["traceEvents"]
    assert costmodel.span_self_times(events) == jcostmodel.span_self_times(events)
    assert costmodel.span_self_times_by_route(events) == jcostmodel.span_self_times_by_route(events)
    for xs in ([10.0, 1.0, 1.0, 1.0, 1.1], [9.0, 8.0, 1.0, 1.0, 1.0, 1.0], [3.0], [], [100.0, 90.0]):
        for k in (0.1, 4.0):
            assert costmodel.drop_warmup(xs, k=k) == jcostmodel.drop_warmup(xs, k=k)


def test_calibrate_rejects_what_jax_rejects(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for pkg in (costmodel, jcostmodel):
        with pytest.raises(ValueError, match="config.json"):
            pkg.calibrate(empty)
    (empty / "config.json").write_text(json.dumps({"config": {"workers": 2}}))
    for pkg in (costmodel, jcostmodel):
        with pytest.raises(ValueError, match="trace.json"):
            pkg.calibrate(empty)


# -- apply_profile ---------------------------------------------------------- #

AUTO = dict(communicator="sparse_rs", compressor="topk", deepreduce=None, memory="residual", rs_mode="auto",
            compress_ratio=0.1)


def _auto_trainer(**knobs):
    from deepreduce_tpu_torch.collectives import InProcessGroup

    model = WordLSTM(64, 8, 16, seed=1)
    group = InProcessGroup(1).member(0)
    tr = port.Trainer(model, port.DeepReduceConfig(**{**AUTO, **knobs}), lr=0.1, device="cpu", group=group)
    return tr, tr.init_state()


def test_static_profile_is_a_no_op():
    tr, _ = _auto_trainer()
    ex0 = tr.exchanger
    rec = tr.apply_profile(costmodel.static_profile())
    assert rec["switched"] is False and rec["old"] == rec["new"] == ("rs", ex0._rs_mode)
    assert tr.exchanger is ex0
    assert tr.visited_plan_keys == (("rs", ex0._rs_mode),)


def test_a_fitted_profile_reselects_and_exchangers_built_equal_plans_visited(tmp_path):
    """A profile whose measured route row makes the sparse route dear moves
    the argmin; applying it again costs nothing; going back to the static
    profile reuses the first exchanger."""
    tr, st = _auto_trainer()
    ex0, key0 = tr.exchanger, ("rs", tr.exchanger._rs_mode)
    assert key0 == ("rs", "sparse")
    static = costmodel.static_profile()
    fitted = costmodel.MachineProfile(
        bw_dcn=static.bw_dcn, bw_ici=static.bw_ici, t_enc_s=static.t_enc_s, t_dec_s=static.t_dec_s,
        compute_time_s=0.0, fitted=("t_enc",), fixed=("t_dec", "bw_dcn", "bw_ici", "compute_time"),
        routes={"sparse": {"t_enc_s": 10.0, "t_dec_s": 10.0, "samples": 1}})
    costmodel.validate_profile(fitted.to_record())
    rec = tr.apply_profile(fitted)
    assert rec["switched"] and rec["old"] == key0 and rec["new"] != key0
    assert tr.exchanger is not ex0 and len(tr.visited_plan_keys) == 2
    again = tr.apply_profile(fitted)
    assert not again["switched"] and len(tr.visited_plan_keys) == 2
    back = tr.apply_profile(costmodel.static_profile())
    assert back["switched"] and tr.exchanger is ex0 and len(tr.visited_plan_keys) == 2
    # a profile file works as well
    path = tmp_path / "fitted.json"
    fitted.save(path)
    assert tr.apply_profile(str(path))["new"] == rec["new"]
    st, loss, _ = tr.step(st, (torch.zeros(2, 5, dtype=torch.long), torch.zeros(2, 5, dtype=torch.long)))
    assert torch.isfinite(loss)


def test_apply_profile_without_auto_and_under_ctrl():
    tr = port.Trainer(WordLSTM(64, 8, 16), port.DeepReduceConfig(compress_ratio=0.1), lr=0.1, device="cpu")
    tr.init_state()
    assert tr.apply_profile(costmodel.static_profile())["old"] is None
    ctrl = port.Trainer(WordLSTM(64, 8, 16), port.DeepReduceConfig(compress_ratio=0.1, telemetry=True, ctrl=True),
                        lr=0.1, device="cpu")
    ctrl.init_state()
    with pytest.raises(ValueError, match="ctrl=True"):
        ctrl.apply_profile(costmodel.static_profile())
    with pytest.raises(ValueError, match="init_state"):
        port.Trainer(WordLSTM(64, 8, 16), port.DeepReduceConfig(**AUTO), lr=0.1,
                     device="cpu").apply_profile(costmodel.static_profile())
