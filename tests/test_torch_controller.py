"""Port parity for the adaptive compression controller: the ladder, the
control law and its decision trail, the controller's state, the config
knobs and fences of telemetry and the controller, and the per-bucket
operating points, against the JAX package on the CPU; and the port's own
contracts: exchangers built == rungs visited, a resume replays the trail
and the parameters bitwise, and phase 19's rung payload bytes are the JAX
package's."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.controller import CompressionController as JController
from deepreduce_tpu.controller import DecisionLog as JDecisionLog
from deepreduce_tpu.controller import Ladder as JLadder
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig
from deepreduce_tpu_torch.controller import CompressionController, DecisionLog, Ladder, validate_decision
from deepreduce_tpu_torch.controller import __main__ as cli
from deepreduce_tpu_torch.controller.controller import DECISION_SCHEMA, RATIONALES, TRIGGERS
from deepreduce_tpu_torch.models import WordLSTM

FIXED = dict(deepreduce="index", index="bloom", compress_ratio=0.02, fpr=0.01, memory="residual",
             min_compress_size=100)
CTRL = dict(telemetry=True, ctrl=True, ctrl_ladder="0.01,0.02@0.05,0.05", ctrl_hysteresis=2,
            ctrl_target_err_cos=0.5, ctrl_headroom=0.1, ctrl_saturation_ceiling=1.5)


# -- the ladder -------------------------------------------------------------- #


@pytest.mark.parametrize("spec", ["0.01,0.02,0.05", "0.005,0.01@0.01,0.02@0.01,0.05", " 0.1 , 0.2@0.5 ", "0.5,1"])
def test_ladder_equals_jax(spec):
    got, want = Ladder.parse(spec), JLadder.parse(spec)
    assert got.labels() == want.labels() and len(got) == len(want)
    assert [dataclasses.astuple(p) for p in got.points] == [dataclasses.astuple(p) for p in want.points]
    for ratio in (0.0, 0.004, 0.0075, 0.01, 0.03, 0.2, 0.9, 1.0):
        assert got.index_near(ratio) == want.index_near(ratio), ratio
    base = dict(FIXED, compress_ratio=0.3)
    for i in range(len(got)):
        a, b = got.apply(DeepReduceConfig(**base), i), want.apply(JConfig(**base), i)
        assert (a.compress_ratio, a.fpr) == (b.compress_ratio, b.fpr)
    for pkg in (got, want):
        with pytest.raises(ValueError, match="out of range"):
            pkg.apply(DeepReduceConfig(**base) if pkg is got else JConfig(**base), len(got))


@pytest.mark.parametrize("spec", ["0.02", "0.05,0.02", "0,0.02", "0.02,1.5", "0.01,0.02@2", "a,b", "0.1,0.1", ""])
def test_ladder_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError) as got:
        Ladder.parse(spec)
    with pytest.raises(ValueError) as want:
        JLadder.parse(spec)
    assert str(got.value) == str(want.value)


# -- the control law --------------------------------------------------------- #


def _stream(seed, windows=24):
    """Cumulative fetches of random windows: err_cos around the band,
    saturation now and then, the odd empty window, three buckets."""
    rng = np.random.default_rng(seed)
    cum = {n: 0.0 for n in port.telemetry.MetricAccumulators.scalar_fields()}
    cum["bucket_saturated"] = [0.0, 0.0, 0.0]
    step = 0
    for _ in range(windows):
        n = int(rng.choice([0, 3, 5]))
        step += n
        cum = dict(cum, bucket_saturated=list(cum["bucket_saturated"]))
        cum["steps"] += float(n)
        cum["err_cos"] += float(np.float32(rng.uniform(0.3, 0.75))) * n
        cum["saturated"] += float(rng.choice([0.0, 0.0, 2.0])) * n
        cum["index_bits"] += 100.0 * n
        cum["value_bits"] += 40.0 * n
        cum["dense_bits"] += 1000.0 * n
        cum["bucket_saturated"] = [b + float(rng.integers(0, 2)) for b in cum["bucket_saturated"]]
        # float32 values, as a fetch of the float32 accumulators has
        cum = {k: v if isinstance(v, list) else float(np.float32(v)) for k, v in cum.items()}
        yield step, cum


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_write_the_same_trail_and_state(tmp_path, seed):
    got = CompressionController(DeepReduceConfig(**FIXED, **CTRL), log=DecisionLog(tmp_path / "port.jsonl"))
    want = JController(JConfig(**FIXED, **CTRL), log=JDecisionLog(tmp_path / "jax.jsonl"))
    mid = None
    for i, (step, fetch) in enumerate(_stream(seed)):
        assert got.observe(step, fetch) == want.observe(step, fetch)
        if i == 11:
            mid = (got.state_dict(3), list(_stream(seed))[12:])
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert got.switches == want.switches >= 1 and got.effective_ratio() == want.effective_ratio()
    a, b = got.state_dict(3), want.state_dict(3)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for rec in DecisionLog.read(tmp_path / "port.jsonl"):
        validate_decision(rec)
    # a controller restored from the middle continues the trail bitwise
    state, rest = mid
    resumed = CompressionController(DeepReduceConfig(**FIXED, **CTRL))
    resumed.load_state_dict(state)
    tail = [resumed.observe(s, f) for s, f in rest]
    assert [json.dumps(r, sort_keys=True) for r in tail if r] == [
        json.dumps(r, sort_keys=True) for r in want.decisions[-len([r for r in tail if r]):]]


def test_schema_and_codes_equal_jax():
    from deepreduce_tpu.controller import controller as jc

    assert DECISION_SCHEMA == jc.DECISION_SCHEMA and TRIGGERS == jc.TRIGGERS and RATIONALES == jc.RATIONALES
    rec = {"step": 1, "window_steps": 1, "trigger": "in_band", "rationale": "hold_in_band", "switched": True,
           "old_index": 0, "new_index": 0, "old_ratio": 0.1, "new_ratio": 0.1, "old_fpr": None, "new_fpr": None,
           "err_cos": 0.5, "saturated_per_step": 0.0, "rel_volume": 0.1}
    for bad in (rec, {**rec, "switched": False, "step": True}, {**rec, "switched": False, "trigger": "x"},
                {k: v for k, v in rec.items() if k != "step"}):
        with pytest.raises(ValueError) as got:
            validate_decision(bad)
        with pytest.raises(ValueError) as want:
            jc.validate_decision(bad)
        assert str(got.value) == str(want.value)


# -- the knobs and their fences ---------------------------------------------- #


@pytest.mark.parametrize("knobs", [
    dict(telemetry_every=0),
    dict(ctrl_hysteresis=3),
    dict(telemetry=True, ctrl_ladder="0.01,0.05"),
    dict(ctrl=True),
    dict(ctrl=True, telemetry=True, compressor="none"),
    dict(ctrl=True, telemetry=True, hier=True),
    dict(ctrl=True, telemetry=True, ctrl_target_err_cos=0.0),
    dict(ctrl=True, telemetry=True, ctrl_target_err_cos=1.5),
    dict(ctrl=True, telemetry=True, ctrl_headroom=-0.1),
    dict(ctrl=True, telemetry=True, ctrl_saturation_ceiling=-1.0),
    dict(ctrl=True, telemetry=True, ctrl_hysteresis=0),
    dict(ctrl=True, telemetry=True, ctrl_ladder="0.05"),
    dict(ctrl=True, telemetry=True, ctrl_ladder="0.05,0.01"),
    dict(ctrl=True, telemetry=True, compressor="topk", deepreduce=None, communicator="sparse_rs", rs_mode="auto",
         profile="p.json"),
    dict(ctrl=True, telemetry=True, bucket_bytes=4096, stream_exchange=True, hier=True),
])
def test_fences_raise_the_jax_reason_code(knobs):
    with pytest.raises(JConfigError) as want:
        JConfig(**knobs)
    with pytest.raises(ConfigError) as got:
        DeepReduceConfig(**knobs)
    assert got.value.reason_code == want.value.reason_code


def test_knobs_take_the_jax_defaults_and_pass_from_params():
    names = ("telemetry", "telemetry_every", "ctrl", "ctrl_ladder", "ctrl_target_err_cos", "ctrl_headroom",
             "ctrl_saturation_ceiling", "ctrl_hysteresis")
    assert {n: getattr(DeepReduceConfig(), n) for n in names} == {n: getattr(JConfig(), n) for n in names}
    port_fields = {f.name for f in dataclasses.fields(DeepReduceConfig)}
    assert {f.name for f in dataclasses.fields(JConfig)} - port_fields == {"use_pallas"}
    cfg = port.from_params({"telemetry": True, "telemetry_every": 4, "ctrl": True, "ctrl_ladder": "0.01,0.1"})
    assert cfg.ctrl and cfg.telemetry_every == 4


# -- per-bucket operating points --------------------------------------------- #


SHAPES = {"a": (3000,), "b": (40, 50), "c": (700,), "d": (12,)}


def test_bucket_points_equal_jax_and_need_buckets():
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    base = dict(compress_ratio=0.05, deepreduce="both", index="bloom", value="qsgd", fpr=0.02, policy="p0",
                min_compress_size=100)
    with pytest.raises(JConfigError) as want:
        JExchanger(like, JConfig(**base), bucket_points=((0.1, None),))
    with pytest.raises(ConfigError) as got:
        port.GradientExchanger(SHAPES, DeepReduceConfig(**base), device="cpu", bucket_points=((0.1, None),))
    assert got.value.reason_code == want.value.reason_code == "build-bucket-points-need-buckets"
    cfg = dict(base, bucket_bytes=8000)
    ex = port.GradientExchanger(SHAPES, DeepReduceConfig(**cfg), device="cpu")
    points = tuple((0.2 if b % 2 else 0.05, 0.01 if b == 0 else None) for b in range(ex.num_buckets))
    got = port.GradientExchanger(SHAPES, DeepReduceConfig(**cfg), device="cpu", bucket_points=points)
    want = JExchanger(like, JConfig(**cfg), bucket_points=points)
    assert got.num_buckets == want.num_buckets >= 2
    assert got.payload_bytes() == want.payload_bytes(like) != ex.payload_bytes()
    with pytest.raises(ValueError, match="one \\(ratio, fpr\\) per bucket"):
        port.GradientExchanger(SHAPES, DeepReduceConfig(**cfg), device="cpu", bucket_points=points[:1])


def test_phase19_rung_payload_bytes_match_jax():
    """chip_smoke's CTRL19_PAYLOAD: the JAX package's exchanger for each
    rung of CTRL19_LADDER on the full-width WordLSTM's shapes."""
    shapes = {n: tuple(p.shape) for n, p in WordLSTM().flax_params().items()}
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    flag = chip_smoke._flagship_cfg(0)
    ladder = Ladder.parse(chip_smoke.CTRL19_LADDER)
    assert ladder.points[ladder.index_near(flag.compress_ratio)].ratio == flag.compress_ratio
    for i, pt in enumerate(ladder.points):
        jcfg = JConfig(**{**dataclasses.asdict(flag), "compress_ratio": pt.ratio})
        assert JExchanger(like, jcfg).payload_bytes(like) == chip_smoke.CTRL19_PAYLOAD[pt.ratio], pt
        assert port.GradientExchanger(shapes, ladder.apply(flag, i), device="cpu").payload_bytes() == \
            chip_smoke.CTRL19_PAYLOAD[pt.ratio]


# -- the Trainer's controller ------------------------------------------------ #


def _adaptive(cfg, tok, steps, *, seed=2, ckpt=None, resume=None, log=None, bucketed=False):
    from deepreduce_tpu_torch import checkpoint

    tr = port.Trainer(WordLSTM(64, 8, 16, seed=seed), cfg, lr=0.1, momentum=0.9, device="cpu")
    if log is not None:
        tr.attach_decision_log(log)
    st = tr.init_state()
    if resume is not None:
        restored = checkpoint.restore(resume, {"state": st, "telemetry": None, "ctrl": None}, config=cfg)
        st, tr.telemetry = restored["state"], restored["telemetry"]
        tr.load_controller_state(restored["ctrl"])
    for i in range(st.step, steps):
        st, _, _ = tr.step(st, (tok[i, :, :-1], tok[i, :, 1:]))
        if ckpt is not None and i + 1 == ckpt[1]:
            checkpoint.save(ckpt[0], {"state": st, "telemetry": tr.telemetry, "ctrl": tr.controller_state()},
                            config=cfg)
    return tr, st


@pytest.mark.parametrize("bucket_bytes", [None, 2048])
def test_exchangers_built_equal_rungs_visited_and_a_resume_replays_bitwise(tmp_path, bucket_bytes):
    cfg = DeepReduceConfig(compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd", fpr=0.02,
                           policy="p0", min_compress_size=100, bucket_bytes=bucket_bytes, telemetry=True,
                           telemetry_every=2, ctrl=True, ctrl_ladder="0.05,0.1,0.2", ctrl_hysteresis=1,
                           ctrl_target_err_cos=0.9, ctrl_headroom=0.05)
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 64, size=(8, 4, 6)))
    full, st = _adaptive(cfg, tok, 8, ckpt=(str(tmp_path / "c.pt"), 4), log=tmp_path / "full.jsonl")
    trail = DecisionLog.read(tmp_path / "full.jsonl")
    assert len(trail) == 3 and full.controller.switches >= 1
    visited = {r["old_index"] for r in trail} | {r["new_index"] for r in trail}
    assert set(full.visited_ladder_indices) == visited
    if bucket_bytes:
        ex = full._exchanger_cache[full.controller.index]
        assert ex.bucketed.points == tuple((full.controller.point.ratio, None) for _ in range(ex.num_buckets))
    resumed, st2 = _adaptive(cfg, tok, 8, seed=5, resume=str(tmp_path / "c.pt"), log=tmp_path / "resume.jsonl")
    tail = [json.dumps(r, sort_keys=True) for r in trail if r["step"] >= 4]
    assert tail == [json.dumps(r, sort_keys=True) for r in DecisionLog.read(tmp_path / "resume.jsonl")]
    for n, p in st.params.items():
        assert torch.equal(p, st2.params[n]), n
    assert resumed.telemetry.fetch() == full.telemetry.fetch()


def test_controller_surface_without_ctrl():
    tr = port.Trainer(WordLSTM(64, 8, 16), DeepReduceConfig(compress_ratio=0.1), lr=0.1, device="cpu")
    assert tr.controller is None and tr.visited_ladder_indices == ()
    for call in (lambda: tr.attach_decision_log("x"), tr.controller_state, lambda: tr.load_controller_state({})):
        with pytest.raises(ValueError, match="ctrl=True"):
            call()


def test_controller_check_cli(capsys):
    """`python -m deepreduce_tpu_torch.controller --device cpu check`:
    every check true (schema, a switch, exchangers built == rungs
    visited, a bitwise resume)."""
    assert cli.main(["--device", "cpu", "check", "--steps", "20"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and all(rep["checks"].values()) and rep["switches"] >= 1
