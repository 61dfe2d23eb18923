"""The port's training driver (`python -m deepreduce_tpu_torch.driver`)
against the JAX package's (`benchmarks/train.py`), on the CPU.

- Parity on the `mlp` model at W = 1 and at W = 4 gloo ranks (JAX: 4
  virtual devices), from JAX's initial parameters (its `run` makes them
  with `model.init(PRNGKey(seed), init batch)`), under two configs without a
  stochastic codec: the JAX kill / resume test's top-k 0.25 and the overlap
  gate's bloom index (`Makefile` OVERLAP_CHECK_CFG). Losses within rtol
  1e-5, the wire fields equal, the telemetry summary's keys equal and its
  counters equal.
- Kill and resume at W = 2 with the JAX test's protocol
  (`tests/test_checkpoint.py`): 6 steps against 4 steps checkpointed every
  2, resumed to 6. The resumed tail is bitwise the uninterrupted run on the
  CPU, the telemetry counts all 6 steps, and a checkpoint written under
  another config raises naming its fingerprint. Both the top-k config and
  DRQSGD-BF-P0 (QSGD draws keyed by (seed, step)).
- The `Makefile` gates `overlap-check`, `calibrate-check` and
  `telemetry-check` replayed with the port's CLIs, at W = 4 gloo ranks for
  the overlap gate and 2 for the others (the Makefile runs 8 JAX virtual
  devices; its calibrate gate's hierarchical arm is not replayed): the streamed run's losses and
  rel_volume series bitwise the barrier run's and `telemetry trace
  --overlap` exit 0 (and on the composed stream-over-hier run at its 0.9
  threshold); two `telemetry calibrate` fits byte-equal; `telemetry
  summary` and `trace` exit 0 on a ResNet-20 run.
- An unknown knob fails with its name, as in the JAX driver; the card is
  the default and its absence an error; the profile window and a failed
  run's tracking record.
"""

import argparse
import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepreduce_tpu.telemetry import spans as jax_spans
from deepreduce_tpu_torch import driver
from deepreduce_tpu_torch.config import ConfigError
from deepreduce_tpu_torch.weights import flatten_flax

REPO = pathlib.Path(__file__).resolve().parents[1]

TOPK = ("{'compressor':'topk','compress_ratio':0.25,'deepreduce':None,'memory':'residual',"
        "'min_compress_size':16}")
BLOOM_BODY = ("'compressor':'topk','compress_ratio':0.05,'deepreduce':'index','index':'bloom','fpr':0.01,"
              "'memory':'residual','bucket_bytes':8192")
BLOOM = "{" + BLOOM_BODY + "}"
DRQSGD_BF_P0 = ("{'compressor':'topk','compress_ratio':0.1,'deepreduce':'both','index':'bloom','value':'qsgd',"
                "'fpr':0.02,'policy':'p0','bloom_blocked':'mod','memory':'residual','min_compress_size':16}")
CALIB_BODY = ("'compressor':'topk','compress_ratio':0.05,'deepreduce':'index','index':'bloom','fpr':0.01,"
              "'memory':'residual'")
# the summary rows that count (steps, bits, workers, failures): equal to JAX's
COUNTERS = ("steps", "cumulative_total_bits", "rel_volume", "idx_rel_volume", "val_rel_volume",
            "saturated_per_step", "live_workers_per_step", "dropped_steps", "checksum_failures",
            "ici_bytes_per_step", "dcn_bytes_per_step")


def _args(**kw):
    base = dict(model="mlp", grace_config=TOPK, num_steps=6, batch_size=32, num_workers=4, learning_rate=0.1,
                seed=0, log_every=0, track_dir="", run_name="", tags="", telemetry=True, profile_dir="",
                checkpoint_every=0, checkpoint_dir="", resume=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_train", REPO / "benchmarks" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _bench_module()


@pytest.fixture(scope="module")
def jax_init(bench):
    """JAX's initial parameters as its `run` makes them: the same model,
    PRNGKey(seed) and the init batch, flattened to flax names."""
    model, (kind, spec, classes) = bench.MODELS["mlp"]()
    x, _ = bench.make_batch(kind, spec, classes, 32, np.random.default_rng((0, 0, 0)))
    return flatten_flax(model.init(jax.random.PRNGKey(0), x)["params"])


@pytest.fixture(scope="module")
def jax_runs(bench):
    """One JAX driver run a (config, W), shared by the module."""
    cache = {}

    def get(config: str, workers: int) -> dict:
        if (config, workers) not in cache:
            args = vars(_args(grace_config=config, num_workers=workers))
            del args["device"]
            try:
                cache[config, workers] = bench.run(argparse.Namespace(**args, platform=""))
            finally:
                jax_spans.configure(enabled=False, reset=True)
        return cache[config, workers]

    return get


@pytest.mark.parametrize("config", [TOPK, BLOOM], ids=["topk", "bloom_index"])
@pytest.mark.parametrize("workers", [1, 4])
def test_driver_matches_the_jax_driver_from_its_initial_parameters(jax_runs, jax_init, config, workers):
    want = jax_runs(config, workers)
    got = driver.run(_args(grace_config=config, num_workers=workers), init_params=jax_init)
    assert got["workers"] == want["workers"] == workers
    assert got["steps"] == want["steps"] and got["global_batch"] == want["global_batch"]
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"], rtol=1e-5)
    for k in ("rel_volume", "idx_rel_volume", "val_rel_volume", "payload_bytes_per_step"):
        assert got[k] == want[k], k
    assert list(got) == list(want)
    assert list(got["telemetry"]) == list(want["telemetry"])
    for k in COUNTERS:
        assert got["telemetry"][k] == want["telemetry"][k], k
        assert got["telemetry"]["window_" + k] == want["telemetry"]["window_" + k], k
    for k, v in want["telemetry"].items():
        np.testing.assert_allclose(got["telemetry"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("config", [TOPK, DRQSGD_BF_P0], ids=["topk", "drqsgd_bf_p0"])
def test_kill_and_resume_continues_exactly_over_two_ranks(tmp_path, config):
    ck = str(tmp_path / "ck")
    kw = dict(grace_config=config, num_workers=2)
    full = driver.run(_args(num_steps=6, **kw))
    killed = driver.run(_args(num_steps=4, checkpoint_every=2, checkpoint_dir=ck, **kw))
    assert killed["steps"] == 4
    assert sorted(p.name for p in (tmp_path / "ck" / "last").glob("*.pt")) == ["rank0.pt", "rank1.pt"]
    resumed = driver.run(_args(num_steps=6, checkpoint_dir=ck, resume=True, **kw))
    assert resumed["resumed_at"] == 4
    # bitwise on the CPU (the JAX test's bound is rtol 1e-6)
    assert resumed["last_loss"] == full["last_loss"]
    assert resumed["rel_volume"] == full["rel_volume"]
    # the accumulator resumed too: it counts all 6 steps
    assert resumed["telemetry"]["steps"] == 6.0
    assert resumed["telemetry"]["cumulative_total_bits"] == full["telemetry"]["cumulative_total_bits"]
    if config == TOPK:
        # a run resumed past its end has nothing left to do
        past = driver.run(_args(num_steps=4, checkpoint_dir=ck, resume=True, **kw))
        want = {"model": "mlp", "workers": 2, "steps": 0, "resumed_at": 4,
                "config": {**ast.literal_eval(config), "telemetry": True}}
        assert past == want
    other = config.replace("'compress_ratio':0.", "'compress_ratio':0.0")
    with pytest.raises(driver.RankError, match="fingerprint"):
        driver.run(_args(num_steps=6, checkpoint_dir=ck, resume=True, grace_config=other, num_workers=2))


def _cli(*argv, timeout=240):
    """A port CLI in a fresh process; the completed process."""
    return subprocess.run([sys.executable, "-m", *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout)


def _driver_cli(track: pathlib.Path, name: str, grace: str, *, model="mlp", steps=6, workers=4, batch=8):
    p = _cli("deepreduce_tpu_torch.driver", "--device", "cpu", "--model", model, "--num_steps", str(steps),
             "--batch_size", str(batch), "--num_workers", str(workers), "--seed", "0", "--telemetry",
             "--track_dir", str(track), "--run_name", name, "--log_every", "0", "--grace_config", grace)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _series(run_dir: pathlib.Path):
    return [(r["loss"], r["rel_volume"]) for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())]


def test_overlap_gate_streamed_against_barrier(tmp_path):
    _driver_cli(tmp_path, "stream", "{" + BLOOM_BODY + ",'stream_exchange':True}")
    _driver_cli(tmp_path, "barrier", "{" + BLOOM_BODY + ",'bucket_pipeline':False}")
    p = _cli("deepreduce_tpu_torch.telemetry", "trace", str(tmp_path / "stream"), "--overlap")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "overlap fraction" in p.stdout
    stream, barrier = _series(tmp_path / "stream"), _series(tmp_path / "barrier")
    assert len(stream) == 6 and stream == barrier
    # the composed stream-over-hier run on the (2, 2) mesh: every leg's spans
    # dispatch from inside backprop, at the tighter threshold
    _driver_cli(tmp_path, "composed", "{" + BLOOM_BODY + ",'stream_exchange':True,'hier':True}")
    p = _cli("deepreduce_tpu_torch.telemetry", "trace", str(tmp_path / "composed"), "--overlap",
             "--overlap-threshold", "0.9")
    assert p.returncode == 0, p.stdout + p.stderr


def test_calibrate_gate_fits_are_byte_equal(tmp_path):
    _driver_cli(tmp_path, "calib", "{" + CALIB_BODY + "}", steps=8, workers=2)
    outs = [tmp_path / "profile.json", tmp_path / "profile2.json"]
    for out in outs:
        p = _cli("deepreduce_tpu_torch.telemetry", "calibrate", str(tmp_path / "calib"), "--out", str(out))
        assert p.returncode == 0, p.stdout + p.stderr
    assert outs[0].read_bytes() == outs[1].read_bytes()


def test_telemetry_gate_summary_and_trace(tmp_path):
    res = _driver_cli(tmp_path, "check", "{" + CALIB_BODY + "}", model="resnet20", steps=4, workers=2)
    assert res["telemetry"]["steps"] == 4.0
    run = tmp_path / "check"
    assert {"config.json", "metrics.jsonl", "summary.json", "trace.json"} <= {p.name for p in run.iterdir()}
    p = _cli("deepreduce_tpu_torch.telemetry", "summary", str(run))
    assert p.returncode == 0, p.stdout + p.stderr
    p = _cli("deepreduce_tpu_torch.telemetry", "trace", str(run), "--out", str(tmp_path / "merged_trace.json"))
    assert p.returncode == 0, p.stdout + p.stderr
    assert json.loads((tmp_path / "merged_trace.json").read_text())["traceEvents"]


def test_unknown_knob_fails_with_its_name_as_in_the_jax_driver(bench):
    typo = "{'compressor':'topk','compres_ratio':0.1}"
    with pytest.raises(ConfigError, match="compres_ratio"):
        driver.run(_args(grace_config=typo, num_workers=1))
    args = vars(_args(grace_config=typo, num_workers=1))
    del args["device"]
    with pytest.raises(ValueError, match="compres_ratio"):
        bench.run(argparse.Namespace(**args, platform=""))


def test_the_card_is_the_default_and_its_absence_an_error():
    args = driver.build_parser().parse_args(["--model", "mlp"])
    assert args.device == "cuda" and args.num_workers == 8 and args.num_steps == 20
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(args)


def test_profile_window_and_a_failed_runs_record(tmp_path, capsys):
    # the window opens at the third step: below 3 steps it warns and is off
    driver.run(_args(num_workers=1, num_steps=2, profile_dir=str(tmp_path / "p2"), telemetry=False))
    assert "profiling disabled" in capsys.readouterr().out
    assert not (tmp_path / "p2").exists()
    driver.run(_args(num_workers=1, num_steps=3, profile_dir=str(tmp_path / "p3"), telemetry=False))
    assert json.loads((tmp_path / "p3" / "rank0.trace.json").read_text())["traceEvents"]
    # a global batch of 3 does not split over 2 ranks: the step fails, and
    # rank 0 still writes its trace and finishes the tracked run as failed
    with pytest.raises(driver.RankError, match="does not split"):
        driver.run(_args(num_workers=2, batch_size=3, track_dir=str(tmp_path / "t"), run_name="bad"))
    summary = json.loads((tmp_path / "t" / "bad" / "summary.json").read_text())
    assert summary == {"status": "failed", "steps_completed": 0}
    assert (tmp_path / "t" / "bad" / "trace.json").exists()


def test_phase21_grace_configs_are_the_flagship_and_the_jax_drivers_quick_start():
    """chip_smoke phase 21 drives phase 5's flagship config and the quick
    start of `benchmarks/train.py`'s docstring, in the reference's format."""
    import re

    import chip_smoke

    from deepreduce_tpu_torch import from_params

    assert from_params(ast.literal_eval(chip_smoke.FLAGSHIP21)) == chip_smoke._flagship_cfg(0)
    doc = (REPO / "benchmarks" / "train.py").read_text()
    quick = re.search(r'--grace_config "(\{.*?\})"', doc, re.S).group(1)
    assert ast.literal_eval(chip_smoke.QUICKSTART21) == ast.literal_eval(re.sub(r"\s+", "", quick))
    stream = ast.literal_eval(chip_smoke.STREAM21 + "}")
    assert stream["bucket_bytes"] == chip_smoke.BUCKET_BYTES and stream["bucket_order"] == "reverse"
