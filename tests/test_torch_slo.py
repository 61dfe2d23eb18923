"""Port parity for the SLO health plane (`slo/`) against the JAX package:
`SLOSpec`'s rejections under its reason codes, the health-record
validators, `hist_quantile`, and the `HealthMonitor`: fed the same report
stream as the JAX package's monitor (the `fedsim check` report format, two
tenants with a per-tenant override, every target kind exercised), it
emits the same transitions and writes a byte-identical `health.jsonl`, and
its `state_dict` resumes the trail bitwise."""

from __future__ import annotations

import json

import numpy as np
import pytest

from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.slo import HealthLog as JHealthLog
from deepreduce_tpu.slo import HealthMonitor as JHealthMonitor
from deepreduce_tpu.slo import SLOSpec as JSLOSpec
from deepreduce_tpu.slo import validate_health as jvalidate_health
from deepreduce_tpu.slo import validate_health_stream as jvalidate_stream
from deepreduce_tpu.telemetry.device_metrics import hist_quantile as jhist_quantile
from deepreduce_tpu_torch.config import ConfigError
from deepreduce_tpu_torch.slo import HealthLog, HealthMonitor, SLOSpec, hist_quantile, validate_health
from deepreduce_tpu_torch.slo import validate_health_stream

REJECTS = [
    ["not", "an", "object"],
    {"bogus_key": 1},
    {"version": 2},
    {"window_ticks": "four"},
    {"window_ticks": 0},
    {"fast_window_ticks": 4, "slow_window_ticks": 2},
    {"burn_fast": 0.0},
    {"targets": {"made_up_target": 1.0}},
    {"targets": {"min_clients_per_round": True}},
    {"targets": {"checksum_failure_budget": 0.0}},
    {"targets": {"checksum_failure_budget": 1.5}},
    {"targets": {"convergence_residency_min": 0.5}},
    {"targets": {"pop_residency_min": 1.5}},
    {"tenants": "nope"},
    {"tenants": {"x": {}}},
    {"tenants": {"-1": {}}},
    {"tenants": {"0": {"made_up_target": 1.0}}},
]


@pytest.mark.parametrize("raw", REJECTS, ids=range(len(REJECTS)))
def test_spec_rejections_carry_jax_reason_codes(raw):
    with pytest.raises(JConfigError) as jerr:
        JSLOSpec.from_dict(raw)
    with pytest.raises(ConfigError) as perr:
        SLOSpec.from_dict(raw)
    assert perr.value.reason_code == jerr.value.reason_code


def _rec(**kw):
    base = dict(tick=3, tenant=0, window_ticks=4, from_state="OK", to_state="DEGRADED",
                trigger="min_clients_per_round", value=0.5, threshold=1.0, burn_fast=None, burn_slow=None)
    base.update(kw)
    return base


RECORDS = [
    "not a dict", _rec(), _rec(to_state="WEDGED"), {k: v for k, v in _rec().items() if k != "window_ticks"},
    dict(_rec(), surprise=1), _rec(tick=True), _rec(tick=-1), _rec(window_ticks=0), _rec(value="high"),
    _rec(to_state="BREACH"), _rec(trigger="recovered"), _rec(from_state="DEGRADED", to_state="OK"),
    _rec(trigger="made_up_trigger"),
    _rec(from_state="DEGRADED", to_state="OK", trigger="recovered", value=None, threshold=None),
]


@pytest.mark.parametrize("rec", RECORDS, ids=range(len(RECORDS)))
def test_health_validators_accept_and_reject_as_jax(rec):
    def outcome(fn):
        try:
            fn(rec)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(validate_health) == outcome(jvalidate_health)
    up, down = _rec(tick=2), _rec(tick=5, from_state="DEGRADED", to_state="OK", trigger="recovered", value=None,
                                  threshold=None)
    for stream in ([up, down], [up, _rec(tick=2, tenant=1), down], [up, dict(down, tick=2)], [up, _rec(tick=9)]):
        assert outcome(lambda _: validate_health_stream(stream)) == outcome(lambda _: jvalidate_stream(stream))


def test_hist_quantile_is_jax_s():
    rng = np.random.default_rng(3)
    for _ in range(200):
        h = rng.integers(0, 5, size=rng.integers(1, 6)).astype(float).tolist()
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert hist_quantile(h, q) == jhist_quantile(h, q)
    assert hist_quantile([], 0.5) == jhist_quantile([], 0.5) == 0.0


SPEC = {
    "version": 1, "window_ticks": 4, "fast_window_ticks": 2, "slow_window_ticks": 6, "hysteresis_ticks": 2,
    "targets": {"min_clients_per_round": 6.0, "checksum_failure_budget": 0.1, "convergence_band": 0.5,
                "convergence_residency_min": 0.5, "staleness_p95_max": 1.0, "buffer_fill_max": 30.0,
                "pop_residency_min": 0.2},
    "tenants": {"1": {"min_clients_per_round": 3.0, "staleness_p95_max": 2.0}},
}


def _reports(ticks=48):
    """A deterministic report stream in the `fedsim check` format: calm,
    then churn and corruption bursts, staleness and fill spikes and a
    convergence drift, then calm again, per tenant."""
    rng = np.random.default_rng(11)
    out = []
    for t in range(ticks):
        for tenant in (0, 1):
            storm = 12 <= t < 28
            clients = float(rng.integers(2, 6) if storm else rng.integers(6, 9))
            fails = float(rng.integers(1, 4) if storm and t % 3 else rng.integers(0, 2) if storm else 0)
            hist = [clients - 2.0, 1.0, 1.0] if storm else [clients, 0.0, 0.0]
            out.append((t, tenant, {
                "clients": clients, "checksum_failures": fails,
                "buffer_fill": float(40 if storm and t % 4 == 0 else 10 + t % 7),
                "w_rel_err": float(0.9 if 16 <= t < 30 else 0.3),
                "staleness_hist": hist, "pop_hist": [clients * 0.9, clients * 0.1] if storm else [clients / 2] * 2,
            }))
    return out


def test_monitor_on_jax_s_report_stream_writes_the_same_health_jsonl(tmp_path):
    mons = {}
    for name, (Spec, Mon, Log) in {"port": (SLOSpec, HealthMonitor, HealthLog),
                                   "jax": (JSLOSpec, JHealthMonitor, JHealthLog)}.items():
        mons[name] = Mon(Spec.from_dict(SPEC), log=Log(tmp_path / name / "health.jsonl"))
    reports = _reports()
    resumed = None
    for i, (tick, tenant, rep) in enumerate(reports):
        got = mons["port"].observe(tick, rep, tenant=tenant)
        assert got == mons["jax"].observe(tick, rep, tenant=tenant)
        if i == len(reports) // 2:
            saved = json.dumps(mons["port"].state_dict(), sort_keys=True)
            resumed = HealthMonitor(SLOSpec.from_dict(SPEC))
            resumed.load_state_dict(json.loads(saved))
            assert json.dumps(resumed.state_dict(), sort_keys=True) == saved
            at = len(mons["port"].events)
        elif resumed is not None:
            resumed.observe(tick, rep, tenant=tenant)
    port_bytes = (tmp_path / "port" / "health.jsonl").read_bytes()
    assert port_bytes == (tmp_path / "jax" / "health.jsonl").read_bytes()
    events = mons["port"].events
    assert {e["to_state"] for e in events} >= {"DEGRADED", "BREACH", "OK"}
    assert {e["trigger"] for e in events} >= {"min_clients_per_round", "recovered"}
    validate_health_stream(HealthLog.read(tmp_path / "port" / "health.jsonl"))
    assert resumed.events[at:] == events[at:]
    assert mons["port"].final_states() == mons["jax"].final_states()
    for t in (0, 1):
        assert mons["port"].verdict(t) == mons["jax"].verdict(t)
