"""Dry runs of every cell of BENCHMARK.json on the CPU at a tiny size: the
port's plain kernel versions run, and the result has the contract's shape.
The reference agrees with the program, and `correct` follows the limits."""

from __future__ import annotations

import json

import pytest
import torch

from h100bench import run
from h100bench.tests.tiny import bench, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]
SEED = 2**31 + 977  # past 32 signed bits, as the benchmark's seeds may be


def _run(workload, trace=False, seconds=0.2):
    config, traffic = tiny_cell(workload)
    return run.run_cell(bench(), workload, seed=SEED, seconds=seconds, trace=trace, device=torch.device("cpu"),
                        config=config, traffic=traffic)


@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_the_contract_line(workload):
    result, numbers, limits = _run(workload)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"] for m in bench()["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == e2e
    assert line["metrics"]["wire_bytes_per_step"]["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # the tiny program and the reference agree far inside every limit
    assert line["correct"] is True, line["checked"]
    assert set(numbers) <= set(limits)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_dry_run_gives_the_breakdown(workload):
    result, _, _ = _run(workload, trace=True)
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in bench()["per_layer"] if workload in m["workloads"]}
    # on the CPU only the host span reads; no device metric takes a CPU number
    assert set(result["metrics"]) <= per_layer
    assert [run.base_name({"name": k}) for k in result["metrics"]] == ["exchange_host_ms"]
