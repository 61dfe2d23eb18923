"""The control of each cell on the card, at a tiny size: the reference one
precision below the configuration's, in the program's place, comes out not
correct, and the program's own run correct, under the cell's limits. Run on
the card: `python -m pytest h100bench/tests -q -m cuda`."""

from __future__ import annotations

import pytest
import torch

from h100bench import calibrate, check
from h100bench.tests.tiny import bench, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's precision steps (fp8, TF32) exist on the card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, card):
    config, traffic = tiny_cell(workload, small=True)
    seeds = [11, 12, 13]
    res = calibrate.readings(workload, seeds, set(seeds), set(), card, config=config, traffic=traffic)
    limits = check.limits_for(workload)
    for row in res["program"]:
        assert check.judge({k: v for k, v in row.items() if k != "seed"}, limits), row
    for row in res["control"]:
        assert not check.judge({k: v for k, v in row.items() if k != "seed"}, limits), row
