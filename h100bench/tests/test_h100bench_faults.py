"""The timed path broken underneath: a run on the CPU at a tiny size whose
program is at fault comes out not correct, once for each fault a one-card
training cell can have."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from deepreduce_tpu_torch import train as port_train
from h100bench import run
from h100bench.tests.tiny import bench, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]


def _correct(workload):
    config, traffic = tiny_cell(workload)
    result, _, _ = run.run_cell(bench(), workload, seed=4242, seconds=0.1, trace=False, device=torch.device("cpu"),
                                config=config, traffic=traffic)
    return result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_step_that_returns_its_state_unchanged(workload, monkeypatch):
    real = port_train.Trainer.step

    def frozen(self, state, batch, **kw):
        saved = {n: p.detach().clone() for n, p in state.params.items()}
        new, loss, wire = real(self, state, batch, **kw)
        with torch.no_grad():
            for n, p in new.params.items():
                p.copy_(saved[n])
        return dataclasses.replace(new, residuals=state.residuals), loss, wire

    monkeypatch.setattr(port_train.Trainer, "step", frozen)
    assert _correct(workload) is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_batch_left_out(workload, monkeypatch):
    for name in ("classification_loss", "next_token_loss"):
        real = getattr(port_train, name)

        def halved(model, real=real):
            fn = real(model)
            return lambda batch: fn(tuple(t[: t.shape[0] // 2] for t in batch))

        monkeypatch.setattr(port_train, name, halved)
    assert _correct(workload) is False
