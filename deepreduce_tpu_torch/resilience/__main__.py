"""The resilience CLI: the chaos check and the drop / corrupt sweep, ported
from `deepreduce_tpu/resilience/__main__.py`.

    python -m deepreduce_tpu_torch.resilience check [--device cuda] [--num_workers 8]
    python -m deepreduce_tpu_torch.resilience sweep [--device cuda] [--num_workers 8]

`check` trains a small MLP (64-64-8 on 32 features, the JAX check's) for
24 steps with `num_workers` workers under a FaultPlan drop schedule and
wire corruption with payload checksums, and checks that the loss stays
finite and falls, that the dropped steps were counted and that the
corrupted payloads failed their checksum instead of reaching the
parameters; it prints the JAX check's JSON report. `sweep` runs a grid of
drop rate x corrupt rate and prints one JSON row a cell. The workers are
threads of one `collectives.InProcessGroup` on one device; the counters
come from each step's `collect` and the losses from each step, all read
once at the end.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from deepreduce_tpu_torch.collectives import InProcessGroup
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import resolve_device
from deepreduce_tpu_torch.models.mlp import MLP
from deepreduce_tpu_torch.train import Trainer

BATCH = 64  # the global batch, split over the workers


def build_cfg(**overrides) -> DeepReduceConfig:
    """The JAX check's codec stack: top-k 0.05 under a bloom index at fpr
    0.01, residual memory, leaves over 100 elements compressed."""
    base = dict(deepreduce="index", index="bloom", compress_ratio=0.05, fpr=0.01, memory="residual",
                min_compress_size=100)
    base.update(overrides)
    return DeepReduceConfig(**base)


def make_data(seed: int = 0):
    """The JAX check's data: 512 examples of 32 features and labels from a
    fixed random projection, float32 and int64 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(512, 32))
    w_true = rng.normal(size=(32, 8))
    y = np.argmax(rng.normal(size=(512, 8)) * 0.1 + x @ w_true, axis=1)
    return x.astype(np.float32), y.astype(np.int64)


def run_train(cfg: DeepReduceConfig, *, steps: int, num_workers: int, device="cuda", seed: int = 0,
              lr: float = 0.1, params=None):
    """`steps` synchronous steps of `num_workers` in-process workers, each on
    its shard of the step's batch; returns (losses, summary). `params`
    (flax name -> array) replaces the MLP's initial weights."""
    dev = resolve_device(device)
    x, y = make_data(seed)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    if BATCH % num_workers:
        raise ValueError(f"the batch of {BATCH} does not split over {num_workers} workers")
    shard = BATCH // num_workers

    def worker(coll):
        model = MLP(seed=seed)
        if params is not None:
            model.load_flax_params({n: torch.from_numpy(np.array(v)) for n, v in params.items()})
        trainer = Trainer(model, cfg, lr=lr, momentum=0.9, device=dev, group=coll)
        state = trainer.init_state()
        losses, collects = [], []
        for step in range(steps):
            lo = (step * BATCH) % (512 - BATCH) + coll.rank * shard
            collect = {}
            state, loss, _ = trainer.step(state, (x[lo : lo + shard], y[lo : lo + shard]), collect=collect)
            losses.append(loss)
            collects.append(collect)
        return losses, collects

    losses, collects = InProcessGroup(num_workers).run(worker)[0]
    # one read of every step's loss and counters, at the end
    losses = torch.stack(losses).tolist()
    counters = {k: torch.stack([c[k] for c in collects]).tolist() for k in collects[0] if k != "bucket_saturated"}
    summary = {"steps": steps}
    if "live_workers" in counters:
        summary["live_workers_per_step"] = sum(counters["live_workers"]) / steps
        summary["dropped_steps"] = sum(counters["dropped"])
    summary["checksum_failures"] = sum(counters.get("checksum_failures", [0.0]))
    return losses, summary


def _finite(losses) -> bool:
    return all(math.isfinite(l) for l in losses)


def cmd_check(args) -> int:
    cfg = build_cfg(resilience=True, fault_plan="2@5:9,0@12:14", payload_checksum=True, chaos_corrupt_rate=0.2)
    losses, summary = run_train(cfg, steps=args.steps, num_workers=args.num_workers, device=args.device)
    checks = {
        "losses_finite": _finite(losses),
        "loss_decreased": losses[-1] < losses[0],
        "dropped_steps_recorded": summary.get("dropped_steps", 0.0) > 0.0,
        "checksum_failures_caught": summary.get("checksum_failures", 0.0) > 0.0,
    }
    report = {
        "ok": all(checks.values()),
        "checks": checks,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "steps": len(losses),
        "live_workers_per_step": summary.get("live_workers_per_step"),
        "dropped_steps": summary.get("dropped_steps"),
        "checksum_failures": summary.get("checksum_failures"),
        "config": {
            "fault_plan": cfg.fault_plan,
            "chaos_corrupt_rate": cfg.chaos_corrupt_rate,
            "payload_checksum": cfg.payload_checksum,
        },
        "device": str(resolve_device(args.device)),
    }
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def cmd_sweep(args) -> int:
    rows, ok = [], True
    for dr in (float(v) for v in args.drop_rates.split(",")):
        for cr in (float(v) for v in args.corrupt_rates.split(",")):
            cfg = build_cfg(resilience=True, drop_rate=dr, payload_checksum=cr > 0.0, chaos_corrupt_rate=cr)
            losses, summary = run_train(cfg, steps=args.steps, num_workers=args.num_workers, device=args.device)
            finite = _finite(losses)
            ok = ok and finite
            row = {
                "drop_rate": dr, "chaos_corrupt_rate": cr, "first_loss": losses[0], "last_loss": losses[-1],
                "losses_finite": finite, "live_workers_per_step": summary.get("live_workers_per_step"),
                "dropped_steps": summary.get("dropped_steps"), "checksum_failures": summary.get("checksum_failures"),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"ok": ok, "cells": len(rows)}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepreduce_tpu_torch.resilience")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_check = sub.add_parser("check", help="the chaos check")
    p_check.add_argument("--steps", type=int, default=24)
    p_check.add_argument("--num_workers", type=int, default=8)
    p_sweep = sub.add_parser("sweep", help="drop-rate x corrupt-rate grid")
    p_sweep.add_argument("--steps", type=int, default=12)
    p_sweep.add_argument("--num_workers", type=int, default=8)
    p_sweep.add_argument("--drop_rates", type=str, default="0.0,0.125,0.25")
    p_sweep.add_argument("--corrupt_rates", type=str, default="0.0,0.2")
    args = ap.parse_args(argv)
    return cmd_check(args) if args.cmd == "check" else cmd_sweep(args)


if __name__ == "__main__":
    sys.exit(main())
