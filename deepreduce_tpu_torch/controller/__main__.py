"""Controller CLI: the adaptive-run check, ported from
`deepreduce_tpu/controller/__main__.py` (`make ctrl-check`).

    python -m deepreduce_tpu_torch.controller check                 # W = 1 on the card
    python -m deepreduce_tpu_torch.controller --device cpu check --num_workers 4

`check` runs a short adaptive train of the JAX check's synthetic MLP task
(one worker on the card, or W in-process workers of one
`collectives.InProcessGroup`) with a mid-run checkpoint, then a second run
that resumes from it, and asserts:

* ``decisions.jsonl`` is non-empty and every record validates against
  `DECISION_SCHEMA`;
* the controller moved (at least one switch), and the exchangers built
  equal the rungs visited;
* the resumed run replays the decision trail bitwise (its decisions are
  byte-identical JSON to the same-step records of the uninterrupted run)
  and ends on bitwise the same parameters.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

import torch

from deepreduce_tpu_torch import checkpoint
from deepreduce_tpu_torch.collectives import InProcessGroup
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.controller import DecisionLog, validate_decision
from deepreduce_tpu_torch.device import resolve_device
from deepreduce_tpu_torch.resilience.__main__ import BATCH, MLP, make_data
from deepreduce_tpu_torch.train import Trainer


def build_cfg(**overrides) -> DeepReduceConfig:
    """The JAX check's config: bloom index at top-k 0.05, telemetry every 5
    steps, the ladder 0.01 / 0.02 / 0.05 with hysteresis 1."""
    base = dict(
        deepreduce="index",
        index="bloom",
        compress_ratio=0.05,
        fpr=0.01,
        memory="residual",
        min_compress_size=100,
        telemetry=True,
        telemetry_every=5,
        ctrl=True,
        ctrl_ladder="0.01,0.02,0.05",
        ctrl_hysteresis=1,
        ctrl_target_err_cos=0.3,
        ctrl_headroom=0.12,
    )
    base.update(overrides)
    return DeepReduceConfig(**base)


def run_train(cfg: DeepReduceConfig, *, steps: int, num_workers: int, device="cuda", seed: int = 0,
              lr: float = 0.1, log_path=None, ckpt_dir=None, ckpt_at=None, resume_from=None):
    """A deterministic adaptive train: batches are a pure function of
    (seed, step), so an uninterrupted run and a resumed one see the same
    data. Worker 0 writes the decision log; each worker checkpoints its own
    state (its residuals are its own) as `<dir>/rank<r>.pt`. Returns
    (losses, worker 0's trainer, worker 0's final state)."""
    dev = resolve_device(device)
    x, y = make_data(seed)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    if BATCH % num_workers:
        raise ValueError(f"the batch of {BATCH} does not split over {num_workers} workers")
    shard = BATCH // num_workers

    def worker(coll):
        trainer = Trainer(MLP(seed=seed), cfg, lr=lr, momentum=0.9, device=dev, group=coll)
        if log_path is not None and coll.rank == 0:
            trainer.attach_decision_log(log_path)
        state = trainer.init_state()
        if resume_from is not None:
            restored = checkpoint.restore(
                str(pathlib.Path(resume_from) / f"rank{coll.rank}.pt"),
                {"state": state, "telemetry": None, "ctrl": None}, config=cfg,
            )
            state = restored["state"]
            trainer.telemetry = restored["telemetry"]
            trainer.load_controller_state(restored["ctrl"])
        losses = []
        for step in range(state.step, steps):
            lo = (step * BATCH) % (512 - BATCH) + coll.rank * shard
            state, loss, _ = trainer.step(state, (x[lo : lo + shard], y[lo : lo + shard]))
            losses.append(loss)
            if ckpt_dir is not None and ckpt_at == step + 1:
                checkpoint.save(
                    str(pathlib.Path(ckpt_dir) / f"rank{coll.rank}.pt"),
                    {"state": state, "telemetry": trainer.telemetry, "ctrl": trainer.controller_state()},
                    config=cfg,
                )
        return [float(l) for l in losses], trainer, state

    if num_workers == 1:
        from deepreduce_tpu_torch.collectives import collectives_for

        return worker(collectives_for(None))
    return InProcessGroup(num_workers).run(worker)[0]


def cmd_check(args) -> int:
    cfg = build_cfg(ctrl_target_err_cos=args.target_err_cos)
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="drtorch_ctrl_check_"))
    try:
        full_log = workdir / "full" / "decisions.jsonl"
        resume_log = workdir / "resume" / "decisions.jsonl"
        ckpt = workdir / "ckpt"
        ckpt.mkdir()
        ckpt_at = args.steps // 2
        kw = dict(steps=args.steps, num_workers=args.num_workers, device=args.device)
        losses, trainer, state = run_train(cfg, log_path=full_log, ckpt_dir=ckpt, ckpt_at=ckpt_at, **kw)
        _, _, state2 = run_train(cfg, log_path=resume_log, resume_from=ckpt, **kw)

        full = DecisionLog.read(full_log)
        resumed = DecisionLog.read(resume_log)
        schema_ok = True
        try:
            for rec in full + resumed:
                validate_decision(rec)
        except ValueError as e:
            schema_ok = False
            print(f"schema violation: {e}", file=sys.stderr)
        # the boundary at ckpt_at fires at the start of the next step, after
        # the checkpoint was taken, so both runs record it
        tail = [r for r in full if r["step"] >= ckpt_at]
        replay_ok = [json.dumps(r, sort_keys=True) for r in tail] == [
            json.dumps(r, sort_keys=True) for r in resumed
        ]
        params_ok = sorted(state.params) == sorted(state2.params) and all(
            torch.equal(state.params[n].detach().cpu(), state2.params[n].detach().cpu()) for n in state.params
        )
        checks = {
            "losses_finite": all(l == l and abs(l) != float("inf") for l in losses),
            "decisions_nonempty": len(full) > 0,
            "decisions_schema_valid": schema_ok,
            "controller_switched": trainer.controller.switches >= 1,
            "exchangers_built_eq_rungs_visited": len(trainer.visited_ladder_indices)
            == len({r["old_index"] for r in full} | {r["new_index"] for r in full} | {trainer.controller.index}),
            "resume_replays_bitwise": replay_ok,
            "resume_params_bitwise": params_ok,
        }
        report = {
            "ok": all(checks.values()),
            "checks": checks,
            "steps": len(losses),
            "decisions": len(full),
            "switches": int(trainer.controller.switches),
            "visited_indices": list(trainer.visited_ladder_indices),
            "effective_ratio": trainer.controller.effective_ratio(),
            "trail": [f"{r['step']}: {r['old_index']}->{r['new_index']} ({r['rationale']})" for r in full
                      if r["switched"]],
            "device": str(resolve_device(args.device)),
            "num_workers": args.num_workers,
            "config": {
                "ctrl_ladder": cfg.ctrl_ladder,
                "ctrl_target_err_cos": cfg.ctrl_target_err_cos,
                "ctrl_hysteresis": cfg.ctrl_hysteresis,
                "telemetry_every": cfg.telemetry_every,
            },
        }
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepreduce_tpu_torch.controller")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_check = sub.add_parser("check", help="adaptive-run check")
    p_check.add_argument("--steps", type=int, default=40)
    p_check.add_argument("--num_workers", type=int, default=1)
    p_check.add_argument("--target_err_cos", type=float, default=0.3)
    args = ap.parse_args(argv)
    return cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
