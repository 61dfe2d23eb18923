"""The port's training driver, the counterpart of `benchmarks/train.py`.

One driver for every model family, configured like the reference: a
``--grace_config`` Python-literal dict with the reference's key names.

    python -m deepreduce_tpu_torch.driver --model resnet20 --num_steps 100 \\
      --grace_config "{'compressor':'topk','compress_ratio':0.01,
                       'memory':'residual','communicator':'allgather',
                       'deepreduce':'both','index':'bloom','value':'polyfit',
                       'fpr':0.001,'policy':'leftmost'}"
    python -m deepreduce_tpu_torch.driver --device cpu --model mlp --num_workers 4 ...

Data is synthetic (shape-correct random batches drawn with numpy from the
JAX driver's streams, so the batches are bitwise JAX's): the driver measures
the framework (step time, wire volume, the mechanics of convergence), not a
dataset's accuracy.

Workers are processes, one a worker (PyTorch's data parallelism). W is
``min(--num_workers, torch.cuda.device_count())`` on the card (JAX's
``min(num_workers, len(jax.devices()))``) and ``--num_workers`` gloo ranks on
the CPU. Under ``torchrun`` (RANK and WORLD_SIZE set), or in a process whose
default group is already up, the driver joins that group; run alone with
W > 1 it spawns the W ranks itself; at W = 1 it runs in the calling process
over a one-rank group (NCCL on the card, gloo on the CPU). Rank r trains on
rows [r B / W, (r + 1) B / W) of the global batch B, as JAX's shard_map over
P('data') gives worker r. `--device cuda` (the default) without a card is an
error, never a quiet fall to the CPU.

Rank 0 prints, tracks (`tracking.Run`: metrics.jsonl, config.json,
summary.json, and with `--telemetry` the tracer's trace.json and with
cfg.ctrl the controller's decisions.jsonl) and returns the result JSON of
the JAX driver. The step reads nothing back from the card: the losses and
wire ratios stay on the device until a step that prints, fetches the
telemetry, checkpoints, or ends the run, where one copy brings them back.
Every rank checkpoints its own state (its residuals are its own) as
`<checkpoint dir>/last/rank<r>.pt`; `--resume` restores them, with the
telemetry accumulator and the controller, and the stochastic draws are
keyed by (cfg.seed, step), so a resumed run continues exactly.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import pathlib
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepreduce_tpu_torch import checkpoint, tracking
from deepreduce_tpu_torch.config import DeepReduceConfig, from_params
from deepreduce_tpu_torch.device import resolve_device
from deepreduce_tpu_torch.models import (
    MLP, VGG16, BertEncoder, DenseNet40, MobileNetV1, NeuMF, ResNet20, ResNet50, WordLSTM)
from deepreduce_tpu_torch.models.ncf import sigmoid_bce_mean
from deepreduce_tpu_torch.telemetry import spans
from deepreduce_tpu_torch.train import Trainer, classification_loss, next_token_loss

MODELS: Dict[str, Callable] = {}


def _register(name: str):
    def deco(fn):
        MODELS[name] = fn
        return fn

    return deco


# each entry: seed -> (model with weights from a torch.Generator seeded by
# it, (input kind, spec, classes)), the JAX driver's kinds, shapes and counts


@_register("resnet20")
def _resnet20(seed: int):
    return ResNet20(seed=seed), ("image", (32, 32, 3), 10)


@_register("densenet40")
def _densenet40(seed: int):
    return DenseNet40(seed=seed), ("image", (32, 32, 3), 10)


@_register("mobilenet")
def _mobilenet(seed: int):
    return MobileNetV1(seed=seed), ("image", (32, 32, 3), 10)


@_register("vgg16")
def _vgg16(seed: int):
    return VGG16(seed=seed), ("image", (32, 32, 3), 10)


@_register("resnet50")
def _resnet50(seed: int):
    return ResNet50(seed=seed), ("image", (224, 224, 3), 1000)


@_register("mlp")
def _mlp(seed: int):
    # the small vector MLP: the fast model for smoke runs and kill / resume
    return MLP(seed=seed), ("vec", (32,), 8)


@_register("ncf")
def _ncf(seed: int):
    return NeuMF(seed=seed), ("ncf", None, None)


@_register("lstm")
def _lstm(seed: int):
    m = WordLSTM(seed=seed)
    return m, ("lm", 20, m.vocab_size)


BERT_VOCAB = 30_522  # BertEncoder's default vocabulary


@_register("bert")
def _bert(seed: int):
    return BertEncoder(vocab_size=BERT_VOCAB, seed=seed), ("lm", 128, BERT_VOCAB)


def make_batch(kind: str, spec, classes, batch: int, rng: np.random.Generator, model=None):
    """The global batch as CPU tensors, drawn from `rng` exactly as the JAX
    driver draws it (the same numpy calls in the same order)."""
    if kind in ("image", "vec"):
        x = torch.from_numpy(rng.normal(size=(batch,) + spec).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, classes, size=batch).astype(np.int64))
        return (x, y)
    if kind == "lm":
        return (torch.from_numpy(rng.integers(0, classes, size=(batch, spec)).astype(np.int64)),)
    if kind == "ncf":
        users = torch.from_numpy(rng.integers(0, model.num_users, size=batch).astype(np.int64))
        items = torch.from_numpy(rng.integers(0, model.num_items, size=batch).astype(np.int64))
        labels = torch.from_numpy(rng.integers(0, 2, size=batch).astype(np.float32))
        return ((users, items), labels)
    raise ValueError(kind)


def make_loss(kind: str, model) -> Callable:
    """batch -> mean loss: softmax cross-entropy for images and vectors, the
    next-token loss (tokens [:, :-1] against [:, 1:]) for language models,
    and NeuMF's sigmoid binary cross-entropy."""
    if kind in ("image", "vec"):
        return classification_loss(model)
    if kind == "lm":
        return next_token_loss(model)
    if kind == "ncf":

        def loss_fn(batch):
            (users, items), labels = batch
            return sigmoid_bce_mean(model(users, items), labels)

        return loss_fn
    raise ValueError(kind)


def _rows(batch, rank: int, world: int, device: torch.device):
    """This rank's rows of every tensor of `batch`, on `device`. On the card
    the copy is from pinned memory and does not block the host."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_rows(b, rank, world, device) for b in batch)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"the global batch of {n} does not split over {world} workers")
    part = batch[rank * n // world : (rank + 1) * n // world]
    if device.type == "cuda":
        return part.pin_memory().to(device, non_blocking=True)
    return part


def _num_workers(args) -> int:
    if args.device == "cuda":
        resolve_device("cuda")  # raises without a card
        return min(args.num_workers, torch.cuda.device_count())
    return args.num_workers


def _per_slice(world: int) -> int:
    """JAX's slice width for cfg.hier without ici_size: the largest s that
    divides W with s * s <= W."""
    return max(s for s in range(1, world + 1) if world % s == 0 and s * s <= world)


def _worker_group(cfg: DeepReduceConfig, group, world: int):
    """What the Trainer exchanges over: the group itself, or with cfg.hier
    and no ici_size the (ici, dcn) pair of JAX's make_hybrid_mesh."""
    if not cfg.hier or cfg.ici_size is not None:
        return group
    from deepreduce_tpu_torch.parallel.mesh import make_hybrid_mesh

    per_slice = _per_slice(world)
    mesh = make_hybrid_mesh(world // per_slice, per_slice, group)
    return mesh["ici"], mesh["dcn"]


def _host_values(tensors) -> list:
    """One device-to-host copy of a list of 0-d tensors."""
    return torch.stack([t.reshape(()).to(torch.float32) for t in tensors]).tolist() if tensors else []


def _train(args, params: Dict[str, Any], cfg: DeepReduceConfig, rank: int, world: int, group,
           device: torch.device, init_params=None) -> dict:
    """The run on this rank; every rank returns the result, rank 0 prints it."""
    lead = rank == 0
    model, (kind, spec, classes) = MODELS[args.model](args.seed)
    if init_params is not None:
        model.load_flax_params({n: torch.tensor(np.asarray(v)) for n, v in init_params.items()})
    trainer = Trainer(model, cfg, lr=args.learning_rate, momentum=0.9, device=device,
                      group=_worker_group(cfg, group, world), loss_fn=make_loss(kind, model))
    state = trainer.init_state()

    tracker = None
    if args.track_dir and lead:
        tracker = tracking.Run(
            args.track_dir,
            name=args.run_name or None,
            config={"model": args.model, "workers": world, **params},
            tags=[t for t in args.tags.split(",") if t],
        )
    if cfg.ctrl and tracker is not None:
        # the auditable decision trail (telemetry trace / summary render it)
        trainer.attach_decision_log(tracker.dir / "decisions.jsonl")

    ckpt_path = None
    if args.checkpoint_every or args.resume:
        ckpt_root = args.checkpoint_dir
        if not ckpt_root and args.track_dir:
            # rank 0 named the run; every rank checkpoints under it
            run_dir = [str(tracker.dir) if tracker is not None else None]
            if world > 1:
                dist.broadcast_object_list(run_dir, src=0, group=group)
            ckpt_root = str(pathlib.Path(run_dir[0]) / "ckpt")
        if not ckpt_root:
            raise ValueError(
                "--checkpoint-every/--resume need --checkpoint-dir (or --track_dir to default under the run "
                "directory)"
            )
        ckpt_path = pathlib.Path(ckpt_root) / "last"
    own_ckpt = None if ckpt_path is None else ckpt_path / f"rank{rank}.pt"

    start_step = 0
    if args.resume and own_ckpt is not None and own_ckpt.exists():
        restored = checkpoint.restore(str(own_ckpt), {"state": state, "telemetry": None, "ctrl": None}, config=cfg)
        state = restored["state"]
        if cfg.telemetry:
            # the accumulator resumes too: summaries keep counting from the
            # killed run's totals
            trainer.telemetry = restored["telemetry"]
        if cfg.ctrl:
            # rung, vote streaks and window baseline: the trail resumes bitwise
            trainer.load_controller_state(restored["ctrl"])
        start_step = int(state.step)
        if lead:
            print(f"resumed from {ckpt_path} at step {start_step}", flush=True)

    losses, pending = [], []  # device scalars; pending: (step, loss, rel_volume) not yet tracked
    wire = None
    profiler = None
    profile_dir = args.profile_dir
    if profile_dir and args.num_steps < 3:
        if lead:
            print(f"WARNING: --profile_dir needs num_steps >= 3 to skip the warm-up steps (got "
                  f"{args.num_steps}); profiling disabled", flush=True)
        profile_dir = ""

    def flush(extra: Optional[dict] = None) -> None:
        """Track the pending steps with one copy of their values; `extra`
        joins the last one's record."""
        values = _host_values([t for _, l, r in pending for t in (l, r)])
        for i, (step, _, _) in enumerate(pending):
            rec = {"loss": values[2 * i], "rel_volume": values[2 * i + 1]}
            if extra and i == len(pending) - 1:
                rec.update(extra)
            tracker.log(rec, step=step)
        pending.clear()

    def stop_profiler() -> None:
        if profiler is not None:
            profiler.stop()
            pathlib.Path(profile_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(pathlib.Path(profile_dir) / f"rank{rank}.trace.json"))

    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.num_steps):
            if profile_dir and step == start_step + 2 and profiler is None:
                # past the warm-up steps (kernel builds, lazy CUDA set-up)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            batch = _rows(make_batch(kind, spec, classes, args.batch_size,
                                     np.random.default_rng((args.seed, 1, step)), model=model),
                          rank, world, device)
            with spans.span("train/step"):
                state, loss, wire = trainer.step(state, batch)
            losses.append(loss)
            if own_ckpt is not None and args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
                payload = {"state": state}
                if cfg.telemetry:
                    payload["telemetry"] = trainer.telemetry
                if cfg.ctrl:
                    payload["ctrl"] = trainer.controller_state()
                own_ckpt.parent.mkdir(parents=True, exist_ok=True)
                checkpoint.save(str(own_ckpt), payload, config=cfg)
            if tracker is not None:
                pending.append((step, loss, wire.rel_volume()))
                if cfg.telemetry and (step % cfg.telemetry_every == 0 or step == args.num_steps - 1):
                    # the telemetry_every fetch of the on-device accumulators
                    flush({f"telemetry.{k}": v for k, v in trainer.telemetry_summary().items()})
            if args.log_every and step % args.log_every == 0 and lead:
                loss_v, rel_v = _host_values([loss, wire.rel_volume()])
                print(f"step {step} loss {loss_v:.4f} rel_volume {rel_v:.4f}", flush=True)
        host_losses = _host_values(losses)  # waits for the last step
        if tracker is not None and pending:
            flush()
    except BaseException:
        stop_profiler()
        if tracker is not None:
            try:
                if cfg.telemetry:
                    # a failing run still gets its trace: spans record on
                    # exit, so the aborted step's phases are all present
                    spans.get_tracer().save(tracker.dir / "trace.json")
                flush()  # the completed steps' records
            finally:
                tracker.finish({"status": "failed", "steps_completed": len(losses)})
        raise
    stop_profiler()
    elapsed = time.perf_counter() - t0

    if not losses:
        # resumed at or past --num_steps: nothing left to run
        result = {"model": args.model, "workers": world, "steps": 0, "resumed_at": start_step, "config": params}
        if lead:
            print(json.dumps(result), flush=True)
        if tracker is not None:
            tracker.finish(result)
        return result

    rel, idx_rel, val_rel = _host_values([wire.rel_volume(), wire.idx_rel_volume(), wire.val_rel_volume()])
    result = {
        "model": args.model,
        "workers": world,
        "steps": args.num_steps,
        "resumed_at": start_step,
        "global_batch": args.batch_size,
        "first_loss": host_losses[0],
        "last_loss": host_losses[-1],
        "examples_per_sec": args.batch_size * len(losses) / elapsed,
        "rel_volume": rel,
        "idx_rel_volume": idx_rel,
        "val_rel_volume": val_rel,
        "payload_bytes_per_step": trainer.exchanger.payload_bytes(),
        "config": params,
    }
    if cfg.telemetry:
        result["telemetry"] = trainer.telemetry_summary()
        if tracker is not None:
            spans.get_tracer().save(tracker.dir / "trace.json")
    if cfg.ctrl:
        ctrl = trainer.controller
        result["ctrl"] = {
            "index": int(ctrl.index),
            "ladder": list(ctrl.ladder.labels()),
            "windows": int(ctrl.windows),
            "switches": int(ctrl.switches),
            "effective_ratio": ctrl.effective_ratio(),
            "visited_indices": list(trainer.visited_ladder_indices),
        }
    if lead:
        print(json.dumps(result), flush=True)
    if tracker is not None:
        tracker.finish(result)
    return result


def _rank_device(kind: str, index: Optional[int] = None) -> torch.device:
    """This rank's device: card `index` (the current one when None), made
    current, or the CPU. Raises without a card when the card is asked for."""
    if kind != "cuda":
        return torch.device("cpu")
    resolve_device("cuda")
    device = torch.device("cuda", torch.cuda.current_device() if index is None else index)
    torch.cuda.set_device(device)
    return device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_run(args, params, cfg, rank: int, world: int, device: torch.device, init_params) -> dict:
    """`_train` on the default group, with the tracer on for telemetry runs
    and set back off afterwards (it is global to the process)."""
    tracing = cfg.telemetry and not spans.enabled()
    if tracing:
        spans.configure(enabled=True)
    try:
        return _train(args, params, cfg, rank, world, dist.group.WORLD, device, init_params)
    finally:
        if tracing:
            spans.configure(enabled=False, reset=True)


SPAWN_GRACE_S = 30.0  # how long spawned ranks get to exit once the run is over or one rank failed


class RankError(RuntimeError):
    """A spawned rank failed: the rank, its exception's type and message."""


def _spawned_rank(rank: int, world: int, store_path: str, args, params, init_params, results) -> None:
    """The body of one spawned rank: join the group through the file store,
    train, and put ("ok", rank, result) or ("error", rank, message) on
    `results`."""
    try:
        cfg = from_params(params)
        device = _rank_device(args.device, rank)
        if device.type == "cpu":
            # W ranks share the host's cores: no rank oversubscribes them
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(_backend(device), store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(minutes=10))
        try:
            result = _rank_run(args, params, cfg, rank, world, device, init_params)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, result if rank == 0 else None))
    except BaseException as e:
        results.put(("error", rank, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        raise SystemExit(1)


def _spawn(args, params, world: int, init_params) -> dict:
    """Run W spawned ranks to their end; rank 0's result, or RankError when
    a rank fails (the others then get SPAWN_GRACE_S to exit before they are
    stopped)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="drtorch_driver_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned_rank, args=(r, world, store, args, params, init_params, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        result, error = None, None
        try:
            done = set()
            while len(done) < world and error is None:
                try:
                    kind, rank, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
                    if dead:
                        # a rank that died without reporting (killed, out of memory)
                        error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                    continue
                done.add(rank)
                if kind == "error":
                    error = f"rank {rank} failed: {payload}"
                elif rank == 0:
                    result = payload
        finally:
            # the ranks finish on their own (a failed rank 0 still writes its
            # tracked run's record); one left waiting in a collective on a
            # dead peer is stopped after the grace period
            deadline = time.monotonic() + SPAWN_GRACE_S
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                try:
                    results.get(timeout=0.5)  # what the ranks still send: drained before the join
                except queue.Empty:
                    pass
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    if error is not None:
        raise RankError(error)
    return result


def run(args, *, init_params: Optional[Dict[str, Any]] = None) -> dict:
    """Train `args.model` under `args.grace_config` and return the result
    JSON (printed by rank 0). `init_params` (flax name -> array) replaces the
    model's own initial weights: the parity tests start from the JAX
    package's this way."""
    params = ast.literal_eval(args.grace_config) if args.grace_config else {}
    # --telemetry lands before construction: validation is cross-field
    # (ctrl=True requires telemetry=True)
    if args.telemetry:
        params.setdefault("telemetry", True)
    # every key must be a knob: a typo'd one kills the run with its name
    cfg = from_params(params)
    if args.model not in MODELS:
        raise ValueError(f"unknown model {args.model!r} (models: {sorted(MODELS)})")
    if dist.is_initialized():
        # a caller's group (torchrun's, or one set up around this call)
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.num_workers < world:
            raise ValueError(f"--num_workers {args.num_workers} is below the group's {world} ranks")
        device = _rank_device(args.device)
        return _rank_run(args, params, cfg, rank, world, device, init_params)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # torchrun: one process a worker, the group from its environment
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if args.num_workers < world:
            raise ValueError(f"--num_workers {args.num_workers} is below torchrun's {world} ranks")
        device = _rank_device(args.device, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend(device), init_method="env://", rank=rank, world_size=world)
    else:
        world = _num_workers(args)
        if world < 1:
            raise ValueError(f"--num_workers {args.num_workers} leaves no worker")
        if world > 1:
            return _spawn(args, params, world, init_params)
        rank = 0
        device = _rank_device(args.device)
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _rank_run(args, params, cfg, rank, world, device, init_params)
    finally:
        dist.destroy_process_group()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m deepreduce_tpu_torch.driver", description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet20")
    ap.add_argument("--grace_config", type=str, default="")
    ap.add_argument("--num_steps", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--learning_rate", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=5)
    ap.add_argument("--track_dir", type=str, default="",
                    help="experiment-tracking root (the reference's WANDB role)")
    ap.add_argument("--run_name", type=str, default="")
    ap.add_argument("--tags", type=str, default="",
                    help="comma-separated run tags (--extra_wandb_tags role)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable telemetry: span tracing (trace.json in the run dir when --track_dir is set) plus "
                         "on-device metric accumulators fetched every cfg.telemetry_every steps. trace.json's ts are "
                         "µs from the Unix epoch, the profiler's clock: a span's ts is its range's ts in "
                         "--profile_dir's rank<r>.trace.json plus that file's baseTimeNanoseconds / 1000")
    ap.add_argument("--profile_dir", type=str, default="",
                    help="write a torch.profiler trace (rank<r>.trace.json) of the steps from the third on")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every rank's train state (params, optimizer state, residual memory, telemetry "
                         "accumulator, controller) every N steps via deepreduce_tpu_torch.checkpoint (0 = off)")
    ap.add_argument("--checkpoint-dir", type=str, default="",
                    help="checkpoint directory (defaults to <run dir>/ckpt when --track_dir is set)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the last checkpoint in the checkpoint dir if one exists (config-fingerprint "
                         "checked); batches are regenerated per step from --seed, so a killed run continues "
                         "exactly")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="'cuda' (default; an error without a card) or 'cpu' (gloo ranks)")
    return ap


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
