"""One run of one cell: `python -m h100bench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`, from the checkout's root.

Set-up builds the port's `Trainer` as the port's driver builds it (the
configuration's model class with weights made from the seed on the card,
its loss, `DeepReduceConfig` of the traffic's knobs, an NCCL group of the
cell's ranks), makes the ring of input batches from the seed, and drives the
first `steps_checked` steps through `Trainer.step` on distinct batches,
reading what the reference will be held to. That is also the warm-up: every
shape the window uses has run. The window then runs `Trainer.step` in a
closed loop for `--seconds`, with one synchronise before the first timed
step and one after the last. With `--trace 1` a few more steps run under the
profiler. After the window the program is freed, the plain reference
follows the same first steps from the same weights and inputs, and the gaps
between the two decide `correct` (`check.py`).

Prints one JSON line last on standard output; the compared numbers and
their limits are the last lines on standard error. Exits 2 without a result
when the card or the port is missing, 3 when JAX or the JAX package was
loaded."""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up runs from here: the interpreter has just started

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepreduce_tpu")


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own kernels into `deepreduce_tpu_torch/_build/`, also inside it)."""
    cache = ROOT / ".h100bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port's run must not load,
    compared whole (`deepreduce_tpu_torch` is not `deepreduce_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(bench: dict, workload: str):
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, load_json(ROOT / cfg_entry["file"]), load_json(HERE / "traffic" / f"{wl['traffic']}.json")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_group(device):
    """A one-rank process group on this card (NCCL) or CPU (gloo), so that
    the step's collectives run."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


def knobs_of(traffic: dict, seed: int) -> dict:
    return dict(traffic["knobs"], seed=int(seed) & 0x7FFFFFFF)


def norms(tree):
    import torch

    return {n: torch.linalg.vector_norm(t.detach().float()) for n, t in tree.items()}


def setup_program(config: dict, traffic: dict, seed: int, device, group, *, workers: int = 1, laps=None):
    """(trainer, state, ring, the program's readings over the first steps).
    `laps` (a dict) receives the seconds of each part of the set-up."""
    laps = {} if laps is None else laps
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        laps[name] = now - t
        t = now

    import torch

    from deepreduce_tpu_torch import DeepReduceConfig, Trainer, models
    from deepreduce_tpu_torch import train as port_train

    from h100bench import reference
    from h100bench.traffic import make_ring, make_tensors

    lap("import")
    mod = reference.model_module(config)
    specs, sspecs = mod.param_specs(config), mod.stat_specs(config)
    prog = config["program"]
    kwargs = {k: getattr(torch, v) if k == "dtype" else v for k, v in prog["kwargs"].items()}
    model = getattr(models, prog["class"])(**kwargs).to(device)
    model.load_flax_params(make_tensors(specs, seed, device))
    if sspecs:
        model.load_flax_batch_stats(make_tensors(sspecs, seed, device))
    lap("model_and_weights")
    cfg = DeepReduceConfig(**knobs_of(traffic, seed))
    opt = traffic["optimizer"]
    trainer = Trainer(model, cfg, lr=opt["lr"], momentum=opt["momentum"], device=device, group=group,
                      loss_fn=getattr(port_train, prog["loss"])(model))
    state = trainer.init_state()
    lap("trainer_and_exchanger")
    ring = make_ring(config, traffic, workers, seed, device)
    lap("input_ring")
    losses, first = [], None
    for s in range(traffic["steps_checked"]):
        state, loss, _ = trainer.step(state, ring[s % len(ring)][0])
        losses.append(loss)
        if s == 0:
            first = norms({n: state.optimizer.state[p]["momentum_buffer"] for n, p in state.params.items()})
    lap("first_steps")
    p0 = make_tensors(specs, seed, device)
    out = {"loss": losses, "first": first, "change": norms({n: p.detach() - p0[n] for n, p in state.params.items()})}
    del p0
    if state.residuals is not None:
        out["residual"] = norms(state.residuals)
    if sspecs:
        s0 = make_tensors(sspecs, seed, device)
        out["stats"] = norms({n: s - s0[n] for n, s in state.batch_stats.items()})
    out = reference.to_host(out)
    lap("readings")
    return trainer, state, ring, out


def reference_readings(config, traffic, seed, ring, device, *, precision="config", fault=None) -> dict:
    from h100bench import reference
    from h100bench.traffic import make_tensors

    mod = reference.model_module(config)
    params0 = make_tensors(mod.param_specs(config), seed, device)
    stats0 = make_tensors(mod.stat_specs(config), seed, device)
    steps = [ring[s % len(ring)] for s in range(traffic["steps_checked"])]
    return reference.run(config, traffic, knobs_of(traffic, seed), params0, stats0, steps, precision=precision,
                         fault=fault)


def free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reader_context(config, traffic, rate, digest, device) -> dict:
    """What the per-layer readers read: the traced digest, the untraced
    window's rate, the configuration's FLOPs a sample, the peak of the
    step's precision on this card (TF32 where the card's setting turns it
    on; none off the card) and the cell's QSGD table bytes (none without
    QSGD)."""
    import torch

    from h100bench import reference
    from h100bench.counts.qsgd_table_bytes import table_bytes

    peaks = load_json(HERE / "peaks.json")
    counts = importlib.import_module(f"h100bench.counts.{config['name']}")
    precision = config["compute_dtype"]
    if precision == "float32" and torch.backends.cuda.matmul.allow_tf32:
        precision = "tf32"
    specs = reference.model_module(config).param_specs(config)
    ex = reference.exchange_for(traffic, {n: s for n, s, _, _ in specs}, traffic["knobs"], 1)
    segs = ex.qsgd_segments() if hasattr(ex, "qsgd_segments") else []
    return {"digest": digest, "rate": rate, "flops_per_sample": counts.flops_per_sample(config, traffic),
            "peak_flops": peaks["flops_per_s"][precision] if device.type == "cuda" else None,
            "hbm_bytes_per_s": peaks["hbm_bytes_per_s"],
            "qsgd_table_bytes": table_bytes(segs, traffic["knobs"].get("bucket_size", 512)) if segs else None}


def _metric_listed(m: dict, workload: str) -> bool:
    return "workloads" not in m or workload in m["workloads"]


def base_name(m: dict) -> str:
    """The quantity a metric measures: its name before the first dot. A
    quantity split by the end-to-end metric it moves (`mfu` and `mfu.dense`)
    has one reader, `metrics/<quantity>.py`."""
    return m["name"].split(".", 1)[0]


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float, trace: bool, device,
             config: dict = None, traffic: dict = None, laps: dict = None) -> tuple:
    """(the result line's object, the compared numbers, their limits).
    `laps` holds the seconds of the set-up's parts so far."""
    import torch

    from h100bench import check, trace as tracing
    from h100bench.wire import WireCounter

    wl, cfg_file, traffic_file = load_cell(bench, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    workers = wl["chips"]
    wire = WireCounter().install()
    laps = dict(laps or {})
    t = time.perf_counter()
    group = init_group(device)
    laps["process_group"] = time.perf_counter() - t
    trainer, state, ring, prog = setup_program(config, traffic, seed, device, group, workers=workers, laps=laps)
    box = {"state": state, "i": traffic["steps_checked"]}

    def step():
        box["state"], _, _ = trainer.step(box["state"], ring[box["i"] % len(ring)][0])
        box["i"] += 1

    _sync(device)
    setup_s = time.perf_counter() - _T0
    wire.reset()
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        step()
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    n = len(marks) - 1
    rate = n * traffic["batch_per_worker"] * workers / elapsed  # a sample: one image or one sequence
    wire_per_step = wire.bytes / n
    metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        digest = tracing.digest(tracing.profile_steps(step, traffic.get("profiled_steps", 2), lambda: _sync(device)))
        ctx = reader_context(config, traffic, rate, digest, device)
        for m in bench["per_layer"]:
            if _metric_listed(m, workload):
                value = importlib.import_module(f"h100bench.metrics.{base_name(m)}").read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": digest["busy_ns"] / 1e9, "window_s": digest["window_ns"] / 1e9}
        breakdown = tracing.breakdown(digest)
    else:
        e2e = {"samples_per_s": rate, "wire_bytes_per_step": wire_per_step, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if _metric_listed(m, workload) and base_name(m) in e2e:
                metrics[m["name"]] = {"value": e2e[base_name(m)], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print("h100bench: set-up s " + json.dumps(laps) + f"; window {n} steps in {elapsed:.3f} s, host ms a step "
          + json.dumps([round((b - a) * 1e3, 1) for a, b in zip(marks, marks[1:])]), file=sys.stderr)
    wire.uninstall()
    del trainer, state, box, step
    free()
    t_ref = time.perf_counter()
    ref = reference_readings(config, traffic, seed, ring, device)
    print(f"h100bench: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    numbers = check.gaps(prog, ref)
    limits = check.limits_for(workload)
    result = {
        "correct": check.judge(numbers, limits),
        "attempted": n,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": workers,
            "memory_peak_bytes": peak,
            **dev_extra,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result, numbers, limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_json(ROOT / "BENCHMARK.json")
    wl, _, _ = load_cell(bench, args.workload)
    import torch

    laps = {"interpreter_and_torch_import": time.perf_counter() - _T0}

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"h100bench: the cell needs {wl['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if wl["chips"] != 1:
        print("h100bench: this harness runs one-card cells only", file=sys.stderr)
        return 2
    try:
        importlib.import_module("deepreduce_tpu_torch")
    except ImportError as e:
        print(f"h100bench: the program under test is missing: {e}", file=sys.stderr)
        return 2
    laps["port_import"] = time.perf_counter() - _T0 - laps["interpreter_and_torch_import"]
    # one host thread for PyTorch's own CPU work: the step runs on the card, and
    # idle pool threads only contend with the launching thread for the host's cores
    torch.set_num_threads(1)
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    laps["cuda_context"] = time.perf_counter() - t
    result, numbers, limits = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                                       trace=bool(args.trace), device=device, laps=laps)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {found}; the port's benchmark loads no JAX and no JAX package",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"checked {k}: {v!r} limit {limits.get(k)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
