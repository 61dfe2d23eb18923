"""The readings that set the limits of `correct`, on the card at a cell's
own size: `python -m h100bench.calibrate --workload <cell> --seeds 1,2,...
[--control-seeds ...] [--fault-seeds ...]`.

For every seed, in one process: the program's first steps against the
reference (the lower readings: sound runs); for each control seed, the
reference computed one precision below the configuration's
(`control_precision`: fp8 below bfloat16, TF32 below float32) put in the
program's place; for each fault seed, the reference with half of every
batch left out, the mean taken over the rest. A step that returns its state
unchanged reads 1 on `change` by definition and needs no run. Prints one
JSON line a reading and a summary line: the largest sound reading and the
smallest control and fault readings of each number. The benchmark's own
runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys

from h100bench import check, run


def readings(workload: str, seeds, control_seeds, fault_seeds, device, *, config=None, traffic=None) -> dict:
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, cfg_file, traffic_file = run.load_cell(bench, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    group = run.init_group(device)
    out = {"program": [], "control": [], "fault": []}
    for seed in seeds:
        trainer, state, ring, prog = run.setup_program(config, traffic, seed, device, group)
        del trainer, state
        run.free()
        ref = run.reference_readings(config, traffic, seed, ring, device)
        out["program"].append({"seed": seed, **check.gaps(prog, ref)})
        print(json.dumps({"kind": "program", **out["program"][-1]}), flush=True)
        if seed in control_seeds:
            ctl = run.reference_readings(config, traffic, seed, ring, device, precision=config["control_precision"])
            out["control"].append({"seed": seed, **check.gaps(ctl, ref)})
            print(json.dumps({"kind": "control", **out["control"][-1]}), flush=True)
        if seed in fault_seeds:
            bad = run.reference_readings(config, traffic, seed, ring, device, fault="half_batch")
            out["fault"].append({"seed": seed, **check.gaps(bad, ref)})
            print(json.dumps({"kind": "fault_half_batch", **out["fault"][-1]}), flush=True)
        del ring
        run.free()
    summary = {}
    for kind, pick in (("program", max), ("control", min), ("fault", min)):
        rows = out[kind]
        if rows:
            summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0] if k != "seed"}
    out["summary"] = summary
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("h100bench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = readings(args.workload, ints(args.seeds), set(ints(args.control_seeds)), set(ints(args.fault_seeds)),
                   device)
    torch.distributed.destroy_process_group()
    print(json.dumps({"kind": "summary", "workload": args.workload, **res["summary"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
