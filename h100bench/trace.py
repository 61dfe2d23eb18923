"""The traced stretch of a run and its digest.

`profile_steps` runs a few steps under `torch.profiler` (host and device
activities) with the port's spans on, and reads the raw Kineto events,
without building the profiler's per-op tables (tens of seconds for a step
of 50,000 launches). `digest` turns them into:

- `device`: every device operation (kernel, copy, set) as (start, end,
  label, the port span its launch was made in), from the correlation of
  the device event with its runtime launch on the host; the label is the
  kernel's name after the host operator that launched it;
- `spans`: the host intervals of every port span (`record_function`
  ranges) by name;
- `busy_ns`: the union of the device operations' intervals inside the
  window, and the idle gaps between them, each named by the innermost span
  the host was in when the gap began.
All times are nanoseconds on the profiler's clock."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

STEP_SPAN = "h100bench/step"
# the port's spans that attribute device work to a layer
ATTRIBUTED = ("train/forward_backward", "train/exchange", "train/apply_updates")


def profile_steps(step: Callable[[], None], steps: int, sync: Callable[[], None]) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from deepreduce_tpu_torch.telemetry import spans

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    spans.configure(enabled=True, reset=True)
    sync()
    try:
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            for _ in range(steps):
                with record_function(STEP_SPAN):
                    step()
            sync()
            t1 = time.time_ns()
    finally:
        spans.configure(enabled=False, reset=True)
    return {"events": prof.profiler.kineto_results.events(), "window": (t0, t1), "steps": steps}


def digest(raw: dict) -> dict:
    t0, t1 = raw["window"]
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    launches: Dict[int, int] = {}
    ops: Dict[int, str] = {}
    dev = []
    for e in raw["events"]:
        is_cpu = e.device_type() == torch.autograd.DeviceType.CPU
        name = e.name()
        if is_cpu:
            if e.is_user_annotation():
                spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = e.start_ns()
            else:
                ops[e.correlation_id()] = name
        elif not e.is_user_annotation():
            label = _short(name)
            op = ops.get(e.linked_correlation_id())
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), f"{op}: {label}" if op else label,
                        e.correlation_id()))
    for v in spans.values():
        v.sort()
    starts = {n: [a for a, _ in v] for n, v in spans.items()}

    def inside(name: str, ts: int) -> bool:
        i = bisect.bisect_right(starts.get(name, []), ts) - 1
        return i >= 0 and spans[name][i][1] >= ts

    device = []
    for a, b, name, corr in dev:
        ts = launches.get(corr)
        owner = next((s for s in ATTRIBUTED if ts is not None and inside(s, ts)), None)
        device.append((a, b, name, owner))
    device.sort()
    busy, gaps = _union(device, t0, t1, spans)
    return {"device": device, "spans": dict(spans), "window_ns": t1 - t0, "busy_ns": busy, "gaps": gaps,
            "steps": raw["steps"]}


def _short(kernel: str) -> str:
    """A kernel's name without its return type, template arguments and
    namespaces: `void at::native::reduce_kernel<...>(...)` -> `reduce_kernel`."""
    if kernel.startswith(("Memcpy", "Memset")):
        return kernel
    head = kernel.replace("(anonymous namespace)::", "").split("<", 1)[0].split("(", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1] or kernel[:64]


def _name_gaps(spans, gaps) -> List[Tuple[str, int]]:
    """Each gap (start, end) named by the innermost span the host was in at
    its start: one sweep over the spans (nested on the host's thread) in
    start order, keeping the stack of those still open."""
    ivs = sorted((a, b, n) for n, v in spans.items() for a, b in v)
    out, stack, i = [], [], 0
    for a, b in sorted(gaps):
        while i < len(ivs) and ivs[i][0] <= a:
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        open_ = [s for s in stack if s[1] >= a]
        out.append((open_[-1][2] if open_ else "host: outside the port's spans", b - a))
    return out


def _union(device, t0: int, t1: int, spans) -> Tuple[int, List[Tuple[str, int]]]:
    busy, cur_a, cur_b, gaps = 0, None, None, []
    prev_end = t0
    for a, b, _, _ in device:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                prev_end = cur_b
            if a > prev_end:
                gaps.append((prev_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        prev_end = cur_b
    if t1 > prev_end:
        gaps.append((prev_end, t1))
    return busy, _name_gaps(spans, gaps)


def breakdown(d: dict) -> dict:
    """The ten device operations that took most time, and the ten largest
    sums of idle time by what the host was doing, in seconds."""
    by_op: Dict[str, int] = defaultdict(int)
    for a, b, name, _ in d["device"]:
        by_op[name[:120]] += b - a
    idle: Dict[str, int] = defaultdict(int)
    for name, ns in d["gaps"]:
        idle[name] += ns
    top = lambda m: [[k, v / 1e9] for k, v in sorted(m.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}
