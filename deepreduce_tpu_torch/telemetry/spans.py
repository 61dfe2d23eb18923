"""Host-side hierarchical span tracing, ported from
`deepreduce_tpu/telemetry/spans.py`.

`span("exchange/encode", route="fused")` is a context manager that

- records a Chrome-trace-event "X" (complete) event with the JAX package's
  schema (name, cat, ph, ts and dur in µs, pid, tid, and the route under
  `args`), so the accumulated ``{"traceEvents": [...]}`` loads in Perfetto
  and `costmodel.calibrate` reads it as it reads the JAX package's traces;
- enters `torch.profiler.record_function(name)`, so the same name labels a
  `torch.profiler` trace.

Recording happens on exit whether or not the body raised.

One clock with the profiler: an event's `ts` is `time.time_ns()` at the
span's start, in µs from the Unix epoch, the clock `torch.profiler` stamps
its events on (the duration is read from `time.perf_counter()`). A span in
this tracer's trace.json therefore lines up with the same
`record_function` range of a profiler trace exported by
`export_chrome_trace` (the driver's `--profile_dir` rank<r>.trace.json) at

    ts_tracer ≈ ts_profiler + baseTimeNanoseconds / 1000

where `baseTimeNanoseconds` is the profiler file's own key (its `ts` are µs
after that base), and with the raw Kineto events at `start_ns() / 1000`.

When the module tracer is disabled (the default) `span()` returns one
shared inert context manager: no clock read, no profiler range, no
allocation. A telemetry-off step therefore runs exactly the ops and makes
exactly the launches it makes without this module.

A span times the HOST. In eager PyTorch the body enqueues its kernels and
returns; the span does not wait for the device to run them, and no span
may add a sync to find out (it would stall the stream the step keeps
busy). On a host-bound step, where the card idles most of the step, host
time is most of the step; where the device is the bottleneck, a later
span absorbs the wait of whatever first blocks (a copy to the host, a
collective's wait).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from torch.profiler import record_function


class _Span:
    """One live span: wall clock + profiler range."""

    __slots__ = ("_tracer", "name", "route", "_ns", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, route: Optional[str] = None):
        self._tracer = tracer
        self.name = name
        self.route = route

    def __enter__(self) -> "_Span":
        # the clocks are read around the profiler range, so that the range's
        # own cost is this span's time and not its parent's
        self._ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        # recorded unconditionally: a raising body still reports its time
        try:
            self._range.__exit__(*exc)
        finally:
            self._tracer._record(self.name, self._ns, time.perf_counter() - self._t0, route=self.route)
        return False


class _NullSpan:
    """The disabled path: one shared, stateless, inert context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Accumulates Chrome-trace-event records (µs, `ts` from the Unix epoch;
    "X" complete events and "C" counters). Thread-safe append; each event
    carries its thread id as `tid`, so spans of concurrent host threads (the
    in-process workers, the streamed exchange's dispatcher) nest correctly
    in the viewer."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def span(self, name: str, route: Optional[str] = None):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, route)

    def counter(self, name: str, values: Dict[str, float], ts: Optional[int] = None) -> None:
        """Record a Chrome "C" counter sample (e.g. per-step rel_volume) at
        `ts`, a `time.time_ns()` reading (default: now)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "C",
            "ts": (time.time_ns() if ts is None else ts) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self.events.append(ev)

    def _record(self, name: str, start_ns: int, elapsed: float, route: Optional[str] = None) -> None:
        ev = {
            "name": name,
            "cat": "telemetry",
            "ph": "X",
            "ts": start_ns / 1e3,
            "dur": round(elapsed * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if route is not None:
            # the route lands in the event's args, where calibrate() buckets
            # encode / decode self time by route; the name stays route-free
            ev["args"] = {"route": str(route)}
        with self._lock:
            self.events.append(ev)

    def reset(self) -> None:
        with self._lock:
            self.events = []

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Perfetto-loadable trace object, events in time order, a
        parent before a child that starts at the same µs (the longer
        first)."""
        with self._lock:
            events = list(self.events)
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


# the module-level tracer the instrumented modules talk to
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def enabled() -> bool:
    return _tracer.enabled


def configure(*, enabled: Optional[bool] = None, reset: bool = False) -> Tracer:
    """Flip the global tracer on or off and/or clear its event buffer."""
    if reset:
        _tracer.reset()
    if enabled is not None:
        _tracer.enabled = bool(enabled)
    return _tracer


def span(name: str, route: Optional[str] = None):
    """`with span("exchange/encode", route="quantized"): ...` records the
    host time and labels the profiler's trace when the tracer is on; a
    shared inert no-op when off. `route` attributes the span to the active
    exchange route or codec (in the event's args, never in its name)."""
    if not _tracer.enabled:
        return _NULL_SPAN
    return _Span(_tracer, name, route)


def save(path) -> None:
    """Write the module tracer's trace to `path` (trace.json)."""
    _tracer.save(path)


def annotate(name: str):
    """A `torch.profiler.record_function` range that is on whether or not
    the tracer is: the label of host work (the host codecs' calls) that a
    profile should always show. Records no trace event."""
    return record_function(name)
