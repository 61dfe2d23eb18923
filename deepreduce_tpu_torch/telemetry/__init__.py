"""Telemetry, ported from `deepreduce_tpu/telemetry/`: span tracing, the
on-device metric accumulators, and the CLI over tracking run directories.

- `spans`: the host-side tracer; `span("exchange/encode")` records a
  Chrome-trace "X" event and labels the `torch.profiler` trace (and an NVTX
  range on the card). Disabled (the default) it is a shared inert no-op.
- `device_metrics`: `MetricAccumulators`, the running float32 counters a
  `Trainer` with `cfg.telemetry` (and a `FedSim`) adds to on the device,
  fetched every `cfg.telemetry_every` steps.
- `python -m deepreduce_tpu_torch.telemetry {summary,compare,calibrate,
  profiles,slo,bench-history,trace}`: the offline consumer over
  `tracking.py` run directories (`__main__.py`).
"""

from deepreduce_tpu_torch.telemetry import device_metrics, spans
from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators
from deepreduce_tpu_torch.telemetry.spans import Tracer, configure, enabled, get_tracer, span

__all__ = [
    "MetricAccumulators",
    "Tracer",
    "configure",
    "device_metrics",
    "enabled",
    "get_tracer",
    "span",
    "spans",
]
