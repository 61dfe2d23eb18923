"""SLO health plane for the federated serving path, ported from
`deepreduce_tpu/slo/`.

`spec.py` defines the schema-validated `SLOSpec` (targets, windows and
burn-rate thresholds, with per-tenant overrides); `monitor.py` runs a
`HealthMonitor` over the federated tick reports: host Python, a pure
function of the recorded metrics, so its ``health.jsonl`` event trail
replays bitwise across a checkpoint kill and resume (`fedsim check --slo`
checks this). The device side is the exact staleness histogram in the
async tick's one fused all_reduce (fedsim/sim.py).
"""

from deepreduce_tpu_torch.slo.monitor import (
    HEALTH_SCHEMA,
    HEALTH_STATES,
    HealthLog,
    HealthMonitor,
    hist_quantile,
    validate_health,
    validate_health_stream,
)
from deepreduce_tpu_torch.slo.spec import TARGET_KEYS, SLOSpec

__all__ = [
    "SLOSpec",
    "TARGET_KEYS",
    "HEALTH_SCHEMA",
    "HEALTH_STATES",
    "HealthLog",
    "HealthMonitor",
    "hist_quantile",
    "validate_health",
    "validate_health_stream",
]
