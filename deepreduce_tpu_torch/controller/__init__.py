"""Adaptive compression controller, ported from `deepreduce_tpu/controller/`.

`Ladder` declares the bounded set of operating points; `CompressionController`
moves a single index along it from telemetry window deltas; `DecisionLog`
persists the auditable trail as ``decisions.jsonl``. `python -m
deepreduce_tpu_torch.controller check` runs an adaptive train and checks the
trail, the switches, the exchangers built and a bitwise resume.
"""

from deepreduce_tpu_torch.controller.controller import (
    DECISION_SCHEMA,
    RATIONALES,
    TRIGGERS,
    CompressionController,
    DecisionLog,
    validate_decision,
)
from deepreduce_tpu_torch.controller.ladder import Ladder, OperatingPoint

__all__ = [
    "CompressionController",
    "DecisionLog",
    "DECISION_SCHEMA",
    "Ladder",
    "OperatingPoint",
    "RATIONALES",
    "TRIGGERS",
    "validate_decision",
]
