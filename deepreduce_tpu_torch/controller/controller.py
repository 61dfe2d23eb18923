"""Telemetry-driven compression controller with an auditable decision
trail, a copy of `deepreduce_tpu/controller/controller.py` (host Python
over fetched counter dicts) that reads the port's `fetch_delta`.

The controller closes the telemetry loop: every `telemetry_every`
steps the trainer fetches the on-device `MetricAccumulators` (the fetch
it was already doing — the controller adds zero hot-loop syncs), hands
the cumulative snapshot to `CompressionController.observe`, and the
controller turns the *window delta* (this fetch minus the previous one)
into at most one ±1 move along the pre-declared operating-point ladder.

Policy, in priority order over the window metrics:

1. ``saturated_per_step > ctrl_saturation_ceiling`` → vote UP (payloads
   are overflowing their slot budget; buy more wire).
2. ``compress_err_cos < ctrl_target_err_cos`` → vote UP (the compressed
   gradient has drifted too far from the dense one).
3. ``compress_err_cos > ctrl_target_err_cos + ctrl_headroom`` → vote
   DOWN (fidelity surplus; spend it on wire savings).
4. otherwise → in band, hold, and reset both vote counters.

``ctrl_hysteresis`` consecutive same-direction votes are required before
a move; any hold or opposite vote resets the streak, so a noisy metric
cannot make the controller oscillate every window.

Every evaluation — switch or hold — is a `Decision` appended to the
in-memory trail and, when a `DecisionLog` is attached, to
``decisions.jsonl`` in the run directory. Decisions carry no wall-clock
timestamp on purpose: the trail is a pure function of the metric stream,
which is what lets checkpoint resume replay it bitwise (`python -m
deepreduce_tpu_torch.controller check` enforces this). The telemetry CLI maps decision steps onto
trace timestamps via ``metrics.jsonl`` when rendering Perfetto tracks.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.controller.ladder import Ladder, OperatingPoint
from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators, fetch_delta

# Trigger codes: which window metric drove the vote.
TRIG_SATURATION = "saturation_high"
TRIG_ERR_LOW = "err_cos_low"
TRIG_HEADROOM = "err_cos_headroom"
TRIG_IN_BAND = "in_band"

# Rationale codes: what the controller did with the vote.
RAT_MOVE_UP = "move_up"
RAT_MOVE_DOWN = "move_down"
RAT_HOLD_HYSTERESIS = "hold_hysteresis"
RAT_HOLD_IN_BAND = "hold_in_band"
RAT_HOLD_AT_TOP = "hold_at_top"
RAT_HOLD_AT_BOTTOM = "hold_at_bottom"

TRIGGERS = (TRIG_SATURATION, TRIG_ERR_LOW, TRIG_HEADROOM, TRIG_IN_BAND)
RATIONALES = (
    RAT_MOVE_UP,
    RAT_MOVE_DOWN,
    RAT_HOLD_HYSTERESIS,
    RAT_HOLD_IN_BAND,
    RAT_HOLD_AT_TOP,
    RAT_HOLD_AT_BOTTOM,
)

# decisions.jsonl schema: field name -> accepted types. Every record must
# carry exactly these keys (documented in ARCHITECTURE.md).
DECISION_SCHEMA: Dict[str, Tuple[type, ...]] = {
    "step": (int,),
    "window_steps": (int,),
    "trigger": (str,),
    "rationale": (str,),
    "switched": (bool,),
    "old_index": (int,),
    "new_index": (int,),
    "old_ratio": (float,),
    "new_ratio": (float,),
    "old_fpr": (float, type(None)),
    "new_fpr": (float, type(None)),
    "err_cos": (float,),
    "saturated_per_step": (float,),
    "rel_volume": (float,),
}


def validate_decision(rec: Dict[str, Any]) -> None:
    """Raise ValueError unless `rec` matches DECISION_SCHEMA exactly."""
    if not isinstance(rec, dict):
        raise ValueError(f"decision record must be a dict, got {type(rec)}")
    missing = sorted(set(DECISION_SCHEMA) - set(rec))
    extra = sorted(set(rec) - set(DECISION_SCHEMA))
    if missing or extra:
        raise ValueError(
            f"decision record keys mismatch: missing={missing} extra={extra}"
        )
    for key, types in DECISION_SCHEMA.items():
        # bool is an int subclass; keep step/index fields strictly int.
        if isinstance(rec[key], bool) and bool not in types:
            raise ValueError(f"decision field {key}={rec[key]!r} is bool, want {types}")
        if not isinstance(rec[key], types):
            raise ValueError(
                f"decision field {key}={rec[key]!r} has type "
                f"{type(rec[key]).__name__}, want {types}"
            )
    if rec["trigger"] not in TRIGGERS:
        raise ValueError(f"unknown trigger code {rec['trigger']!r}")
    if rec["rationale"] not in RATIONALES:
        raise ValueError(f"unknown rationale code {rec['rationale']!r}")
    if rec["switched"] != (rec["old_index"] != rec["new_index"]):
        raise ValueError("decision 'switched' inconsistent with index change")


class DecisionLog:
    """Append-only, schema-validated ``decisions.jsonl`` writer."""

    def __init__(self, path) -> None:
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, rec: Dict[str, Any]) -> None:
        validate_decision(rec)
        with self.path.open("a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    @staticmethod
    def read(path) -> List[Dict[str, Any]]:
        path = pathlib.Path(path)
        if not path.exists():
            return []
        records = []
        with path.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        return records


def _zero_fetch(num_buckets: int) -> Dict[str, Any]:
    vals = {name: 0.0 for name in MetricAccumulators.scalar_fields()}
    vals["bucket_saturated"] = [0.0] * int(num_buckets)
    return vals


class CompressionController:
    """Moves the ladder index from fetched telemetry windows.

    Host-side only: the controller never runs inside the step. Its
    entire state (index, vote streaks, window accounting, previous fetch)
    round-trips through `state_dict`/`load_state_dict` so a checkpoint
    resume continues the decision trail bitwise.
    """

    def __init__(
        self,
        cfg: DeepReduceConfig,
        ladder: Optional[Ladder] = None,
        *,
        log: Optional[DecisionLog] = None,
    ) -> None:
        self.cfg = cfg
        self.ladder = ladder if ladder is not None else Ladder.parse(cfg.ctrl_ladder)
        self.log = log
        self.index = self.ladder.index_near(cfg.compress_ratio)
        self.up_votes = 0
        self.down_votes = 0
        self.windows = 0
        self.switches = 0
        # Σ window_steps · ratio-in-effect, for effective_ratio reporting.
        self.weighted_ratio = 0.0
        self.weight_steps = 0
        self.decisions: List[Dict[str, Any]] = []
        self._prev: Optional[Dict[str, Any]] = None

    # -- operating point plumbing -------------------------------------

    @property
    def point(self) -> OperatingPoint:
        return self.ladder[self.index]

    def bucket_points(self, num_buckets: int) -> Tuple[Tuple[float, Optional[float]], ...]:
        """Per-bucket (ratio, fpr) vector for the current rung. The default
        policy moves all buckets together — a uniform vector — which is what
        keeps the exchangers built at len(ladder) rather than
        len(ladder)**num_buckets. The mechanism below it (comm_bucket's
        `points=`) accepts non-uniform vectors for future policies."""
        pt = self.point
        return tuple((pt.ratio, pt.fpr) for _ in range(num_buckets))

    def ensure_prev(self, num_buckets: int) -> None:
        """Initialise the previous-fetch baseline to the zero snapshot
        (cumulative-from-zero equals the first window's delta)."""
        if self._prev is None:
            self._prev = _zero_fetch(num_buckets)

    # -- the control law ----------------------------------------------

    def observe(self, step: int, fetch: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Evaluate one telemetry window ending at `step`.

        `fetch` is the cumulative `MetricAccumulators.fetch()` snapshot.
        Returns the decision record (also logged), or None when the
        window is empty (no steps since the previous fetch)."""
        self.ensure_prev(len(fetch.get("bucket_saturated", [])))
        delta = fetch_delta(fetch, self._prev)
        window_steps = int(round(delta["steps"]))
        if window_steps <= 0:
            return None
        window = MetricAccumulators.derive(delta)
        self._prev = fetch

        err_cos = float(window["compress_err_cos"])
        saturated = float(window["saturated_per_step"])
        rel_volume = float(window["rel_volume"])
        cfg = self.cfg

        if saturated > cfg.ctrl_saturation_ceiling:
            vote, trigger = +1, TRIG_SATURATION
        elif err_cos < cfg.ctrl_target_err_cos:
            vote, trigger = +1, TRIG_ERR_LOW
        elif err_cos > cfg.ctrl_target_err_cos + cfg.ctrl_headroom:
            vote, trigger = -1, TRIG_HEADROOM
        else:
            vote, trigger = 0, TRIG_IN_BAND

        if vote > 0:
            self.up_votes += 1
            self.down_votes = 0
        elif vote < 0:
            self.down_votes += 1
            self.up_votes = 0
        else:
            self.up_votes = self.down_votes = 0

        old_index = self.index
        new_index = old_index
        rationale = RAT_HOLD_IN_BAND
        if vote > 0:
            if self.up_votes >= cfg.ctrl_hysteresis:
                self.up_votes = 0
                if old_index + 1 < len(self.ladder):
                    new_index = old_index + 1
                    rationale = RAT_MOVE_UP
                else:
                    rationale = RAT_HOLD_AT_TOP
            else:
                rationale = RAT_HOLD_HYSTERESIS
        elif vote < 0:
            if self.down_votes >= cfg.ctrl_hysteresis:
                self.down_votes = 0
                if old_index > 0:
                    new_index = old_index - 1
                    rationale = RAT_MOVE_DOWN
                else:
                    rationale = RAT_HOLD_AT_BOTTOM
            else:
                rationale = RAT_HOLD_HYSTERESIS

        old_pt = self.ladder[old_index]
        new_pt = self.ladder[new_index]
        switched = new_index != old_index
        if switched:
            self.switches += 1
            self.up_votes = self.down_votes = 0
        self.windows += 1
        # The old rung was in effect for this whole window.
        self.weighted_ratio += window_steps * old_pt.ratio
        self.weight_steps += window_steps
        self.index = new_index

        rec = {
            "step": int(step),
            "window_steps": window_steps,
            "trigger": trigger,
            "rationale": rationale,
            "switched": switched,
            "old_index": int(old_index),
            "new_index": int(new_index),
            "old_ratio": float(old_pt.ratio),
            "new_ratio": float(new_pt.ratio),
            "old_fpr": None if old_pt.fpr is None else float(old_pt.fpr),
            "new_fpr": None if new_pt.fpr is None else float(new_pt.fpr),
            "err_cos": err_cos,
            "saturated_per_step": saturated,
            "rel_volume": rel_volume,
        }
        self.decisions.append(rec)
        if self.log is not None:
            self.log.append(rec)
        return rec

    # -- reporting -----------------------------------------------------

    def effective_ratio(self) -> float:
        """Step-weighted mean compress_ratio actually in effect so far."""
        if self.weight_steps <= 0:
            return float(self.point.ratio)
        return float(self.weighted_ratio / self.weight_steps)

    # -- checkpoint round-trip ----------------------------------------

    def state_dict(self, num_buckets: int = 0) -> Dict[str, Any]:
        """Controller state as a fixed-structure dict of numpy values,
        which `checkpoint.save` writes next to the train state."""
        self.ensure_prev(num_buckets)
        prev = dict(self._prev)
        # f32 is lossless here: every prev value came out of an f32
        # accumulator, so the round trip is bitwise.
        return {
            "index": np.asarray(self.index, np.int32),
            "up_votes": np.asarray(self.up_votes, np.int32),
            "down_votes": np.asarray(self.down_votes, np.int32),
            "windows": np.asarray(self.windows, np.int32),
            "switches": np.asarray(self.switches, np.int32),
            "weighted_ratio": np.asarray(self.weighted_ratio, np.float32),
            "weight_steps": np.asarray(self.weight_steps, np.int32),
            "prev": {
                **{
                    name: np.asarray(prev[name], np.float32)
                    for name in MetricAccumulators.scalar_fields()
                },
                "bucket_saturated": np.asarray(
                    prev["bucket_saturated"], dtype=np.float32
                ),
            },
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.index = int(state["index"])
        self.up_votes = int(state["up_votes"])
        self.down_votes = int(state["down_votes"])
        self.windows = int(state["windows"])
        self.switches = int(state["switches"])
        self.weighted_ratio = float(state["weighted_ratio"])
        self.weight_steps = int(state["weight_steps"])
        prev = state["prev"]
        self._prev = {
            **{name: float(prev[name]) for name in MetricAccumulators.scalar_fields()},
            "bucket_saturated": [float(v) for v in np.ravel(prev["bucket_saturated"])],
        }
