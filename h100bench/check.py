"""The numbers that decide `correct`, each a gap between the program's
readings and the reference's (`reference.run`), and their limits.

- `loss`: the largest |loss_prog - loss_ref| / |loss_ref| over the steps;
- `first`, `change`, `residual`, `stats`: the worst leaf's gap between the
  two norms of that leaf, |n_prog - n_ref| / max(n_ref, the median leaf's
  n_ref). Leaves whose raw mean gradient in the reference stays under a
  thousandth of the median leaf's on every step move by round-off alone and
  are left out of `change`.

`limits/<workload>.json` gives each compared number's limit and the
readings it was set from; a number without a limit is printed and not
compared."""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROUND_OFF = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref.values())
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves), default=0.0)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    out = {"loss": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))}
    med_g = statistics.median(ref["grad_max"].values())
    moving = [n for n, g in ref["grad_max"].items() if g >= ROUND_OFF * med_g]
    for kind in ("first", "change", "residual", "stats"):
        if kind in ref:
            leaves = moving if kind == "change" else list(ref[kind])
            out[kind] = leaf_gap(prog[kind], ref[kind], leaves)
    return out


def limits_for(workload: str) -> Dict[str, Optional[float]]:
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text())["numbers"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """True when every number that has a limit lies at or under it; a
    workload without any limit is never correct."""
    held = {k: v for k, v in limits.items() if v is not None}
    return bool(held) and all(k in numbers and numbers[k] <= v for k, v in held.items())
