"""Local experiment tracking, a copy of `deepreduce_tpu/tracking.py` (it
imports only `resilience.retry`, of which the port has its own copy), so
that a run of the port writes the run directory the JAX package's tools
and the port's `telemetry` CLI read:

    config.json    — the run's full config dict + tags, written at start
    metrics.jsonl  — one JSON object per `log()` call (step-keyed)
    summary.json   — final metrics written by `finish()`

and `runs()` / `history()` give the offline query side. Non-finite floats
are written as null (strict JSON). Tensors are converted like numpy
arrays: a 0-d tensor becomes its Python number (a copy to the host for a
tensor on the card).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import pathlib
import time
from typing import Any, Dict, Iterator, List, Optional

from deepreduce_tpu_torch.resilience.retry import retry_io

_RUN_SEQ = itertools.count()  # disambiguates unnamed runs within one second


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "ndim"):  # numpy arrays and scalars, tensors
        return _jsonable(obj.item()) if obj.ndim == 0 else _jsonable(obj.tolist())
    if hasattr(obj, "item"):  # other 0-d scalar wrappers
        return _jsonable(obj.item())
    if isinstance(obj, float):
        # json.dumps emits bare NaN/Infinity for non-finite floats, which
        # is not strict JSON and breaks history() consumers — map to null
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    return str(obj)


class Run:
    """One tracked experiment run (the wandb.init(...) object role)."""

    def __init__(
        self,
        root: str,
        name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        tags: Optional[List[str]] = None,
    ):
        if name is None:
            stamp = time.strftime("%Y%m%d-%H%M%S")
            name = f"run-{stamp}-{os.getpid()}-{next(_RUN_SEQ)}"
        self.name = name
        self.dir = pathlib.Path(root) / self.name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._metrics = retry_io(lambda: open(self.dir / "metrics.jsonl", "a"))
        self._step = 0

        def _write_config():
            with open(self.dir / "config.json", "w") as f:
                json.dump(
                    {"name": self.name, "tags": list(tags or []), "config": _jsonable(config or {})},
                    f,
                    indent=2,
                )

        retry_io(_write_config)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if step is None:
            step = self._step
        self._step = step + 1
        rec = {"step": int(step), "ts": time.time()}
        # user metrics must not clobber the record's own step/ts keys —
        # history() keys on them; rename collisions instead of dropping data
        user = {
            (f"metric.{k}" if k in ("step", "ts") else k): v
            for k, v in _jsonable(metrics).items()
        }
        rec.update(user)

        def _append():
            # retried as a unit: if the write lands but the flush raises, a
            # retry may duplicate the line — history() consumers key on
            # `step`, so a dup is harmless where a lost record is not
            self._metrics.write(json.dumps(rec) + "\n")
            self._metrics.flush()

        retry_io(_append)

    def finish(self, summary: Optional[Dict[str, Any]] = None) -> None:
        def _write_summary():
            with open(self.dir / "summary.json", "w") as f:
                json.dump(_jsonable(summary or {}), f, indent=2)

        retry_io(_write_summary)
        self._metrics.close()

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, *exc) -> None:
        if not self._metrics.closed:
            self.finish()


def runs(root: str) -> List[str]:
    """Run names under a tracking root, oldest first (dashboard listing)."""
    p = pathlib.Path(root)
    if not p.is_dir():
        return []
    return sorted(d.name for d in p.iterdir() if (d / "config.json").exists())


def config(root: str, name: str) -> Dict[str, Any]:
    with open(pathlib.Path(root) / name / "config.json") as f:
        return json.load(f)


def history(root: str, name: str) -> Iterator[Dict[str, Any]]:
    """Step-keyed metric records of one run (wandb run.history role)."""
    path = pathlib.Path(root) / name / "metrics.jsonl"
    if not path.exists():
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def summary(root: str, name: str) -> Dict[str, Any]:
    path = pathlib.Path(root) / name / "summary.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)
