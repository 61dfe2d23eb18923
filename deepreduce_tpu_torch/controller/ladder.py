"""Discrete operating-point ladder, a copy of
`deepreduce_tpu/controller/ladder.py`.

The adaptive controller never tunes `compress_ratio`/`fpr` continuously:
payload shapes are a function of the slot budget k, so every value the
controller may select is pre-declared here as one rung of a small,
strictly-ordered ladder of `OperatingPoint`s (parsed once from
`cfg.ctrl_ladder`). The ladder index is the only thing the controller
moves, and each index maps to one exchanger (its codecs, payload layout
and QSGD segment table), built the first time the rung is visited — so a
run builds at most ``len(ladder)`` exchangers however long it is
(`Trainer.visited_ladder_indices`).

Spec syntax (``cfg.ctrl_ladder``): comma-separated ``ratio`` or
``ratio@fpr`` entries with strictly increasing ratios, e.g.
``"0.005,0.01@0.01,0.02@0.01,0.05"``. An entry without ``@fpr`` keeps the
base config's `fpr` semantics (including the default 0.1*k/d scaling).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deepreduce_tpu_torch.config import DeepReduceConfig


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung: the sparsifier budget ratio and (optionally) the bloom
    FPR pinned for that rung. ``fpr=None`` defers to the base config."""

    ratio: float
    fpr: Optional[float] = None

    def label(self) -> str:
        if self.fpr is None:
            return f"{self.ratio:g}"
        return f"{self.ratio:g}@{self.fpr:g}"


@dataclasses.dataclass(frozen=True)
class Ladder:
    """Ordered tuple of operating points, cheapest (lowest ratio) first."""

    points: Tuple[OperatingPoint, ...]

    @classmethod
    def parse(cls, spec: str) -> "Ladder":
        entries = [e.strip() for e in str(spec).split(",") if e.strip()]
        if len(entries) < 2:
            raise ValueError(
                "ctrl_ladder needs at least two operating points (a "
                f"single-point ladder cannot adapt), got {spec!r}"
            )
        points = []
        for entry in entries:
            ratio_s, _, fpr_s = entry.partition("@")
            try:
                ratio = float(ratio_s)
                fpr = float(fpr_s) if fpr_s else None
            except ValueError:
                raise ValueError(
                    f"ctrl_ladder entry {entry!r} is not 'ratio' or "
                    f"'ratio@fpr' (in {spec!r})"
                ) from None
            if not 0.0 < ratio <= 1.0:
                raise ValueError(
                    f"ctrl_ladder ratio must be in (0, 1], got {ratio} "
                    f"(in {spec!r})"
                )
            if fpr is not None and not 0.0 < fpr < 1.0:
                raise ValueError(
                    f"ctrl_ladder fpr must be in (0, 1), got {fpr} "
                    f"(in {spec!r})"
                )
            points.append(OperatingPoint(ratio=ratio, fpr=fpr))
        ratios = [p.ratio for p in points]
        if sorted(set(ratios)) != ratios:
            raise ValueError(
                "ctrl_ladder ratios must be strictly increasing (the "
                f"controller moves ±1 rung on an ordered ladder), got {spec!r}"
            )
        return cls(points=tuple(points))

    def __len__(self) -> int:
        return len(self.points)

    def __getitem__(self, idx: int) -> OperatingPoint:
        return self.points[idx]

    def index_near(self, ratio: float) -> int:
        """The rung closest to `ratio` (ties toward the cheaper rung) —
        where an adaptive run starts from its base `compress_ratio`."""
        best = min(
            range(len(self.points)),
            key=lambda i: (abs(self.points[i].ratio - ratio), i),
        )
        return best

    def apply(self, cfg: DeepReduceConfig, idx: int) -> DeepReduceConfig:
        """The config for rung `idx`: the base config with the rung's
        ratio (and fpr, when the rung pins one) substituted. Everything
        the step builds from this config — slot budgets, bloom geometry,
        payload layouts — follows statically, so one rung == one exchanger."""
        if not 0 <= idx < len(self.points):
            raise ValueError(
                f"ladder index {idx} out of range [0, {len(self.points)})"
            )
        pt = self.points[idx]
        kw = {"compress_ratio": pt.ratio}
        if pt.fpr is not None:
            kw["fpr"] = pt.fpr
        return dataclasses.replace(cfg, **kw)

    def labels(self) -> Tuple[str, ...]:
        return tuple(p.label() for p in self.points)
