"""Schema-validated heterogeneous-population specification, a copy of
`deepreduce_tpu/population/spec.py`.

A `PopulationSpec` is parsed from a JSON file or an inline JSON object
(the `pop_spec` config knob accepts either) and rejected loudly — unknown
keys, out-of-range values, and malformed per-class latency rows all raise
`ConfigError` with a registered reason code, mirroring `SLOSpec` /
`MachineProfile`: a typo'd spec must never silently serve an IID
population.

Each `ClassSpec` carries the three heterogeneity axes:

- **data skew**: `data_alpha` is the symmetric Dirichlet label
  concentration (0.0 is the IID sentinel — the class stages NO skew ops
  and its clients see the base generator bitwise); `data_bias` adds
  extra concentration on the class's home label ``class_index %
  num_labels``, so the expected per-class label marginal is analytically
  ``c / sum(c)`` with ``c[l] = data_alpha + data_bias·[l == home]`` —
  the planted-skew contract the sampler tests pin.
- **latency class**: a `parse_latency` comma list replacing the single
  global `fed_async_latency` for this class's clients ("" inherits the
  global row). Rows are zero-padded to the population's common overlap
  depth D exactly like the per-tenant rows (padding is
  draw-preserving).
- **compute class**: `local_steps_mult` >= 1, a relative compute cost
  priced by `costmodel.pop_compute_factor` (the trace itself runs the
  shared `fed_local_steps` program — pricing, not per-class retracing).

The degenerate spec — one class, alpha 0, no latency row, mult 1 —
is `is_uniform`, and the driver proves it bitwise identical to the
population-free program (params AND residual bank, sync and async).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Any, Dict, Tuple

from deepreduce_tpu_torch.config import ConfigError

# hard cap on the class count: the per-class participation histogram
# rides the one fused psum (f32[K] operand), and the reason-coded cap
# keeps a typo'd spec from silently inflating every round's wire term
MAX_CLASSES = 64

_CLASS_KEYS = frozenset({
    "name", "weight", "data_alpha", "data_bias", "latency",
    "local_steps_mult",
})
_SPEC_KEYS = frozenset({
    "version", "classes", "num_labels", "label_shift", "seed",
})


def _num(where: str, key: str, raw: Any) -> float:
    if isinstance(raw, bool) or not isinstance(raw, (int, float)):
        raise ConfigError(
            "pop-spec-syntax",
            f"{where}[{key!r}] must be a number, got {raw!r}"
        )
    return float(raw)


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One client class: a population share plus the three axes."""

    name: str
    weight: float = 1.0
    data_alpha: float = 0.0
    data_bias: float = 0.0
    latency: str = ""
    local_steps_mult: float = 1.0

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ConfigError(
                "pop-spec-syntax",
                f"class name must be a non-empty string, got {self.name!r}"
            )
        for field in ("weight", "data_alpha", "data_bias",
                      "local_steps_mult"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not math.isfinite(v):
                raise ConfigError(
                    "pop-spec-range",
                    f"class {self.name!r}: {field} must be a finite "
                    f"number, got {v!r}"
                )
        if self.weight <= 0.0:
            raise ConfigError(
                "pop-spec-range",
                f"class {self.name!r}: weight is a population share and "
                f"must be > 0, got {self.weight}"
            )
        if self.data_alpha < 0.0:
            raise ConfigError(
                "pop-spec-range",
                f"class {self.name!r}: data_alpha is a Dirichlet "
                "concentration and must be >= 0 (0 = IID sentinel), got "
                f"{self.data_alpha}"
            )
        if self.data_bias < 0.0:
            raise ConfigError(
                "pop-spec-range",
                f"class {self.name!r}: data_bias must be >= 0, got "
                f"{self.data_bias}"
            )
        if self.data_bias > 0.0 and self.data_alpha == 0.0:
            raise ConfigError(
                "pop-spec-range",
                f"class {self.name!r}: data_bias={self.data_bias} with "
                "data_alpha=0 — the IID sentinel has no Dirichlet to "
                "bias; set data_alpha > 0"
            )
        if self.local_steps_mult < 1.0:
            raise ConfigError(
                "pop-spec-range",
                f"class {self.name!r}: local_steps_mult is a relative "
                f"compute cost and must be >= 1, got {self.local_steps_mult}"
            )
        if not isinstance(self.latency, str):
            raise ConfigError(
                "pop-spec-syntax",
                f"class {self.name!r}: latency must be a parse_latency "
                f"string ('' inherits fed_async_latency), got "
                f"{self.latency!r}"
            )
        if self.latency:
            # syntax check at construction (deferred import: round.py's
            # parser is config-free at parse time — mirrors the
            # fed_async_latency check in config.__post_init__)
            from deepreduce_tpu_torch.fedsim.round import parse_latency

            try:
                parse_latency(self.latency, name=f"class {self.name!r} latency")
            except ConfigError:
                raise
            except ValueError as e:
                raise ConfigError("pop-latency-syntax", str(e)) from e

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "weight": self.weight,
            "data_alpha": self.data_alpha,
            "data_bias": self.data_bias,
            "latency": self.latency,
            "local_steps_mult": self.local_steps_mult,
        }


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """The version-tagged class table plus the skew-generator knobs."""

    classes: Tuple[ClassSpec, ...] = ()
    # label universe of the synthetic non-IID generator; pop_labels
    # config knob overrides (0 keeps the spec value)
    num_labels: int = 8
    # magnitude of the centered per-label mean shift the skew transform
    # applies; 0.0 makes the skew branch value-free even when staged
    label_shift: float = 1.0
    # the spec's own PRNG seed: class assignments and per-client label
    # mixtures derive from fold_in chains rooted at PRNGKey(seed), so the
    # same spec reproduces bitwise on any process
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.classes, tuple) or not all(
            isinstance(c, ClassSpec) for c in self.classes
        ):
            raise ConfigError(
                "pop-spec-syntax",
                "classes must be a tuple of ClassSpec"
            )
        if not self.classes:
            raise ConfigError(
                "pop-spec-range",
                "a population needs at least one class"
            )
        if len(self.classes) > MAX_CLASSES:
            raise ConfigError(
                "pop-spec-range",
                f"{len(self.classes)} classes exceeds the cap of "
                f"{MAX_CLASSES} — the per-class histogram rides the one "
                "fused psum"
            )
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ConfigError(
                "pop-spec-syntax",
                f"duplicate class name(s) in {names}"
            )
        if not isinstance(self.num_labels, int) \
                or isinstance(self.num_labels, bool) or self.num_labels < 2:
            raise ConfigError(
                "pop-labels-range",
                f"num_labels must be an int >= 2, got {self.num_labels!r}"
            )
        if isinstance(self.label_shift, bool) \
                or not isinstance(self.label_shift, (int, float)) \
                or not math.isfinite(self.label_shift) \
                or self.label_shift < 0.0:
            raise ConfigError(
                "pop-spec-range",
                f"label_shift must be a finite number >= 0, got "
                f"{self.label_shift!r}"
            )
        if not isinstance(self.seed, int) or isinstance(self.seed, bool) \
                or self.seed < 0:
            raise ConfigError(
                "pop-spec-range",
                f"seed must be an int >= 0, got {self.seed!r}"
            )

    # -- construction --------------------------------------------------

    @classmethod
    def from_dict(cls, d: Any) -> "PopulationSpec":
        if not isinstance(d, dict):
            raise ConfigError(
                "pop-spec-syntax",
                f"population spec must be a JSON object, got "
                f"{type(d).__name__}"
            )
        unknown = sorted(set(d) - _SPEC_KEYS)
        if unknown:
            raise ConfigError(
                "pop-spec-syntax",
                f"population spec has unknown key(s) {unknown}; valid "
                f"keys: {sorted(_SPEC_KEYS)}"
            )
        version = d.get("version", 1)
        if version != 1:
            raise ConfigError(
                "pop-spec-syntax",
                f"population spec version must be 1, got {version!r}"
            )
        raw_classes = d.get("classes", [])
        if not isinstance(raw_classes, list):
            raise ConfigError(
                "pop-spec-syntax",
                f"classes must be an array of class objects, got "
                f"{type(raw_classes).__name__}"
            )
        classes = []
        for i, raw in enumerate(raw_classes):
            if not isinstance(raw, dict):
                raise ConfigError(
                    "pop-spec-syntax",
                    f"classes[{i}] must be an object, got "
                    f"{type(raw).__name__}"
                )
            unknown = sorted(set(raw) - _CLASS_KEYS)
            if unknown:
                raise ConfigError(
                    "pop-spec-syntax",
                    f"classes[{i}] has unknown key(s) {unknown}; valid "
                    f"keys: {sorted(_CLASS_KEYS)}"
                )
            if "name" not in raw:
                raise ConfigError(
                    "pop-spec-syntax", f"classes[{i}] is missing 'name'"
                )
            kwargs: Dict[str, Any] = {"name": raw["name"]}
            for key in ("weight", "data_alpha", "data_bias",
                        "local_steps_mult"):
                if key in raw:
                    kwargs[key] = _num(f"classes[{i}]", key, raw[key])
            if "latency" in raw:
                kwargs["latency"] = raw["latency"]
            classes.append(ClassSpec(**kwargs))
        kwargs = {"classes": tuple(classes)}
        if "num_labels" in d:
            v = d["num_labels"]
            if not isinstance(v, int) or isinstance(v, bool):
                raise ConfigError(
                    "pop-labels-range",
                    f"num_labels must be an int, got {v!r}"
                )
            kwargs["num_labels"] = v
        if "label_shift" in d:
            kwargs["label_shift"] = _num("spec", "label_shift",
                                         d["label_shift"])
        if "seed" in d:
            v = d["seed"]
            if not isinstance(v, int) or isinstance(v, bool):
                raise ConfigError(
                    "pop-spec-range", f"seed must be an int, got {v!r}"
                )
            kwargs["seed"] = v
        return cls(**kwargs)

    @classmethod
    def load(cls, path) -> "PopulationSpec":
        path = pathlib.Path(path)
        try:
            raw = json.loads(path.read_text())
        except FileNotFoundError:
            raise ConfigError(
                "pop-spec-syntax",
                f"population spec file not found: {path}"
            ) from None
        except json.JSONDecodeError as e:
            raise ConfigError(
                "pop-spec-syntax",
                f"population spec {path} is not valid JSON: {e}"
            ) from e
        return cls.from_dict(raw)

    @classmethod
    def load_any(cls, spec: str) -> "PopulationSpec":
        """A path OR an inline JSON object (leading '{') — the `pop_spec`
        config knob accepts both, so the lattice and bench drivers never
        need a spec file on disk."""
        if not isinstance(spec, str) or not spec.strip():
            raise ConfigError(
                "pop-spec-syntax",
                f"pop_spec must be a file path or an inline JSON object, "
                f"got {spec!r}"
            )
        if spec.lstrip().startswith("{"):
            try:
                raw = json.loads(spec)
            except json.JSONDecodeError as e:
                raise ConfigError(
                    "pop-spec-syntax",
                    f"inline population spec is not valid JSON: {e}"
                ) from e
            return cls.from_dict(raw)
        return cls.load(spec)

    @classmethod
    def uniform(cls, **overrides) -> "PopulationSpec":
        """The degenerate single-class IID spec — the bitwise-degeneracy
        anchor the driver tests pin against the population-free program."""
        return cls(classes=(ClassSpec(name="uniform"),), **overrides)

    # -- views ----------------------------------------------------------

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def weights(self) -> Tuple[float, ...]:
        """Normalized population shares, in class order."""
        total = sum(c.weight for c in self.classes)
        return tuple(c.weight / total for c in self.classes)

    @property
    def local_steps_mults(self) -> Tuple[float, ...]:
        return tuple(c.local_steps_mult for c in self.classes)

    @property
    def skew_on(self) -> bool:
        """True when any class stages the non-IID data transform."""
        return any(c.data_alpha > 0.0 for c in self.classes)

    @property
    def latency_on(self) -> bool:
        """True when any class overrides the global latency row."""
        return any(c.latency for c in self.classes)

    @property
    def is_uniform(self) -> bool:
        """True for the degenerate spec the bitwise contract covers: one
        class, no skew, no latency override, unit compute."""
        return (
            len(self.classes) == 1
            and not self.skew_on
            and not self.latency_on
            and self.classes[0].local_steps_mult == 1.0
        )

    def with_overrides(self, num_labels: int = 0) -> "PopulationSpec":
        """Apply the config-knob overrides (0 keeps the spec value)."""
        if num_labels:
            return dataclasses.replace(self, num_labels=num_labels)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "classes": [c.to_dict() for c in self.classes],
            "num_labels": self.num_labels,
            "label_shift": self.label_shift,
            "seed": self.seed,
        }
