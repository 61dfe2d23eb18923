"""Schema-validated SLO specification for the federated serving path, a
copy of `deepreduce_tpu/slo/spec.py`.

An `SLOSpec` is parsed from a JSON file (the `slo_spec` config knob, or
``fedsim check --slo --slo_spec``) and
rejected loudly — unknown keys, out-of-range targets, and malformed
tenant overrides all raise `ConfigError` with a registered reason code,
mirroring the config legality matrix: a typo'd spec must never silently
monitor nothing.

Targets are all optional; a spec with no targets anywhere is the
*degenerate* spec — `SLOSpec.is_noop` is True and the `HealthMonitor`
provably does nothing (no state, no events). Per-tenant overrides
(``"tenants": {"1": {...}}``) replace the global value key-by-key.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Mapping, Optional

from deepreduce_tpu_torch.config import ConfigError

# Target key -> what it bounds. Floors (min_*) trip when the windowed
# value falls BELOW the threshold; ceilings trip when it rises ABOVE.
TARGET_KEYS: Dict[str, str] = {
    "min_clients_per_round":
        "floor on window-mean accepted clients per tick",
    "min_clients_per_sec":
        "floor on window-mean admission rate (rows must carry a measured "
        "clients_per_sec; absent rows do not count)",
    "staleness_p95_max":
        "ceiling on window p95 staleness from the on-device histogram",
    "buffer_fill_max":
        "ceiling on window-max buffer fill fraction",
    "checksum_failure_budget":
        "error budget: allowed failed fraction of transmissions "
        "(evaluated as fast/slow burn rates, not a point threshold)",
    "convergence_band":
        "w_rel_err ceiling defining the convergence band",
    "convergence_residency_min":
        "floor on the fraction of window ticks inside the band "
        "(requires convergence_band; defaults to 1.0 when band is set)",
    "pop_residency_min":
        "floor on the smallest per-class participation share over the "
        "window, from the exact on-device population histogram (rows "
        "must carry a pop_hist; absent rows do not count)",
}

_SPEC_KEYS = frozenset({
    "version", "window_ticks", "fast_window_ticks", "slow_window_ticks",
    "hysteresis_ticks", "burn_fast", "burn_slow", "targets", "tenants",
})


def _check_targets(targets: Any, where: str) -> Dict[str, float]:
    if not isinstance(targets, dict):
        raise ConfigError(
            "slo-spec-syntax",
            f"{where} must be an object of target -> number, got "
            f"{type(targets).__name__}"
        )
    unknown = sorted(set(targets) - set(TARGET_KEYS))
    if unknown:
        raise ConfigError(
            "slo-spec-unknown-target",
            f"{where} has unknown target(s) {unknown}; valid targets: "
            f"{sorted(TARGET_KEYS)}"
        )
    out: Dict[str, float] = {}
    for key, raw in targets.items():
        if isinstance(raw, bool) or not isinstance(raw, (int, float)):
            raise ConfigError(
                "slo-spec-target-range",
                f"{where}[{key!r}] must be a number, got {raw!r}"
            )
        val = float(raw)
        if key == "checksum_failure_budget":
            ok = 0.0 < val <= 1.0
        elif key in ("convergence_residency_min", "pop_residency_min"):
            ok = 0.0 <= val <= 1.0
        elif key == "convergence_band":
            ok = val > 0.0
        else:
            ok = val >= 0.0
        if not ok:
            raise ConfigError(
                "slo-spec-target-range",
                f"{where}[{key!r}]={val} is outside the target's legal range"
            )
        out[key] = val
    if "convergence_residency_min" in out and "convergence_band" not in out:
        raise ConfigError(
            "slo-spec-target-range",
            f"{where} sets convergence_residency_min without "
            "convergence_band — there is no band to reside in"
        )
    return out


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Windows, burn thresholds, and targets for the health monitor."""

    # rolling evaluation window (ticks) for the plain windowed targets
    window_ticks: int = 8
    # burn-rate windows: the error-budget target must be burning fast
    # (short window) AND still burning over the long window to reach
    # BREACH grade — the classic multi-window page/ticket split
    fast_window_ticks: int = 2
    slow_window_ticks: int = 8
    # consecutive same-direction evaluations required before the state
    # ladder moves one rung (anti-flap, mirrors ctrl_hysteresis)
    hysteresis_ticks: int = 2
    # burn-rate thresholds: burn = (observed failure fraction) / budget
    burn_fast: float = 2.0
    burn_slow: float = 1.0
    # global targets and per-tenant overrides (tenant -> partial targets)
    targets: Mapping[str, float] = dataclasses.field(default_factory=dict)
    tenant_targets: Mapping[int, Mapping[str, float]] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        for name in ("window_ticks", "fast_window_ticks",
                     "slow_window_ticks", "hysteresis_ticks"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ConfigError(
                    "slo-spec-window-range",
                    f"{name} must be an int >= 1, got {v!r}"
                )
        if self.slow_window_ticks < self.fast_window_ticks:
            raise ConfigError(
                "slo-spec-window-range",
                f"slow_window_ticks={self.slow_window_ticks} < "
                f"fast_window_ticks={self.fast_window_ticks}: the slow "
                "burn window must contain the fast one"
            )
        if not (self.burn_fast > 0.0 and self.burn_slow > 0.0):
            raise ConfigError(
                "slo-spec-target-range",
                "burn_fast and burn_slow must both be > 0, got "
                f"{self.burn_fast}/{self.burn_slow}"
            )

    # -- construction --------------------------------------------------

    @classmethod
    def from_dict(cls, d: Any) -> "SLOSpec":
        if not isinstance(d, dict):
            raise ConfigError(
                "slo-spec-syntax",
                f"SLO spec must be a JSON object, got {type(d).__name__}"
            )
        unknown = sorted(set(d) - _SPEC_KEYS)
        if unknown:
            raise ConfigError(
                "slo-spec-syntax",
                f"SLO spec has unknown key(s) {unknown}; valid keys: "
                f"{sorted(_SPEC_KEYS)}"
            )
        version = d.get("version", 1)
        if version != 1:
            raise ConfigError(
                "slo-spec-syntax",
                f"SLO spec version must be 1, got {version!r}"
            )
        kwargs: Dict[str, Any] = {}
        for name in ("window_ticks", "fast_window_ticks",
                     "slow_window_ticks", "hysteresis_ticks"):
            if name in d:
                v = d[name]
                if not isinstance(v, int) or isinstance(v, bool):
                    raise ConfigError(
                        "slo-spec-window-range",
                        f"{name} must be an int, got {v!r}"
                    )
                kwargs[name] = v
        for name in ("burn_fast", "burn_slow"):
            if name in d:
                v = d[name]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ConfigError(
                        "slo-spec-target-range",
                        f"{name} must be a number, got {v!r}"
                    )
                kwargs[name] = float(v)
        kwargs["targets"] = _check_targets(d.get("targets", {}), "targets")
        tenants: Dict[int, Dict[str, float]] = {}
        raw_tenants = d.get("tenants", {})
        if not isinstance(raw_tenants, dict):
            raise ConfigError(
                "slo-spec-tenant-override",
                "tenants must be an object of tenant-index -> targets, got "
                f"{type(raw_tenants).__name__}"
            )
        for key, sub in raw_tenants.items():
            try:
                t = int(key)
            except (TypeError, ValueError):
                raise ConfigError(
                    "slo-spec-tenant-override",
                    f"tenant override key {key!r} is not an integer index"
                ) from None
            if t < 0:
                raise ConfigError(
                    "slo-spec-tenant-override",
                    f"tenant override index {t} must be >= 0"
                )
            tenants[t] = _check_targets(sub, f"tenants[{key!r}]")
        kwargs["tenant_targets"] = tenants
        return cls(**kwargs)

    @classmethod
    def load(cls, path) -> "SLOSpec":
        path = pathlib.Path(path)
        try:
            raw = json.loads(path.read_text())
        except FileNotFoundError:
            raise ConfigError(
                "slo-spec-syntax", f"SLO spec file not found: {path}"
            ) from None
        except json.JSONDecodeError as e:
            raise ConfigError(
                "slo-spec-syntax", f"SLO spec {path} is not valid JSON: {e}"
            ) from e
        return cls.from_dict(raw)

    # -- views ----------------------------------------------------------

    @property
    def is_noop(self) -> bool:
        """True when no target is set anywhere: the monitor must do
        nothing (no windows, no state, no events)."""
        return not self.targets and not any(
            t for t in self.tenant_targets.values()
        )

    def effective_targets(self, tenant: int) -> Dict[str, float]:
        """Global targets with the tenant's overrides applied on top."""
        out = dict(self.targets)
        out.update(self.tenant_targets.get(tenant, {}))
        return out

    def with_overrides(
        self,
        window_ticks: int = 0,
        hysteresis_ticks: int = 0,
    ) -> "SLOSpec":
        """Apply the config-knob overrides (0 keeps the spec value)."""
        changes: Dict[str, Any] = {}
        if window_ticks:
            changes["window_ticks"] = window_ticks
        if hysteresis_ticks:
            changes["hysteresis_ticks"] = hysteresis_ticks
        return dataclasses.replace(self, **changes) if changes else self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "window_ticks": self.window_ticks,
            "fast_window_ticks": self.fast_window_ticks,
            "slow_window_ticks": self.slow_window_ticks,
            "hysteresis_ticks": self.hysteresis_ticks,
            "burn_fast": self.burn_fast,
            "burn_slow": self.burn_slow,
            "targets": dict(self.targets),
            "tenants": {
                str(t): dict(sub) for t, sub in self.tenant_targets.items()
            },
        }
