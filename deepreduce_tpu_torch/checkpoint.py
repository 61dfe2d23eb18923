"""Checkpoint and resume of the port's training state, residuals included.

The counterpart of `deepreduce_tpu/checkpoint.py`. The reference leaves
checkpoints to its drivers and drops the residual (error-feedback) memory,
so a resume silently loses the gradient mass it held; here the whole
`TrainState` round-trips: the parameters, the BatchNorm running statistics,
the optimizer's state (SGD's momentum buffers), the residuals and the step
(which keys every stochastic stream of the exchange, so a resumed run draws
what an uninterrupted one would).

- One file, written with `torch.save` and read with
  `torch.load(map_location=device, weights_only=True)`.
- `restore` copies into the tensors of a template state built by
  `Trainer.init_state` (or into a `Trainer`'s new one): the model's own
  parameters and buffers, so the optimizer and the exchanger keep their
  references. Every name and shape is checked first; a difference names
  the leaf.
- `save(..., config=cfg)` stamps a fingerprint of the semantics-bearing
  config fields into a sibling `<path>.config.json`; `restore(...,
  config=cfg)` fails fast on a mismatch (residuals written under one codec
  stack would silently change meaning under another). A checkpoint without
  a stamp is tolerated. Observability-only knobs are left out of the
  fingerprint (the JAX package's set, kept as it is).
- Every read and write goes through `resilience.retry.retry_io`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, Optional, Union

import torch

from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.resilience.retry import retry_io
from deepreduce_tpu_torch.train import Trainer, TrainState

# config fields that change what is observed, never what is computed: a
# checkpoint written with telemetry off must restore under telemetry on
_OBSERVABILITY_FIELDS = frozenset({
    "telemetry", "telemetry_every", "micro_benchmark",
    "slo_spec", "slo_window", "slo_hysteresis",
})


def config_fingerprint(cfg: DeepReduceConfig) -> str:
    """Stable hex fingerprint of the semantics-bearing config fields: sha256
    of their sorted-key JSON, first 16 hex digits."""
    d = dataclasses.asdict(cfg)
    for f in _OBSERVABILITY_FIELDS:
        d.pop(f, None)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _stamp_path(path) -> pathlib.Path:
    return pathlib.Path(str(pathlib.Path(path).absolute()) + ".config.json")


def _write_stamp(path, cfg: DeepReduceConfig) -> None:
    d = dataclasses.asdict(cfg)
    stamp = {
        "fingerprint": config_fingerprint(cfg),
        "config": {k: (v if isinstance(v, (int, float, bool, str, type(None))) else str(v)) for k, v in d.items()},
    }

    def _write():
        with open(_stamp_path(path), "w") as f:
            json.dump(stamp, f, sort_keys=True, indent=2)

    retry_io(_write)


def _check_stamp(path, cfg: DeepReduceConfig) -> None:
    sp = _stamp_path(path)
    if not sp.exists():
        return  # a checkpoint without a stamp: tolerated
    stamp = retry_io(lambda: json.loads(sp.read_text()))
    want = config_fingerprint(cfg)
    got = stamp.get("fingerprint")
    # tenant geometry first, with its own message (a stamp without the
    # field reads as the single-tenant driver, 0)
    stamped_t = int(stamp.get("config", {}).get("fed_tenants", 0) or 0)
    want_t = int(getattr(cfg, "fed_tenants", 0) or 0)
    if stamped_t != want_t:
        raise ValueError(
            f"checkpoint tenant-geometry mismatch: {sp} was written with fed_tenants={stamped_t} but this run "
            f"configures fed_tenants={want_t}; the checkpoint cannot restore into this geometry. Use the original "
            "fed_tenants, or delete the checkpoint to start fresh."
        )
    if got != want:
        raise ValueError(
            f"checkpoint config mismatch: {sp} was written under config fingerprint {got!r} but this run's config "
            f"fingerprints to {want!r}; restoring would silently change codec semantics mid-run. Use the original "
            "config, or delete the checkpoint to start fresh."
        )


def _detached(tensors: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
    return None if tensors is None else {n: t.detach() for n, t in tensors.items()}


def save(path: str, state: TrainState, *, config: Optional[DeepReduceConfig] = None) -> None:
    """Write `state` (parameters, BatchNorm statistics, optimizer state,
    residuals, step) to `path`; with `config`, also its stamp."""
    blob = {
        "params": _detached(state.params),
        "batch_stats": _detached(state.batch_stats),
        "optimizer": state.optimizer.state_dict(),
        "residuals": _detached(state.residuals),
        "step": state.step,
    }
    retry_io(lambda: torch.save(blob, path))
    if config is not None:
        _write_stamp(path, config)


def _copy_into(own: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor], what: str) -> None:
    """Copy `saved` into `own` in place, after checking every name and shape."""
    missing, unexpected = sorted(set(own) - set(saved)), sorted(set(saved) - set(own))
    if missing or unexpected:
        raise ValueError(f"checkpoint {what} names differ: missing {missing}, unexpected {unexpected}")
    for name, t in own.items():
        if tuple(saved[name].shape) != tuple(t.shape) or saved[name].dtype != t.dtype:
            raise ValueError(
                f"checkpoint {what} {name}: saved {saved[name].dtype} {tuple(saved[name].shape)}, "
                f"expected {t.dtype} {tuple(t.shape)}"
            )
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(saved[name])


def restore(path: str, trainer_or_template: Union[Trainer, TrainState], *,
            config: Optional[DeepReduceConfig] = None) -> TrainState:
    """The state saved at `path`, copied into `trainer_or_template`: a
    `TrainState` from `Trainer.init_state` on the same config, or a
    `Trainer` (whose `init_state` builds it). With `config`, fail fast if
    the stamped fingerprint differs."""
    if config is not None:
        _check_stamp(path, config)
    template = trainer_or_template
    if isinstance(template, Trainer):
        template = template.init_state()
    device = next(iter(template.params.values())).device
    blob = retry_io(lambda: torch.load(path, map_location=device, weights_only=True))
    _copy_into(template.params, blob["params"], "parameter")
    _copy_into(template.batch_stats, blob["batch_stats"], "batch_stats")
    if (template.residuals is None) != (blob["residuals"] is None):
        raise ValueError(
            f"checkpoint residuals: saved {'none' if blob['residuals'] is None else 'some'}, "
            f"this config keeps {'none' if template.residuals is None else 'some'} (memory differs)"
        )
    if template.residuals is not None:
        _copy_into(template.residuals, blob["residuals"], "residual")
    template.optimizer.load_state_dict(blob["optimizer"])
    return dataclasses.replace(template, step=int(blob["step"]))


def save_common_init(path: str, params: Dict[str, torch.Tensor]) -> None:
    """The reference's `model_init.pth` common-initialization trick: persist
    the initial parameters so every worker and job starts from them."""
    retry_io(lambda: torch.save(_detached(params), path))


def load_common_init(path: str, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy the parameters saved by `save_common_init` into `params` (a
    model's `flax_params()`, in place) and return it."""
    device = next(iter(params.values())).device
    saved = retry_io(lambda: torch.load(path, map_location=device, weights_only=True))
    _copy_into(params, saved, "parameter")
    return params
