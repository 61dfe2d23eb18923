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
- The federated simulation's states (`fedsim.FedSimState`, with its
  async buffer and class ids, and `fedsim.MultiTenantState`) round-trip the
  same way: every tensor by its field path, copied into a template from
  `FedSim.init` after the same checks, and the host fields (round and tick
  counters, the active mask, the per-tenant knobs) restored as saved.
- A run with telemetry or the adaptive controller saves
  `{"state": TrainState, "telemetry": MetricAccumulators, "ctrl":
  Trainer.controller_state()}`, the JAX driver's checkpoint dict
  (`benchmarks/train.py`); `restore` with such a dict of templates returns
  the same dict. The counters round-trip bitwise and the controller's
  state exactly, so a resumed run replays the decision trail bitwise. A
  federated state's accumulators (its `telemetry` field) round-trip with
  the state.
- Every read and write goes through `resilience.retry.retry_io`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Any, Dict, Optional, Tuple, Union

import torch

from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.resilience.retry import retry_io
from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators
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


def _split_state(state, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A dataclass state's tensors by field path ("params/w",
    "buffer/delta_sum/w") and its host fields ("round": 3)."""
    tensors: Dict[str, torch.Tensor] = {}
    host: Dict[str, Any] = {}
    for f in dataclasses.fields(state):
        val, key = getattr(state, f.name), prefix + f.name
        if torch.is_tensor(val):
            tensors[key] = val.detach()
        elif isinstance(val, MetricAccumulators):
            tensors[key + "/vec"] = val.vec.detach()
        elif isinstance(val, dict):
            tensors.update({f"{key}/{n}": t.detach() for n, t in val.items()})
        elif dataclasses.is_dataclass(val):
            t, h = _split_state(val, key + "/")
            tensors.update(t)
            host.update(h)
        else:
            host[key] = val
    return tensors, host


def _with_host(state, host: Dict[str, Any], prefix: str = ""):
    changes = {}
    for f in dataclasses.fields(state):
        val, key = getattr(state, f.name), prefix + f.name
        if dataclasses.is_dataclass(val):
            changes[f.name] = _with_host(val, host, key + "/")
        elif key in host and not torch.is_tensor(val) and not isinstance(val, (dict, MetricAccumulators)):
            saved = host[key]
            changes[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in saved) if isinstance(
                saved, list) else saved
    return dataclasses.replace(state, **changes)


def _host_tree(x):
    """A controller state (numpy values) as plain Python, which
    `torch.load(weights_only=True)` reads back."""
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    return x.tolist() if hasattr(x, "tolist") else x


def _train_blob(state: TrainState) -> Dict[str, Any]:
    return {
        "params": _detached(state.params),
        "batch_stats": _detached(state.batch_stats),
        "optimizer": state.optimizer.state_dict(),
        "residuals": _detached(state.residuals),
        "step": state.step,
    }


def save(path: str, state, *, config: Optional[DeepReduceConfig] = None) -> None:
    """Write `state` (parameters, BatchNorm statistics, optimizer state,
    residuals, step; or a federated state's every field; or a dict
    `{"state": TrainState, "telemetry": MetricAccumulators or None,
    "ctrl": controller state}`) to `path`; with `config`, also its stamp."""
    if isinstance(state, dict):
        blob = {"run": _train_blob(state["state"])}
        acc = state.get("telemetry")
        if acc is not None:
            blob["telemetry"] = {"vec": acc.vec.detach(),
                                 "geometry": [acc.num_buckets, acc.num_stale_levels, acc.num_pop_classes]}
        if state.get("ctrl") is not None:
            blob["ctrl"] = _host_tree(state["ctrl"])
        retry_io(lambda: torch.save(blob, path))
        if config is not None:
            _write_stamp(path, config)
        return
    if not isinstance(state, TrainState):
        tensors, host = _split_state(state)
        retry_io(lambda: torch.save({"tensors": tensors, "host": json.dumps(host)}, path))
        if config is not None:
            _write_stamp(path, config)
        return
    retry_io(lambda: torch.save(_train_blob(state), path))
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


def restore(path: str, trainer_or_template: Union[Trainer, TrainState, dict], *,
            config: Optional[DeepReduceConfig] = None):
    """The state saved at `path`, copied into `trainer_or_template`: a
    `TrainState` from `Trainer.init_state` on the same config, or a
    `Trainer` (whose `init_state` builds it). With `config`, fail fast if
    the stamped fingerprint differs. Given a dict `{"state": template,
    ...}` (a checkpoint `save` wrote from such a dict), returns `{"state":
    TrainState, "telemetry": MetricAccumulators or None, "ctrl": the
    controller state or None}`, the counters on the state's device."""
    if config is not None:
        _check_stamp(path, config)
    if isinstance(trainer_or_template, dict):
        template = trainer_or_template["state"]
        if isinstance(template, Trainer):
            template = template.init_state()
        device = next(iter(template.params.values())).device
        blob = retry_io(lambda: torch.load(path, map_location=device, weights_only=True))
        out = {"state": _restore_train(template, blob["run"]), "telemetry": None, "ctrl": blob.get("ctrl")}
        if "telemetry" in blob:
            C, D, K = blob["telemetry"]["geometry"]
            out["telemetry"] = MetricAccumulators(blob["telemetry"]["vec"].clone(), C, D, K)
        return out
    template = trainer_or_template
    if not isinstance(template, (Trainer, TrainState)):
        own, _ = _split_state(template)
        device = next(iter(own.values())).device
        blob = retry_io(lambda: torch.load(path, map_location=device, weights_only=True))
        _copy_into(own, blob["tensors"], "state")
        return _with_host(template, json.loads(blob["host"]))
    if isinstance(template, Trainer):
        template = template.init_state()
    device = next(iter(template.params.values())).device
    blob = retry_io(lambda: torch.load(path, map_location=device, weights_only=True))
    return _restore_train(template, blob)


def _restore_train(template: TrainState, blob: Dict[str, Any]) -> TrainState:
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
