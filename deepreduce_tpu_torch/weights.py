"""Carry parameters and BatchNorm statistics over from the JAX package.

The JAX package's parameters and `batch_stats`, flattened with its
`_leaf_name` naming ("Dense_0/kernel", "OptimizedLSTMCell_0/hf/bias",
"BasicBlockV2_0/BatchNorm_0/mean", ...), map one to one onto the port's
flax-named parameters and buffers, in the same layout: convolution kernels
stay HWIO (MobileNetV1's depthwise kernels `[3, 3, 1, C]` too) and the
port's models permute them inside `forward`; BERT's `DenseGeneral` kernels
stay 3-D (`[hidden, heads, head_dim]`, `[heads, head_dim, hidden]`) and are
contracted as they are, so nothing is transposed on the way.
`params_from_flax` takes the nested flax dict itself (MobileNetV1, NeuMF,
ResNet-50, DenseNet-40, VGG16, BERT). Tests use this so that both packages
compute the same function; a model's `load_flax_params` checks the name
set and every shape.

The federated simulation's state carries over too: `fedsim_state_from_jax`
and `multitenant_state_from_jax` turn a JAX `FedSimState` (with its
`AsyncBuffer` and class ids) or `MultiTenantState`, given as numpy arrays,
into the port's, a worker's stratum of the residual bank included.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _float32_tensors(flat: Dict[str, np.ndarray], what: str) -> Dict[str, torch.Tensor]:
    out = {}
    for name, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype != np.float32:
            raise TypeError(f"{name}: expected float32 {what}, got {a.dtype}")
        out[name] = torch.from_numpy(a.copy())
    return out


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """name -> numpy array (from the JAX params pytree) -> name -> float32
    CPU tensor for a model's `load_flax_params`."""
    return _float32_tensors(flat, "parameters")


def batch_stats_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """name -> numpy array (from the JAX `batch_stats` pytree: the running
    `mean` and `var` of each BatchNorm) -> name -> float32 CPU tensor for a
    model's `load_flax_batch_stats`."""
    return _float32_tensors(flat, "batch statistics")


def flatten_flax(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax dict (of numpy arrays, e.g. `jax.device_get(params)`)
    -> "/"-joined name -> array, the port's flax names."""
    if not hasattr(tree, "items"):
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        out.update(flatten_flax(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def params_from_flax(tree: Any) -> Dict[str, torch.Tensor]:
    """The nested flax `params` dict of MobileNetV1 or NeuMF (or any model of
    the port) -> name -> float32 CPU tensor for its `load_flax_params`."""
    return params_from_jax(flatten_flax(tree))


def _tree(tree: Any) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(np.array(a)) for n, a in flatten_flax(tree).items()}


def _buffer_from_jax(buf: Any):
    from deepreduce_tpu_torch.fedsim.sim import AsyncBuffer

    def scalar(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(dtype)

    return AsyncBuffer(
        delta_sum=_tree(buf.delta_sum),
        weight=scalar(buf.weight), count=scalar(buf.count), k=scalar(buf.k),
        version=scalar(buf.version, torch.int64),
        hist=None if buf.hist is None else _tree(buf.hist),
        stale_sum=scalar(buf.stale_sum), stale_max=scalar(buf.stale_max), pending=scalar(buf.pending),
    )


def accumulators_from_jax(acc: Any):
    """A JAX `MetricAccumulators` (numpy leaves; a leading [T] in the
    multi-tenant state's) -> the port's, its fields in the same slots, on
    the CPU; None for None."""
    if acc is None:
        return None
    from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators

    cols = [np.asarray(getattr(acc, n), np.float32)[..., None] for n in MetricAccumulators.scalar_fields()]
    vecs = [np.asarray(acc.bucket_saturated, np.float32), np.asarray(acc.staleness_hist, np.float32)]
    pop = None if acc.pop_hist is None else np.asarray(acc.pop_hist, np.float32)
    vec = np.concatenate(cols + vecs + ([] if pop is None else [pop]), axis=-1)
    return MetricAccumulators(torch.from_numpy(np.ascontiguousarray(vec)), vecs[0].shape[-1], vecs[1].shape[-1],
                              None if pop is None else pop.shape[-1])


def fedsim_state_from_jax(state: Any, *, num_workers: int = 1, rank: int = 0):
    """A JAX `FedSimState` (its leaves as numpy arrays, e.g. after
    `jax.device_get`) -> the port's `fedsim.FedSimState` of worker `rank`
    of `num_workers` on the CPU: params, w_ref, the worker's stratum of the
    residual bank and of the class ids, the async buffer, the round and the
    telemetry accumulators (replicated, so every worker's are the same)."""
    from deepreduce_tpu_torch.fedsim.sim import FedSimState

    def stratum(x):
        n = x.shape[0] // num_workers
        return x[rank * n : (rank + 1) * n].clone()

    bank = None if state.residuals is None else {n: stratum(t) for n, t in _tree(state.residuals).items()}
    classes = None
    if state.classes is not None:
        classes = stratum(torch.from_numpy(np.array(state.classes)).to(torch.int32))
    return FedSimState(
        params=_tree(state.params), w_ref=_tree(state.w_ref), residuals=bank, round=int(np.asarray(state.round)),
        buffer=None if state.buffer is None else _buffer_from_jax(state.buffer), classes=classes,
        telemetry=accumulators_from_jax(state.telemetry),
    )


def multitenant_state_from_jax(state: Any, *, num_workers: int = 1, rank: int = 0):
    """A JAX `MultiTenantState` (numpy leaves) -> the port's
    `fedsim.MultiTenantState` of worker `rank` on the CPU: every stacked
    [T, ...] tensor, the bank's client dimension cut to the worker's
    stratum, the per-tenant knobs and counters as host values, and the
    per-tenant telemetry accumulators."""
    from deepreduce_tpu_torch.fedsim.sim import MultiTenantState

    def stratum(x):
        n = x.shape[1] // num_workers
        return x[:, rank * n : (rank + 1) * n].clone()

    bank = None if state.residuals is None else {n: stratum(t) for n, t in _tree(state.residuals).items()}
    host = lambda x: None if x is None else tuple(np.asarray(x).tolist())  # noqa: E731
    latency = None if state.latency is None else tuple(tuple(r) for r in np.asarray(state.latency).tolist())
    return MultiTenantState(
        params=_tree(state.params), w_ref=_tree(state.w_ref), residuals=bank,
        round=tuple(int(r) for r in np.asarray(state.round)),
        buffer=None if state.buffer is None else _buffer_from_jax(state.buffer),
        active=tuple(bool(a) for a in np.asarray(state.active)), alpha=host(state.alpha), latency=latency,
        cohort=host(state.cohort), tick=int(np.asarray(state.tick)),
        telemetry=accumulators_from_jax(state.telemetry),
    )
