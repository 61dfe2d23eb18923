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
