"""Carry parameters over from the JAX package.

The JAX package's parameters, flattened with its `_leaf_name` naming
("Dense_0/kernel", "OptimizedLSTMCell_0/hf/bias", ...), map one to one onto
the port's flax-named parameters, in the same layout. Tests use this so
that both packages compute the same function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """name -> numpy array (from the JAX params pytree) -> name -> float32
    CPU tensor for `WordLSTM.load_flax_params`."""
    out = {}
    for name, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype != np.float32:
            raise TypeError(f"{name}: expected float32 parameters, got {a.dtype}")
        out[name] = torch.from_numpy(a.copy())
    return out
