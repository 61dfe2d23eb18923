"""The small vector MLP of the JAX package's CLIs: `benchmarks/train.py`'s
`mlp` entry and the resilience and controller checks' `_MLP`
(Dense(64) relu Dense(64) relu Dense(8)), with flax's parameter names."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import Dense, FlaxNamed


class MLP(FlaxNamed, nn.Module):
    """Dense(64) relu Dense(64) relu Dense(8) on `d_in` features."""

    def __init__(self, d_in: int = 32, *, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = Dense(d_in, 64, gen)
        self.Dense_1 = Dense(64, 64, gen)
        self.Dense_2 = Dense(64, 8, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(x)))))
