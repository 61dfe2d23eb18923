"""DenseNet-40 (3 dense blocks of 12 layers, growth 12) for 32x32x3 CIFAR
inputs and 10 classes, the second CIFAR model of the paper's Table 1:
119 leaves, 1,019,722 parameters and 78 BatchNorm statistics (18,096
floats).

Ported from `deepreduce_tpu/models/densenet.py` (flax), with its names and
layout: `Conv_0/kernel`, `DenseLayer_{i}/{BatchNorm_0,Conv_0}`,
`Transition_{0,1}/{BatchNorm_0,Conv_0}`, `BatchNorm_0` and `Dense_0`. A
dense layer is BN-ReLU, a 3x3 conv to `growth` channels, and the channel
concatenation `[x, y]`; a transition is BN-ReLU, a 1x1 conv that keeps the
channel count, and a 2x2 average pool (VALID). Inputs are NHWC; the model
works in NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import BatchNorm, Conv, Dense, FlaxNamed


class DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth: int, gen: torch.Generator, dtype: Optional[torch.dtype]):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c_in, dtype=dtype)
        self.Conv_0 = Conv(c_in, growth, 3, 1, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, c_in: int, gen: torch.Generator, dtype: Optional[torch.dtype]):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c_in, dtype=dtype)
        self.Conv_0 = Conv(c_in, c_in, 1, 1, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.Conv_0(F.relu(self.BatchNorm_0(x))), 2, 2)


class DenseNet40(FlaxNamed, nn.Module):
    def __init__(self, num_classes: int = 10, growth: int = 12, layers_per_block: int = 12, *,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Conv_0 = Conv(3, 16, 3, 1, gen, dtype=dtype)
        c, self.layers = 16, []
        for block in range(3):
            for j in range(layers_per_block):
                self.layers.append(f"DenseLayer_{block * layers_per_block + j}")
                self.add_module(self.layers[-1], DenseLayer(c, growth, gen, dtype))
                c += growth
            if block < 2:
                self.layers.append(f"Transition_{block}")
                self.add_module(self.layers[-1], Transition(c, gen, dtype))
        self.BatchNorm_0 = BatchNorm(c, dtype=dtype)
        self.Dense_0 = Dense(c, num_classes, gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [batch, H, W, 3] (NHWC) -> logits f32 [batch, classes]."""
        x = self.Conv_0(images.permute(0, 3, 1, 2))
        for name in self.layers:
            x = getattr(self, name)(x)
        x = F.relu(self.BatchNorm_0(x))
        return self.Dense_0(x.mean(dim=(2, 3)))
