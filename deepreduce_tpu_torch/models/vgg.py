"""VGG16 (configuration "D": 13 convolutions) for 32x32x3 CIFAR inputs and
10 classes, the third model family of PolySeg's per-model tables: 43
leaves, 14,986,698 parameters and 26 BatchNorm statistics (8,448 floats).

Ported from `deepreduce_tpu/models/vgg.py` (flax), with its names:
`Conv_{0..12}/kernel` (which PolySeg's default `(?i)conv` pattern selects),
`BatchNorm_{0..12}`, `Dense_0` (512, in `dtype`) and the float32 head
`Dense_1`. Each stage is conv-BN-ReLU `convs` times, then a 2x2 max pool
(VALID); then global average pooling, `Dense_0`, ReLU and `Dense_1`. Inputs
are NHWC; the model works in NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import BatchNorm, Conv, Dense, FlaxNamed

# (filters, convs) per stage, max-pooled between stages
STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(FlaxNamed, nn.Module):
    def __init__(self, num_classes: int = 10, stages: Sequence[Tuple[int, int]] = STAGES, *,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        c, i = 3, 0
        self.stage_convs = []
        for filters, convs in stages:
            self.stage_convs.append(convs)
            for _ in range(convs):
                self.add_module(f"Conv_{i}", Conv(c, filters, 3, 1, gen, dtype=dtype))
                self.add_module(f"BatchNorm_{i}", BatchNorm(filters, dtype=dtype))
                c, i = filters, i + 1
        self.Dense_0 = Dense(c, 512, gen, dtype=dtype)
        self.Dense_1 = Dense(512, num_classes, gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [batch, H, W, 3] (NHWC) -> logits f32 [batch, classes]."""
        x = images.permute(0, 3, 1, 2)
        i = 0
        for convs in self.stage_convs:
            for _ in range(convs):
                x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        return self.Dense_1(F.relu(self.Dense_0(x.mean(dim=(2, 3)))))
