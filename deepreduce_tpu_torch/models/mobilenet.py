"""MobileNetV1 (depthwise separable), the model of the paper's federated
Table 5 (CIFAR-10, 10 clients a round): 3,217,226 parameters in 83 leaves at
width 1.0 on 32x32x3 inputs and 10 classes.

Ported from `deepreduce_tpu/models/mobilenet.py` (flax), whose CIFAR
variant keeps the early strides at 1 and has four stride-2 blocks; every one
of them pads `SAME` as (0, 1) on an even input. Parameters keep flax's names
and layout — `Conv_0/kernel`, `BatchNorm_0/{scale,bias}`,
`SeparableBlock_{i}/{Conv_0,Conv_1}/kernel` (depthwise HWIO `[3, 3, 1, C]`,
pointwise `[1, 1, C, F]`), `SeparableBlock_{i}/BatchNorm_{0,1}/{scale,bias}`
and `Dense_0/{kernel,bias}` — because the codecs read each flattened leaf
in the JAX package's order. Inputs are NHWC; the model works in NCHW.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import BatchNorm, Conv, Dense, FlaxNamed

# (filters, stride) after the stem, the JAX package's CIFAR variant
BLOCKS = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
    (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)


class SeparableBlock(nn.Module):
    """3x3 depthwise conv (stride s), BN-ReLU, 1x1 pointwise conv, BN-ReLU."""

    def __init__(self, c_in: int, filters: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_in, 3, stride, gen, groups=c_in)
        self.BatchNorm_0 = BatchNorm(c_in)
        self.Conv_1 = Conv(c_in, filters, 1, 1, gen)
        self.BatchNorm_1 = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


class MobileNetV1(FlaxNamed, nn.Module):
    def __init__(
        self,
        num_classes: int = 10,
        width_mult: float = 1.0,
        blocks: Sequence[Tuple[int, int]] = BLOCKS,
        *,
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        w = lambda f: max(8, int(f * width_mult))
        c = w(32)
        self.Conv_0 = Conv(3, c, 3, 1, gen)
        self.BatchNorm_0 = BatchNorm(c)
        self.num_blocks = len(blocks)
        for i, (filters, stride) in enumerate(blocks):
            self.add_module(f"SeparableBlock_{i}", SeparableBlock(c, w(filters), stride, gen))
            c = w(filters)
        self.Dense_0 = Dense(c, num_classes, gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [batch, H, W, 3] (NHWC) -> logits f32 [batch, classes]."""
        x = F.relu(self.BatchNorm_0(self.Conv_0(images.permute(0, 3, 1, 2))))
        for i in range(self.num_blocks):
            x = getattr(self, f"SeparableBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
