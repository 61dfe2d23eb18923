"""Pre-activation ResNet-20 for 32x32 inputs and 10 classes, the model of
the README quick start: 61 parameter leaves, 272,282 parameters and 38
BatchNorm statistics (1,376 floats) at width 16.

Ported from `deepreduce_tpu/models/resnet.py` (flax). Parameters keep
flax's names and layout, because top-k, the bloom hash, the QSGD stream and
the fused buffer all read each flattened leaf in sorted name order:

- convolution kernels are HWIO `[kh, kw, in, out]` (permuted to torch's
  OIHW inside `forward`), `Dense_0/kernel` is `[64, 10]`;
- inputs are NHWC, as in the JAX package (the model works in NCHW inside);
- in a v2 block the shortcut convolution reads the pre-activated input and
  is created first, so flax names it `Conv_0` and the two 3x3 convolutions
  `Conv_1` and `Conv_2` (blocks 3 and 6); elsewhere they are `Conv_0` and
  `Conv_1`.

flax's asymmetric `SAME` padding and its BatchNorm are written out in
`models/common.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import BatchNorm, Conv, Dense, FlaxNamed


class BasicBlockV2(nn.Module):
    """Pre-activation basic block: BN-ReLU, 3x3 conv (stride s), BN-ReLU,
    3x3 conv, plus the identity or a 1x1 projection of the pre-activated
    input."""

    def __init__(self, c_in: int, filters: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c_in)
        self.projects = stride != 1 or c_in != filters
        if self.projects:
            self.Conv_0 = Conv(c_in, filters, 1, stride, gen)
        first, second = ("Conv_1", "Conv_2") if self.projects else ("Conv_0", "Conv_1")
        self.add_module(first, Conv(c_in, filters, 3, stride, gen))
        self.BatchNorm_1 = BatchNorm(filters)
        self.add_module(second, Conv(filters, filters, 3, 1, gen))
        self.convs = (first, second)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(x))
        shortcut = self.Conv_0(y) if self.projects else x
        y = getattr(self, self.convs[0])(y)
        y = F.relu(self.BatchNorm_1(y))
        return getattr(self, self.convs[1])(y) + shortcut


class ResNet20(FlaxNamed, nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 16, *, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Conv_0 = Conv(3, width, 3, 1, gen)
        c_in = width
        for i, filters in enumerate((width, 2 * width, 4 * width)):
            for j in range(3):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BasicBlockV2_{3 * i + j}", BasicBlockV2(c_in, filters, stride, gen))
                c_in = filters
        self.BatchNorm_0 = BatchNorm(c_in)
        self.Dense_0 = Dense(c_in, num_classes, gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [batch, H, W, 3] (NHWC) -> logits f32 [batch, classes]."""
        x = self.Conv_0(images.permute(0, 3, 1, 2))
        for j in range(9):
            x = getattr(self, f"BasicBlockV2_{j}")(x)
        x = F.relu(self.BatchNorm_0(x))
        return self.Dense_0(x.mean(dim=(2, 3)))
