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

Two flax semantics that torch's own layers do not have are written out:
- `SAME` padding is asymmetric at stride 2 on an even input: a 3x3 stride-2
  convolution pads (0, 1), not (1, 1);
- BatchNorm normalizes with the biased "fast" variance
  max(0, E[x^2] - E[x]^2) in float32 and moves its running statistics by
  1% per step (momentum 0.99, epsilon 1e-5), the variance included (torch's
  `BatchNorm2d` keeps the unbiased one). In training mode the running
  statistics are updated in place in the `mean` / `var` buffers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import Dense, FlaxNamed, _normal


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax's `SAME` along one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax Conv without bias and with `SAME` padding; kernel HWIO, input
    and output NCHW."""

    def __init__(self, c_in: int, c_out: int, size: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.stride = stride
        # flax's default lecun-normal scale, 1/sqrt(fan_in)
        self.kernel = _normal((size, size, c_in, c_out), 1.0 / math.sqrt(size * size * c_in), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        (top, bottom), (left, right) = same_pads(x.shape[2], kh, self.stride), same_pads(x.shape[3], kw, self.stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), stride=self.stride)


class BatchNorm(nn.Module):
    """flax BatchNorm over the channels of an NCHW input."""

    def __init__(self, channels: int, *, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


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
