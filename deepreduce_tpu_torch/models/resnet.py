"""Pre-activation ResNet-20 for 32x32 inputs and 10 classes, the model of
the README quick start: 61 parameter leaves, 272,282 parameters and 38
BatchNorm statistics (1,376 floats) at width 16. And the bottleneck (v1.5)
ResNet-50 for 224x224x3 ImageNet inputs and 1,000 classes, the repo's
headline model: 161 leaves, 25,557,032 parameters and 106 BatchNorm
statistics (53,120 floats).

Ported from `deepreduce_tpu/models/resnet.py` (flax). Parameters keep
flax's names and layout, because top-k, the bloom hash, the QSGD stream and
the fused buffer all read each flattened leaf in sorted name order:

- convolution kernels are HWIO `[kh, kw, in, out]` (permuted to torch's
  OIHW inside `forward`), `Dense_0/kernel` is `[64, 10]`;
- inputs are NHWC, as in the JAX package (the model works in NCHW inside);
- in a v2 block the shortcut convolution reads the pre-activated input and
  is created first, so flax names it `Conv_0` and the two 3x3 convolutions
  `Conv_1` and `Conv_2` (blocks 3 and 6); elsewhere they are `Conv_0` and
  `Conv_1`. A projecting bottleneck block likewise creates its shortcut
  convolution and norm first (`Conv_0`, `BatchNorm_0`), then the main
  path's `Conv_1..3` / `BatchNorm_1..3`;
- ResNet-50's `dtype` (bfloat16 in `bench.py`) is the convolutions' and
  norms' compute dtype; the head `Dense_0` computes in float32 and the
  parameters stay float32. The last norm of each bottleneck block starts
  from a zero scale.

flax's asymmetric `SAME` padding, the stem's explicit padding, its `SAME`
max pool and its BatchNorm are written out in `models/common.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import BatchNorm, Conv, Dense, FlaxNamed, max_pool_same


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


class BottleneckBlock(nn.Module):
    """1x1 conv, BN-ReLU, 3x3 conv (stride s), BN-ReLU, 1x1 conv to 4 x
    filters, BN (zero scale), plus the identity or a projected, normalized
    shortcut; then ReLU."""

    def __init__(self, c_in: int, filters: int, stride: int, gen: torch.Generator, dtype: Optional[torch.dtype]):
        super().__init__()
        self.projects = stride != 1 or c_in != 4 * filters
        if self.projects:
            self.Conv_0 = Conv(c_in, 4 * filters, 1, stride, gen, dtype=dtype)
            self.BatchNorm_0 = BatchNorm(4 * filters, dtype=dtype)
        first = 1 if self.projects else 0
        widths = ((c_in, filters, 1, 1), (filters, filters, 3, stride), (filters, 4 * filters, 1, 1))
        self.main = []
        for i, (a, b, size, s) in enumerate(widths):
            conv, norm = f"Conv_{first + i}", f"BatchNorm_{first + i}"
            self.add_module(conv, Conv(a, b, size, s, gen, dtype=dtype))
            self.add_module(norm, BatchNorm(b, zero_scale=i == 2, dtype=dtype))
            self.main.append((conv, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.BatchNorm_0(self.Conv_0(x)) if self.projects else x
        y = x
        for i, (conv, norm) in enumerate(self.main):
            y = getattr(self, norm)(getattr(self, conv)(y))
            if i < 2:
                y = F.relu(y)
        return F.relu(y + shortcut)


class ResNet50(FlaxNamed, nn.Module):
    def __init__(self, num_classes: int = 1000, stage_sizes: Sequence[int] = (3, 4, 6, 3), *,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.Conv_0 = Conv(3, 64, 7, 2, gen, padding=(3, 3), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64, dtype=dtype)
        c_in, blocks = 64, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BottleneckBlock_{blocks}", BottleneckBlock(c_in, 64 * 2**i, stride, gen, dtype))
                c_in, blocks = 4 * 64 * 2**i, blocks + 1
        self.num_blocks = blocks
        self.Dense_0 = Dense(c_in, num_classes, gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images f32 [batch, H, W, 3] (NHWC) -> logits f32 [batch, classes]."""
        x = F.relu(self.BatchNorm_0(self.Conv_0(images.permute(0, 3, 1, 2))))
        x = max_pool_same(x, 3, 2)
        for j in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{j}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
