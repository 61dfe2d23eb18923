"""What the port's models share: flax's Dense, Conv and BatchNorm layers
and the flax names of parameters and BatchNorm statistics.

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
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen) * std)


class Dense(nn.Module):
    """flax Dense: y = x @ kernel [in, out] + bias."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, *, use_bias: bool = True):
        super().__init__()
        self.kernel = _normal((d_in, d_out), 1.0 / math.sqrt(d_in), gen)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(d_out))
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax's `SAME` along one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax Conv without bias and with `SAME` padding; kernel HWIO
    `[kh, kw, in / groups, out]` (flax's `feature_group_count` is `groups`:
    a depthwise kernel is `[3, 3, 1, C]` with groups = C), input and output
    NCHW."""

    def __init__(self, c_in: int, c_out: int, size: int, stride: int, gen: torch.Generator, *, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        fan_in = size * size * (c_in // groups)
        # flax's default lecun-normal scale, 1/sqrt(fan_in)
        self.kernel = _normal((size, size, c_in // groups, c_out), 1.0 / math.sqrt(fan_in), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        (top, bottom), (left, right) = same_pads(x.shape[2], kh, self.stride), same_pads(x.shape[3], kw, self.stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), stride=self.stride, groups=self.groups)


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


def _load_named(own: Dict[str, torch.Tensor], given: Dict[str, torch.Tensor], what: str) -> None:
    if set(own) != set(given):
        raise KeyError(
            f"{what} names differ: missing {sorted(set(own) - set(given))}, "
            f"unexpected {sorted(set(given) - set(own))}"
        )
    with torch.no_grad():
        for name, t in own.items():
            if tuple(given[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(given[name].shape)} != {tuple(t.shape)}")
            t.copy_(given[name])


class FlaxNamed:
    """Mixin for an `nn.Module` whose submodules carry flax's names: its
    parameters and buffers under flax's "/"-joined paths."""

    def flax_params(self) -> Dict[str, nn.Parameter]:
        """Parameters under their flax names ("Dense_0/kernel", ...)."""
        return {name.replace(".", "/"): p for name, p in self.named_parameters()}

    def flax_batch_stats(self) -> Dict[str, torch.Tensor]:
        """BatchNorm running statistics under their flax `batch_stats` names
        (".../BatchNorm_0/mean", ".../var"); empty without BatchNorm."""
        return {name.replace(".", "/"): b for name, b in self.named_buffers()}

    def load_flax_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy parameters given under flax names; the name sets must match."""
        _load_named(self.flax_params(), params, "parameter")

    def load_flax_batch_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Copy BatchNorm statistics given under flax names; the name sets
        must match."""
        _load_named(self.flax_batch_stats(), stats, "batch_stats")

    def functional(self, params: Dict[str, torch.Tensor], *inputs) -> torch.Tensor:
        """The forward with `params` (every parameter, under its flax name) in
        place of the module's own (`torch.func.functional_call`), as flax's
        `model.apply({"params": params}, ...)`: what a federated client
        differentiates. BatchNorm statistics stay the module's buffers."""
        names = {n.replace(".", "/") for n, _ in self.named_parameters()}
        if set(params) != names:
            raise KeyError(f"parameter names differ: missing {sorted(names - set(params))}, "
                           f"unexpected {sorted(set(params) - names)}")
        own = {n.replace("/", "."): t for n, t in params.items()}
        return torch.func.functional_call(self, own, inputs)
