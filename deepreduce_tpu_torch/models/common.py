"""What the port's models share: flax's Dense, DenseGeneral, Conv,
BatchNorm, LayerNorm and Embed layers, its pooling, and the flax names of
parameters and BatchNorm statistics.

Flax semantics that torch's own layers do not have are written out:
- `SAME` padding is asymmetric at stride 2 on an even input: a 3x3 stride-2
  convolution pads (0, 1), not (1, 1); `max_pool` pads `SAME` with -inf the
  same way (ResNet-50's 112 -> 56 pool pads (0, 1)), which `F.max_pool2d`'s
  symmetric `padding` cannot express; `Conv` also takes explicit pads
  (ResNet-50's stem: (3, 3));
- BatchNorm and LayerNorm normalize with the biased "fast" variance
  max(0, E[x^2] - E[x]^2), reduced in float32 whatever the compute dtype;
  BatchNorm moves its running statistics by 1% per step (momentum 0.99,
  epsilon 1e-5), the variance included (torch's `BatchNorm2d` keeps the
  unbiased one). In training mode the running statistics are updated in
  place in the float32 `mean` / `var` buffers. LayerNorm's epsilon is 1e-6;
- a layer's `dtype` is flax's compute dtype: the input and the float32
  parameters are cast to it and the output is in it (a norm computes in
  at least float32 and casts its output). Parameters, and so gradients,
  stay float32. `dtype=None` (every layer's default) is flax's too: the
  promoted dtype of the input and the parameters, so a float32 model casts
  nothing and a float64 copy computes in float64.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


Dtype = Optional[torch.dtype]


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen) * std)


def _compute_dtype(dtype: Dtype, x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Module):
    """flax Dense: y = x @ kernel [in, out] + bias, in `dtype`."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, *, use_bias: bool = True, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _normal((d_in, d_out), 1.0 / math.sqrt(d_in), gen)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(d_out))
        else:
            self.bias = None

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """x @ kernel in `dtype`, without the bias (a row-parallel product
        adds it once after the sum over the model group)."""
        dt = _compute_dtype(self.dtype, x, self.kernel)
        return x.to(dt) @ self.kernel.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class DenseGeneral(nn.Module):
    """flax DenseGeneral: contracts the last `len(in_shape)` axes of x with
    a kernel `[*in_shape, *out_shape]` and adds a bias `[*out_shape]`, in
    `dtype` (BERT's attention: query/key/value `[hidden, heads, head_dim]`,
    out `[heads, head_dim, hidden]`)."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], gen: torch.Generator, *, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.n_in = len(in_shape)
        self.kernel = _normal((*in_shape, *out_shape), 1.0 / math.sqrt(math.prod(in_shape)), gen)
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The contraction in `dtype`, without the bias."""
        dt = _compute_dtype(self.dtype, x, self.kernel)
        return torch.tensordot(x.to(dt), self.kernel.to(dt), dims=self.n_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(x)
        return y + self.bias.to(y.dtype)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax's `SAME` along one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax Conv without bias, in `dtype`; kernel HWIO `[kh, kw, in /
    groups, out]` (flax's `feature_group_count` is `groups`: a depthwise
    kernel is `[3, 3, 1, C]` with groups = C), input and output NCHW.
    `padding` is flax's `SAME` (None) or explicit (low, high) pads, the same
    on both spatial axes."""

    def __init__(self, c_in: int, c_out: int, size: int, stride: int, gen: torch.Generator, *, groups: int = 1,
                 padding: Optional[Tuple[int, int]] = None, dtype: Dtype = None):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.padding = padding
        self.dtype = dtype
        fan_in = size * size * (c_in // groups)
        # flax's default lecun-normal scale, 1/sqrt(fan_in)
        self.kernel = _normal((size, size, c_in // groups, c_out), 1.0 / math.sqrt(fan_in), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        if self.padding is None:
            (top, bottom), (left, right) = same_pads(x.shape[2], kh, self.stride), same_pads(x.shape[3], kw, self.stride)
        else:
            (top, bottom), (left, right) = self.padding, self.padding
        dt = _compute_dtype(self.dtype, x, self.kernel)
        x = x.to(dt)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1).to(dt), stride=self.stride, groups=self.groups)


def max_pool_same(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """flax `max_pool(x, (size, size), (stride, stride), padding="SAME")` on
    NCHW: -inf pads placed as `same_pads` places them, then a VALID pool."""
    (top, bottom), (left, right) = same_pads(x.shape[2], size, stride), same_pads(x.shape[3], size, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x promoted to at least float32 (float64 stays), as flax reduces."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _fast_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's `_compute_stats`: mean and max(0, E[x^2] - E[x]^2) over `dims`."""
    mean = x.mean(dim=dims)
    return mean, torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)


class BatchNorm(nn.Module):
    """flax BatchNorm over the channels of an NCHW input, output in `dtype`."""

    def __init__(self, channels: int, *, momentum: float = 0.99, epsilon: float = 1e-5, zero_scale: bool = False,
                 dtype: Dtype = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        # zero_scale: flax's `scale_init=zeros` (a ResNet-50 block's last norm)
        self.scale = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _at_least_f32(x)
        if self.training:
            mean, var = _fast_stats(x, (0, 2, 3))
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm over the last axis (epsilon 1e-6), output in `dtype`."""

    def __init__(self, features: int, *, epsilon: float = 1e-6, dtype: Dtype = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _at_least_f32(x)
        mean, var = _fast_stats(x, (-1,))
        mul = torch.rsqrt(var[..., None] + self.epsilon) * self.scale
        y = (x - mean[..., None]) * mul + self.bias
        return y if self.dtype is None else y.to(self.dtype)


class Embed(nn.Module):
    """flax Embed: rows of `embedding [num, dim]`, in `dtype`. Its gradient
    (`F.embedding`'s) is dense: rows no id touches are exactly zero."""

    def __init__(self, num: int, dim: int, gen: torch.Generator, *, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _normal((num, dim), 1.0 / math.sqrt(dim), gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding if self.dtype is None else self.embedding.to(self.dtype))


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

    def functional(self, params: Dict[str, torch.Tensor], *inputs, scratch_stats: bool = False) -> torch.Tensor:
        """The forward with `params` (every parameter, under its flax name) in
        place of the module's own (`torch.func.functional_call`), as flax's
        `model.apply({"params": params}, ...)`: what a federated client
        differentiates. BatchNorm statistics stay the module's buffers; with
        `scratch_stats` a training-mode forward writes them into scratch
        tensors made from the input instead, and the module's own stay
        as they are: the forward is then functional in its statistics and
        runs under `torch.func.vmap` (a batch of clients)."""
        names = {n.replace(".", "/") for n, _ in self.named_parameters()}
        if set(params) != names:
            raise KeyError(f"parameter names differ: missing {sorted(names - set(params))}, "
                           f"unexpected {sorted(set(params) - names)}")
        own = {n.replace("/", "."): t for n, t in params.items()}
        if scratch_stats:
            # made from the input, which a batch of clients always batches
            own.update({n: inputs[0].new_zeros(b.shape, dtype=b.dtype) for n, b in self.named_buffers()})
        return torch.func.functional_call(self, own, inputs)
