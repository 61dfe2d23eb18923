"""What the port's models share: flax's Dense layer and the flax names of
parameters and BatchNorm statistics."""

from __future__ import annotations

import math
from typing import Dict

import torch
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
