"""Residual error-feedback memory over dicts of tensors (name -> tensor):

    compensated = beta * residual + gamma * grad
    residual'   = compensated - decompressed
"""

from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def init(params_or_grads: Tree) -> Tree:
    """Zero residual shaped like the gradients."""
    return {n: torch.zeros_like(t) for n, t in params_or_grads.items()}


def compensate(grads: Tree, residuals: Tree, *, beta: float = 1.0, gamma: float = 1.0) -> Tree:
    return {n: beta * residuals[n] + gamma * g for n, g in grads.items()}


def update(compensated: Tree, decompressed: Tree) -> Tree:
    """`decompressed` is this worker's own decoded contribution, so the
    residual holds exactly the gradient mass the codec dropped this step."""
    return {n: c - decompressed[n] for n, c in compensated.items()}
