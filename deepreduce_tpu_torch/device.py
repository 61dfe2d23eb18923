"""Device resolution shared by the entry points.

Entry points default to "cuda" and raise when CUDA is absent instead of
running on the CPU: a run that silently lands on the CPU would report CPU
times under the card's name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless `tensor` lies on `device` (index-insensitive for cuda
    when `device` names no index)."""
    if tensor.device.type != device.type or (
        device.index is not None and tensor.device.index != device.index
    ):
        raise ValueError(f"{what} lies on {tensor.device}, expected {device}")
