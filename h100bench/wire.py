"""Counts the operand bytes this process hands to `torch.distributed`'s
collectives, by wrapping the module's functions in place: the port calls
them through the module (`dist.all_gather_into_tensor(...)`), so every call
passes through here. Counting adds no device work and no sync. A send
batched by `batch_isend_irecv` is counted where that calls `isend`."""

from __future__ import annotations

import torch.distributed as dist

# function name -> (position, keyword) of the operand this worker hands over
_OPERAND = {
    "all_reduce": (0, "tensor"),
    "broadcast": (0, "tensor"),
    "reduce": (0, "tensor"),
    "all_gather_into_tensor": (1, "input_tensor"),
    "all_gather": (1, "tensor"),
    "reduce_scatter_tensor": (1, "input"),
    "all_to_all_single": (1, "input"),
    "send": (0, "tensor"),
    "isend": (0, "tensor"),
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class WireCounter:
    def __init__(self):
        self.bytes = 0
        self.calls = 0
        self._orig = {}

    def install(self) -> "WireCounter":
        for name, where in _OPERAND.items():
            fn = getattr(dist, name, None)
            if fn is not None and name not in self._orig:
                self._orig[name] = fn
                setattr(dist, name, self._wrap(fn, *where))
        return self

    def _wrap(self, fn, pos: int, key: str):
        def counted(*args, **kwargs):
            t = args[pos] if len(args) > pos else kwargs[key]
            self.calls += 1
            self.bytes += _nbytes(t)
            return fn(*args, **kwargs)

        counted.__wrapped__ = fn
        return counted

    def reset(self) -> None:
        self.bytes = 0
        self.calls = 0

    def uninstall(self) -> None:
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        self._orig.clear()
