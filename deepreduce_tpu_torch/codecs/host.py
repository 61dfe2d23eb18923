"""The host boundary of the host-side codecs (Huffman, Deflate, the
searched-knot PolyFit, the C++ library's bloom and integer codecs).

The selection stays on the device. A host codec copies to the host the
exact tensors the JAX package's `jax.pure_callback` receives (`to_host`:
one blocking device-to-host copy each, a host sync on the card), runs the
same numpy, zlib or C++ there, and returns its static-shape payload or
decoded leaves to the device (`to_device`: a non-blocking copy from
pageable memory, staged before it returns, so the host buffer may go at
once). Each host call sits in a `torch.profiler.record_function` range
named `host/<codec>.<stage>` (`span`, through `telemetry.spans.annotate`:
on whether or not the tracer is), so a profile shows it.

A decode reads its in-band lengths from a host copy of the payload it is
given (`host=`, the exchange's one copy of each gathered row); without one
it copies the leaves it reads itself.
"""

from __future__ import annotations

import numpy as np
import torch

from deepreduce_tpu_torch.telemetry.spans import annotate


def to_host(t: torch.Tensor) -> np.ndarray:
    """The tensor's values as a numpy array on the host (a copy when the
    tensor lies on the card; a view of it on the CPU)."""
    return t.detach().cpu().numpy()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`; unsigned 32-bit words travel as
    int32 bit patterns, as everywhere in the port."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device, non_blocking=True)


def scalar(x: int, device: torch.device) -> torch.Tensor:
    """An in-band length as an int32[] on `device`, filled there (a tensor
    copied from the host would wait for the device)."""
    return torch.full((), int(x), dtype=torch.int32, device=device)


def span(name: str):
    return annotate(f"host/{name}")
