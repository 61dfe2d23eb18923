"""The `mem` command: the card's peak memory of the flagship traces, the
port's counterpart of the JAX package's liveness report
(`deepreduce_tpu/analysis/liveness.py`, `__main__ mem`).

JAX prices a traced program's peak live bytes with its own interpreter of
XLA's buffers. The port measures the caching allocator instead: for each
of the flagship fused and bucketed exchanges, the streamed step and the
federated round (W = 8 in-process workers on the one card, one step), the
peak of `torch.cuda.max_memory_allocated()` above what was allocated
before, and worker 0's three largest tensors (of 16 KiB or more) alive at
the high of its tracked tensors' bytes, each with the op that made it and
where the package called it. The figures are reported, not gated: XLA's
buffer model is not the caching allocator, and the JAX package's own
budget is red.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepreduce_tpu_torch.analysis.census import _tensors, package_site

MEM_LABELS = ("exchange:fused-loop", "exchange:bucketed-loop", "exchange:streaming", "fedsim:round")


class _Peak:
    """The state the workers' `PeakWatch` modes share: the live tensors of
    `MIN_TOP_BYTES` or more made under the watch, their bytes' sum, and the
    three largest at its high."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live: Dict[int, tuple] = {}  # storage pointer -> (bytes, dtype, shape, op, site)
        self.total = 0
        self.high = 0
        self.top: List[Dict[str, Any]] = []

    def gone(self, ptr: int) -> None:
        with self.lock:
            entry = self.live.pop(ptr, None)
            if entry is not None:
                self.total -= entry[0]


# tensors below this size are not tracked (a stack walk a tensor is the
# watch's main cost)
MIN_TOP_BYTES = 16384


class PeakWatch(TorchDispatchMode):
    """Tracks every tensor of at least `MIN_TOP_BYTES` that an op makes on
    the card until it is freed; at each high of their summed bytes, keeps
    the three largest. No allocator query a op: the allocator's own peak is
    read once, after the run."""

    def __init__(self, shared: _Peak):
        super().__init__()
        self.shared = shared

    def fork(self) -> "PeakWatch":
        return PeakWatch(self.shared)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        sh = self.shared
        for t in _tensors(out):
            if t.device.type != "cuda":
                continue
            st = t.untyped_storage()
            ptr, nbytes = st.data_ptr(), st.nbytes()
            if nbytes < MIN_TOP_BYTES or ptr in sh.live:
                continue
            entry = (nbytes, str(t.dtype).replace("torch.", ""), list(t.shape), str(func), package_site())
            with sh.lock:
                sh.live[ptr] = entry
                sh.total += nbytes
                if sh.total > sh.high:
                    sh.high = sh.total
                    top = heapq.nlargest(3, sh.live.values(), key=lambda v: v[0])
                    sh.top = [dict(bytes=b, dtype=dt, shape=shape, op=op,
                                   site="-" if s is None else f"{s[0]}:{s[2]} ({s[1]})")
                              for b, dt, shape, op, s in top]
            weakref.finalize(t, sh.gone, ptr)
        return out


def _harnesses():
    from deepreduce_tpu_torch.analysis import audit
    from deepreduce_tpu_torch.config import DeepReduceConfig as C

    fl = audit._FLAGSHIP
    bucketed = dict(memory="residual", decode_strategy="loop", bucket_bytes=audit._BUCKET_BYTES, **fl)
    return {
        "exchange:fused-loop": lambda dev, mode_of: audit.run_flat(
            C(memory="residual", decode_strategy="loop", **fl), device=dev, mode_of=mode_of),
        "exchange:bucketed-loop": lambda dev, mode_of: audit.run_flat(
            C(**bucketed), leaves=audit._BUCKET_LEAVES, device=dev, mode_of=mode_of),
        "exchange:streaming": lambda dev, mode_of: audit.run_stream(
            C(stream_exchange=True, **bucketed), device=dev, mode_of=mode_of),
        "fedsim:round": lambda dev, mode_of: audit.run_fed(C(**audit._FED), device=dev, mode_of=mode_of),
    }


def measure(label: str, device="cuda") -> Dict[str, Any]:
    """{label, peak_bytes (above the bytes allocated before), base_bytes,
    tracked_high_bytes and top: worker 0's tracked bytes at their high and
    its three largest tensors then}."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("mem measures the card's caching allocator: run it with --device cuda")
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    shared = _Peak()
    # worker 0 alone is watched: a watch on every worker's thread costs as
    # much again as the run
    _harnesses()[label](device, lambda r: PeakWatch(shared) if r == 0 else contextlib.nullcontext())
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {"label": label, "peak_bytes": peak - base, "base_bytes": base, "tracked_high_bytes": shared.high,
            "top": shared.top}


def mem_report(device="cuda", labels=MEM_LABELS) -> List[Dict[str, Any]]:
    return [measure(label, device) for label in labels]
