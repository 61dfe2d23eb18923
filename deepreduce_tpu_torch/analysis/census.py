"""The op census: every aten op one run makes, with its output dtypes and
shapes, the port's counterpart of the JAX package's dataflow graph and of
the dtype part of its liveness pass (`deepreduce_tpu/analysis/dataflow.py`,
`liveness.py`).

`Census` is a `TorchDispatchMode`: inside it every aten op the thread runs
is recorded as an `Op` (its name, its outputs' dtypes and shapes), in order,
on a `recorder.Tape`. `census_hash` over that list is the port's
`jaxpr_hash`: two runs of one program on other values give the same hash.
An op that touches a float64 tensor, reads a tensor on the host (an
`item`, a `nonzero`) or copies between the host and the card (each a device
sync on the card) or may be a selection (a stable sort) also records the
innermost
frame of the package outside this subpackage, `(module, function, line)`,
which the float64 and host-read rules hold to their lists of sites.

The mode stack is per thread: each in-process worker enters its own census
in its own thread, and work a worker hands to another thread (the streamed
exchange's dispatcher) enters `census.fork()` there, which writes to the
same tape.

The census sees a host read only where the op that makes it reaches the
dispatcher; a composite op can synchronize below it. On the card
`SyncWatch` counts every sync itself: under torch's sync debug mode each
synchronizing call of any thread warns, and the watch keeps the package
site that made it (`sync_site`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import warnings
from typing import Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepreduce_tpu_torch.analysis.recorder import Tape

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))

# ops that read a tensor's value on the host (a device-to-host sync on the
# card) or whose output size depends on the values
HOST_READ_OPS = (
    "aten._local_scalar_dense.default",
    "aten.is_nonzero.default",
    "aten.equal.default",
    "aten.nonzero.default",
    "aten.masked_select.default",
    "aten._unique2.default",
    "aten.unique_consecutive.default",
    "aten.unique_dim.default",
)

# copies whose source and destination lie on different devices: on the
# card a copy to or from pageable host memory synchronizes
COPY_OPS = ("aten._to_copy.default", "aten.copy_.default", "aten._copy_from.default",
            "aten._copy_from_and_resize.default")

# the sparsifier's selection: the stable descending sort of
# `sparse.top_order`, one per codec encode (a stable sort elsewhere, as the
# federated cohort's permutation, is not a selection)
SELECT_OPS = ("aten.sort.stable",)
SELECT_SITES = (("sparse.py", "top_order"),)

# ops that gather by index (the mod query's contract is none of them)
GATHER_OPS = (
    "aten.gather.default",
    "aten.index.Tensor",
    "aten.index_select.default",
    "aten.take.default",
    "aten.take_along_dim.default",
    "aten.embedding.default",
)

_F64 = (torch.float64, torch.complex128)


@dataclasses.dataclass(frozen=True)
class Op:
    """One aten op: its overload's name, its outputs' (dtype, shape), and
    where the package called it from (float64 and host-read ops only)."""

    name: str
    outs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    f64: bool = False
    site: Optional[Tuple[str, str, int]] = None
    host: bool = False  # a host read or a copy between the host and the card

    def text(self) -> str:
        return self.name + "".join(f"|{dt}{list(shape)}" for dt, shape in self.outs)


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


_ANONYMOUS = ("<genexpr>", "<listcomp>", "<dictcomp>", "<setcomp>", "<lambda>")


def _in_package(fn: str) -> bool:
    return fn.startswith(PACKAGE_DIR + os.sep) and not fn.startswith(_ANALYSIS_DIR + os.sep)


def _site(f) -> Tuple[str, str, int]:
    line, outer = f.f_lineno, f
    while outer.f_code.co_name in _ANONYMOUS and outer.f_back is not None:
        outer = outer.f_back
    return (os.path.relpath(os.path.abspath(f.f_code.co_filename), PACKAGE_DIR).replace(os.sep, "/"),
            outer.f_code.co_name, line)


def package_site(skip: int = 2) -> Optional[Tuple[str, str, int]]:
    """(module path under the package, function, line) of the innermost
    frame of the package outside `analysis/`, or None; a comprehension or
    a lambda is named after the function around it."""
    f = sys._getframe(skip)
    while f is not None:
        if _in_package(os.path.abspath(f.f_code.co_filename)):
            return _site(f)
        f = f.f_back
    return None


# frames a sync warning passes through on its way up: torch's own Python,
# the warnings module, and the census's dispatch
_PASS_THROUGH = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
                 os.path.abspath(warnings.__file__), os.path.abspath(__file__))


def sync_site(skip: int = 2) -> Optional[Tuple[str, str, int]]:
    """The site of a host sync warned about in this frame's callers: the
    innermost frame outside torch, `warnings` and the census, as
    (module, function, line) where it lies in the package outside
    `analysis/`; None where it is the analysis harness's own (the data it
    puts on the card, the checks it makes) or a caller's outside the
    package."""
    f = sys._getframe(skip)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_PASS_THROUGH):
            return _site(f) if _in_package(fn) else None
        f = f.f_back
    return None


_SYNC_WARNING = "called a synchronizing CUDA operation"


def watches_syncs(device) -> bool:
    """Whether `SyncWatch` counts on `device`: torch's sync debug mode is
    the card's."""
    return torch.device(device).type == "cuda"


class SyncWatch:
    """The host syncs the package makes while inside: `sites` holds the
    `sync_site` of each, in order, from every thread (the mode and the
    warning hook are the process's). A sync whose site is None (the
    harness's own) is not kept. Off the card (`watches_syncs`) it counts
    nothing and `sites` stays None."""

    def __init__(self, device):
        self.on = watches_syncs(device)
        self.sites: Optional[List[Tuple[str, str, int]]] = [] if self.on else None

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            site = sync_site()
            if site is not None:
                self.sites.append(site)
        else:
            self._show(message, category, filename, lineno, file, line)

    def __enter__(self) -> "SyncWatch":
        if self.on:
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
            self._show, warnings.showwarning = warnings.showwarning, self._hook
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._warnings.__exit__(*exc)


class Census(TorchDispatchMode):
    """Records every aten op of the threads that enter it on `tape`."""

    def __init__(self, tape: Optional[Tape] = None):
        super().__init__()
        self.tape = Tape() if tape is None else tape

    def fork(self) -> "Census":
        """A census for another thread, writing to the same tape."""
        return Census(self.tape)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        outs = tuple((str(t.dtype).replace("torch.", ""), tuple(t.shape)) for t in _tensors(out))
        tensors = list(_tensors((args, kwargs, out)))
        f64 = any(t.dtype in _F64 for t in tensors)
        host = name in HOST_READ_OPS or (name in COPY_OPS and len({t.device.type for t in tensors}) > 1)
        site = package_site() if f64 or host or name in SELECT_OPS else None
        self.tape.append("op", Op(name, outs, f64, site, host))
        return out


def ops_of(tape: Tape) -> List[Op]:
    return [item for kind, item in tape.events if kind == "op"]


def census_hash(ops: List[Op]) -> str:
    """A stable hash of the op sequence (names, output dtypes and shapes):
    the port's `jaxpr_hash`."""
    return hashlib.sha256("\n".join(op.text() for op in ops).encode()).hexdigest()[:16]


def count(ops: List[Op], names) -> int:
    return sum(1 for op in ops if op.name in names)


def selections(ops: List[Op]) -> int:
    """The sparsifier selections among `ops`."""
    return sum(1 for op in ops if op.name in SELECT_OPS and at_site(op.site, SELECT_SITES))


def at_site(site: Optional[Tuple[str, str, int]], sites) -> bool:
    """Whether `site` is one of `sites` ((module, function) pairs, '*' any
    function)."""
    return site is not None and any(site[0] == m and (f == "*" or site[1] == f) for m, f in sites)


def outside(ops: List[Op], sites, *, f64: bool = False, host_reads: bool = False) -> List[Op]:
    """The float64 ops (`f64`) or host reads and host-card copies
    (`host_reads`) not made at one of `sites` ((module, function) pairs,
    '*' any function)."""
    return [op for op in ops if ((f64 and op.f64) or (host_reads and op.host)) and not at_site(op.site, sites)]


def site_text(op: Op) -> str:
    return f"{op.name} at " + ("?" if op.site is None else f"{op.site[0]}:{op.site[2]} ({op.site[1]})")
