"""Build and load the port's CUDA kernels and its C++ host library.

Each source under `ops/csrc/` is compiled by `nvcc` into a shared library
with a plain C interface, for `sm_90a`, and loaded with ctypes. The host
codec library (`native/csrc/deepreduce_native.cc`, a byte-for-byte copy of
the JAX package's) is compiled the same way by `g++` with the JAX package's
Makefile flags. Builds go to `deepreduce_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`, CUDA sources only) and the flags, so a changed source is
rebuilt and an unchanged one is reused within a checkout. Nothing is built
at import: the first call into a library builds it, or `build_all()` builds
every source at once, one compiler process per source, all started
together. A missing compiler or a failed build raises with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "qsgd_quantize": "qsgd_quantize.cu",
    "qsgd_encode": "qsgd_encode.cu",
    "bloom_mod": "bloom_mod.cu",
}
# host library name -> source file (C++, built by g++)
HOST_SOURCES: Dict[str, Path] = {
    "deepreduce_native": _PKG / "native" / "csrc" / "deepreduce_native.cc",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

# deepreduce_tpu/native/Makefile's flags, -Wall aside (warnings change no code)
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels are built from source at first use"
    )


def gxx_path() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host codec library is built from source at first use")
    return gxx


def _source(name: str) -> Path:
    return HOST_SOURCES[name] if name in HOST_SOURCES else CSRC / SOURCES[name]


def _target(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_SOURCES:
        h.update(" ".join(GXX_FLAGS).encode())
    else:
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start the compiler for `name` unless its library is already built; the
    output goes to a temporary name and is renamed into place when the
    compiler succeeds."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name in HOST_SOURCES:
        cmd = [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.cmd = cmd  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(proc.cmd[0]).name} failed for {_source(name).name} (exit {proc.returncode}):\n"
            f"{' '.join(proc.cmd)}\n{log}"
        )
    os.replace(proc.tmp_path, _target(name))


def build_all() -> Dict[str, float]:
    """Build every kernel source and the host library in parallel; returns
    seconds per library (0.0 for one that was already built)."""
    t0 = time.perf_counter()
    procs = {name: _start(name) for name in (*SOURCES, *HOST_SOURCES)}
    times = {}
    for name, proc in procs.items():
        _finish(name, proc)
        times[name] = 0.0 if proc is None else time.perf_counter() - t0
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` (a kernel's or the host library), built on
    first use."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
