"""QSGD stochastic quantizer: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the JAX package's Pallas TPU kernel
(`deepreduce_tpu/ops/qsgd_kernel.py`, `quantize_levels_pallas`). Per element

    level = sign(v) * (floor(|v| * scale) + [u < frac])     (saturated int8)

with `u = (bits >> 8) * 2**-24`. The TPU's in-core PRNG becomes a
counter-based Philox-4x32-10 keyed by a 64-bit `seed` with a 64-bit `offset`
in the counter's upper half (see `csrc/qsgd_common.cuh`). The plain version
repeats the kernel's arithmetic in int64 with 32-bit masking, so on the
card the two agree bitwise; given the uniforms `jax.random.uniform` draws,
`quantize_levels_plain` equals the JAX package's `quantize_levels_xla`
bitwise.

`quantize_levels` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. If the kernel fails to build or launch it
raises; it never falls back. It is the direct counterpart of the Pallas
kernel, (values, scale) -> levels; the training step's QSGD encode runs
the fused `qsgd_encode_rows` (`ops/qsgd_encode.py`) instead.
"""

from __future__ import annotations

import ctypes

import torch

from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox-4x32-10 over int64 counters [G, 4] (32-bit words) with the
    64-bit key `seed`; returns the [G, 4] output words."""
    c0, c1, c2, c3 = counter.unbind(1)
    k0, k1 = seed & u32.MASK32, (seed >> 32) & u32.MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & u32.MASK32
            k1 = (k1 + PHILOX_W1) & u32.MASK32
        hi0, lo0 = u32.mul_hilo(c0, PHILOX_M0)
        hi1, lo1 = u32.mul_hilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1)


def philox_uniforms_plain(n: int, seed: int, offset: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """f32[n] uniforms on [0, 1) exactly as the kernel draws them: element i
    takes word i % 4 of Philox((i // 4, offset), seed), u = (bits >> 8) * 2**-24."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    counter = torch.stack(
        [
            g & u32.MASK32,
            g >> 32,
            torch.full_like(g, offset & u32.MASK32),
            torch.full_like(g, (offset >> 32) & u32.MASK32),
        ],
        dim=1,
    )
    bits = philox4x32_10(counter, seed).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_levels_plain(values: torch.Tensor, scale: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """int8[n] signed levels from given uniforms (the arithmetic of
    `quantize_levels_xla`, with XLA's saturating float -> int8 convert)."""
    level_float = values.abs() * scale
    lo = torch.floor(level_float)
    level = lo + (uniforms < (level_float - lo)).to(torch.float32)
    return torch.clamp(level * torch.sign(values), -128.0, 127.0).to(torch.int8)


def _kernel_lib() -> ctypes.CDLL:
    from deepreduce_tpu_torch.ops.build import library

    lib = library("qsgd_quantize")
    fn = lib.qsgd_quantize_levels
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.qsgd_error_string.argtypes = [ctypes.c_int]
        lib.qsgd_error_string.restype = ctypes.c_char_p
    return lib


def quantize_levels(
    values: torch.Tensor,
    scale: torch.Tensor,
    seed: int,
    offset: int,
    *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """values f32[n], scale f32[n] (q/norm broadcast per bucket), 64-bit
    (seed, offset) -> int8[n]. Both tensors must lie on `device`. On CUDA
    this launches the hand-written kernel (and counts the launch in
    `quantize_levels.launches`); on the CPU it runs the plain version."""
    dev = resolve_device(device)
    for t, what in ((values, "values"), (scale, "scale")):
        check_on(t, dev, what)
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-d float32 tensor, got {t.dtype} {tuple(t.shape)}")
    if scale.shape != values.shape:
        raise ValueError(f"scale shape {tuple(scale.shape)} != values shape {tuple(values.shape)}")
    if not (0 <= seed < 1 << 64 and 0 <= offset < 1 << 64):
        raise ValueError("seed and offset must be unsigned 64-bit integers")
    n = values.shape[0]
    if dev.type == "cpu":
        return quantize_levels_plain(values, scale, philox_uniforms_plain(n, seed, offset))
    out = torch.empty(n, dtype=torch.int8, device=values.device)
    if n == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.qsgd_quantize_levels(
            values.data_ptr(), scale.data_ptr(), out.data_ptr(), n, seed, offset, stream
        )
    if code != 0:
        raise RuntimeError(
            f"qsgd_quantize launch failed: {lib.qsgd_error_string(code).decode()} (cudaError {code})"
        )
    quantize_levels.launches += 1
    return out


quantize_levels.launches = 0
