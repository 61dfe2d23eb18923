"""Fused, grouped QSGD encode: the CUDA kernel's wrapper and its plain
PyTorch version.

`qsgd_encode_rows` writes, for every segment of a table (one leaf's f32[k]
values, a Philox (seed, offset) and a byte offset into `out`), the leaf's
wire rows ``[bucket_size int8 levels | 4 norm bytes] x B`` with
B = ceil(k / bucket_size). Values are zero-padded to whole buckets in
registers; the norm is `bucket_norms_ordered`, the scale `q / norm` (an
IEEE divide, 1 for a zero norm), the levels those of `quantize_levels`
under the same stream. One launch covers up to `MAX_SEGMENTS` segments:
the training step's exchange encodes every compressed leaf of a worker in
one call. It replaces the JAX package's Pallas kernel
(`deepreduce_tpu/ops/qsgd_kernel.py`, `quantize_levels_pallas`) and the
padding, norm, scale and concatenations that `deepreduce_tpu/codecs/qsgd.py`
builds around it (see `csrc/qsgd_encode.cu`).

On CUDA the wrapper launches the kernel and counts each launch in
`qsgd_encode_rows.launches`; on the CPU it runs the plain version. There is
no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import torch

from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.ops.qsgd_kernel import count_launches, philox_uniforms_plain, quantize_levels_plain

MAX_SEGMENTS = 128  # the kernel's segment table (csrc/qsgd_encode.cu kMaxSegments)


@dataclasses.dataclass(frozen=True)
class EncodeSegment:
    """One leaf of a grouped encode: f32[k] `values` in rank order, the byte
    offset of its first wire row in `out`, and its Philox stream.
    `uniforms` (f32[B * bucket_size], CPU only) replaces the stream with
    given draws: the parity tests' hook."""

    values: torch.Tensor
    out_offset: int
    seed: int
    offset: int
    uniforms: Optional[torch.Tensor] = None


def num_buckets(k: int, bucket_size: int) -> int:
    return (k + bucket_size - 1) // bucket_size


def rows_nbytes(k: int, bucket_size: int) -> int:
    return num_buckets(k, bucket_size) * (bucket_size + 4)


def bucket_sq_sums_ordered(padded: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """f64[B] sums of squares of the buckets of `padded` (length a multiple
    of `bucket_size`) in the kernel's fixed log-depth order: each bucket
    zero-padded to 128 * J elements (J a power of two) and read as [J, 32,
    4], element 128 j + 4 l + i; the four squares of each (j, l) fold in
    pairs, then the J of each l in adjacent pairs, then the 32 l in
    adjacent pairs. Padding further adds exact zeros, so every J large
    enough gives the same bits."""
    bs = bucket_size
    b = padded.shape[0] // bs
    width = max(128, 1 << (bs - 1).bit_length())
    sq = torch.zeros(b, width, dtype=torch.float64, device=padded.device)
    sq[:, :bs] = padded.reshape(b, bs).double().square()
    x = sq.view(b, width // 128, 32, 4)
    x = (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    x = x[:, 0]
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def bucket_norms_ordered(padded: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """f32[B] L2 norms of the buckets of `padded`: `bucket_sq_sums_ordered`,
    its square root in float64, rounded once to float32. The one norm of
    the port: the kernel, the codec, qar and sparse_rs all take it."""
    return bucket_sq_sums_ordered(padded, bucket_size).sqrt().float()


def scale_from_norms(norms: torch.Tensor, quantum_num: int) -> torch.Tensor:
    """f32[B] q / norm with the zero-norm guard, as one IEEE float32 divide
    (the kernel's `__fdiv_rn`; `q / tensor` in PyTorch would multiply by a
    rounded reciprocal instead)."""
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    return torch.full_like(safe, float(quantum_num)) / safe


def qsgd_encode_rows_plain(
    segments: Sequence[EncodeSegment], quantum_num: int, bucket_size: int, out: torch.Tensor
) -> None:
    """The kernel's rows, segment by segment, in plain PyTorch on `out`'s
    device: zero padding, `bucket_norms_ordered`, `scale_from_norms`, the
    Philox uniforms (or the segment's given ones) and `quantize_levels_plain`."""
    bs = bucket_size
    dst_all = out.view(torch.uint8)
    for seg in segments:
        k = seg.values.shape[0]
        b = num_buckets(k, bs)
        if b == 0:
            continue
        padded = torch.zeros(b * bs, dtype=torch.float32, device=out.device)
        padded[:k] = seg.values
        norms = bucket_norms_ordered(padded, bs)
        scale = scale_from_norms(norms, quantum_num)[:, None].expand(b, bs).reshape(-1)
        u = seg.uniforms
        if u is None:
            u = philox_uniforms_plain(b * bs, seg.seed, seg.offset, device=out.device)
        levels = quantize_levels_plain(padded, scale, u)
        dst = dst_all[seg.out_offset : seg.out_offset + b * (bs + 4)].view(b, bs + 4)
        dst[:, :bs] = levels.view(torch.uint8).view(b, bs)
        dst[:, bs:] = norms.view(torch.uint8).view(b, 4)


class _SegmentDesc(ctypes.Structure):
    # csrc/qsgd_encode.cu `QsgdEncodeSegment`
    _fields_ = [
        ("values", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("seed", ctypes.c_ulonglong),
        ("offset", ctypes.c_ulonglong),
        ("k", ctypes.c_longlong),
    ]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded `csrc/qsgd_encode.cu` library
    (`qsgd_encode_floor` where the library has it: an earlier build may
    not), note its segment table size in `lib.max_segments` (an earlier
    build's may be smaller) and return it."""
    fn = lib.qsgd_encode_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_SegmentDesc), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qsgd_encode_max_segments.argtypes = []
        lib.qsgd_encode_max_segments.restype = ctypes.c_int
        lib.qsgd_encode_error_string.argtypes = [ctypes.c_int]
        lib.qsgd_encode_error_string.restype = ctypes.c_char_p
        lib.max_segments = lib.qsgd_encode_max_segments()
        if hasattr(lib, "qsgd_encode_floor"):
            lib.qsgd_encode_floor.argtypes = fn.argtypes
            lib.qsgd_encode_floor.restype = ctypes.c_int
    return lib


def kernel_lib() -> ctypes.CDLL:
    """The built and bound `csrc/qsgd_encode.cu` of this checkout."""
    from deepreduce_tpu_torch.ops.build import library

    lib = bind(library("qsgd_encode"))
    if lib.max_segments != MAX_SEGMENTS:
        raise RuntimeError("csrc/qsgd_encode.cu and ops/qsgd_encode.py disagree on the segment table size")
    return lib


def _check_args(
    segments: Sequence[EncodeSegment], out: torch.Tensor, quantum_num: int, bucket_size: int, dev: torch.device
) -> None:
    check_on(out, dev, "out")
    if out.dtype not in (torch.uint8, torch.int8) or out.dim() != 1 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous 1-d uint8 or int8 tensor, got {out.dtype} {tuple(out.shape)}")
    if bucket_size <= 0:
        raise ValueError(f"bucket_size must be positive, got {bucket_size}")
    if not 0 < quantum_num <= 127:
        raise ValueError(f"quantum_num must lie in [1, 127], got {quantum_num}")
    for i, seg in enumerate(segments):
        v = seg.values
        check_on(v, dev, f"segment {i} values")
        if v.dtype != torch.float32 or v.dim() != 1 or not v.is_contiguous():
            raise ValueError(f"segment {i}: values must be a contiguous 1-d float32 tensor, got {v.dtype} {tuple(v.shape)}")
        if not (0 <= seg.seed < 1 << 64 and 0 <= seg.offset < 1 << 64):
            raise ValueError(f"segment {i}: seed and offset must be unsigned 64-bit integers")
        end = seg.out_offset + rows_nbytes(v.shape[0], bucket_size)
        if seg.out_offset < 0 or end > out.shape[0]:
            raise ValueError(f"segment {i}: rows [{seg.out_offset}, {end}) fall outside out[{out.shape[0]}]")
        if seg.uniforms is not None:
            if dev.type != "cpu":
                raise ValueError("injected uniforms are a CPU parity hook; on CUDA the kernel draws them")
            want = num_buckets(v.shape[0], bucket_size) * bucket_size
            if seg.uniforms.shape != (want,):
                raise ValueError(f"segment {i}: uniforms must have shape ({want},), got {tuple(seg.uniforms.shape)}")


def launch(lib: ctypes.CDLL, segments: Sequence[EncodeSegment], out: torch.Tensor, quantum_num: int,
           bucket_size: int, *, floor: bool = False) -> int:
    """Launch the kernel of `lib` (a `bind`-declared build of
    `csrc/qsgd_encode.cu`) once per `lib.max_segments` segments with at
    least one bucket, on the current stream, without checks or counting; with
    `floor`, its empty floor kernel instead. Returns the number of
    launches; raises on a failed launch. `qsgd_encode_rows` is the entry
    point; chip_smoke.py times the floor and an earlier build of the source
    through this."""
    live: List[EncodeSegment] = [s for s in segments if s.values.shape[0] > 0]
    base = out.data_ptr()
    launches = 0
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        for lo in range(0, len(live), lib.max_segments):
            chunk = live[lo : lo + lib.max_segments]
            table = (_SegmentDesc * len(chunk))(
                *(_SegmentDesc(s.values.data_ptr(), base + s.out_offset, s.seed, s.offset, s.values.shape[0])
                  for s in chunk)
            )
            fn = lib.qsgd_encode_floor if floor else lib.qsgd_encode_rows
            code = fn(table, len(chunk), bucket_size, quantum_num, stream)
            if code != 0:
                raise RuntimeError(
                    f"qsgd_encode launch failed: {lib.qsgd_encode_error_string(code).decode()} (cudaError {code})"
                )
            launches += 1
    return launches


def qsgd_encode_rows(
    segments: Sequence[EncodeSegment],
    out: torch.Tensor,
    *,
    quantum_num: int,
    bucket_size: int,
    device: DeviceLike = "cuda",
) -> None:
    """Write every segment's wire rows into `out` (uint8 or int8, 1-d) at
    its `out_offset`. All tensors must lie on `device`. On CUDA this
    launches the hand-written kernel once per `MAX_SEGMENTS` segments with
    at least one bucket (counted in `qsgd_encode_rows.launches`); on the
    CPU it runs the plain version."""
    dev = resolve_device(device)
    _check_args(segments, out, quantum_num, bucket_size, dev)
    if dev.type == "cpu":
        qsgd_encode_rows_plain(segments, quantum_num, bucket_size, out)
        return
    if any(s.values.shape[0] > 0 for s in segments):
        count_launches(qsgd_encode_rows, launch(kernel_lib(), segments, out, quantum_num, bucket_size))


qsgd_encode_rows.launches = 0


def qsgd_encode_floor(segments: Sequence[EncodeSegment], out: torch.Tensor, *, quantum_num: int,
                      bucket_size: int) -> None:
    """The launch floor of `qsgd_encode_rows` on the same table: an empty
    kernel with its parameter block and grid, on the card only. A
    measurement, not a path: it writes nothing and is not counted."""
    _check_args(segments, out, quantum_num, bucket_size, resolve_device(out.device))
    if out.device.type != "cuda":
        raise ValueError("qsgd_encode_floor times the card's launch; out must lie on CUDA")
    launch(kernel_lib(), segments, out, quantum_num, bucket_size, floor=True)
