"""Quantized allreduce: int8 reduce-scatter + allgather, ported from
`deepreduce_tpu/qar.py`.

    phase 1 (reduce-scatter): the padded gradient viewed as [W, s]; every
        shard QSGD-bucket quantized to int8 levels + f32 bucket norms; one
        `all_to_all` routes shard i of every worker to worker i, which
        dequantizes the W received rows and sums them in worker order.
    phase 2 (allgather): the summed shard is re-quantized, `all_gather`ed,
        and every worker dequantizes the W shards into the full sum / W.

At world size 1 both quantizations still run (mean = deq(q2(deq(q1(g))))),
so the card computes the JAX package's function. Each phase sends one uint8
buffer per worker: each row's int8 levels followed by its norms' bytes.

The levels come from `ops.quantize_levels`, the hand-written CUDA kernel
(`ops/csrc/qsgd_quantize.cu`) on the card. The norm is
`ops.bucket_norms_ordered` and the scale one IEEE divide
(`ops.scale_from_norms`), so the card and the CPU agree bitwise. Dequantize
multiplies by the float32 reciprocal of q (`numerics.reciprocal_f32`), as
XLA rewrites the JAX package's `norms / q`.

Randomness: one Philox (seed, offset) per (step, worker, phase) from
`sparse.per_tensor_stream` under the stream names `STREAM_PHASE1` and
`STREAM_PHASE2`. The JAX package folds `jax.random` keys instead; the two
cannot agree bitwise, so the contract is the distribution. The parity tests
pass JAX's uniforms in (`uniforms=`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from deepreduce_tpu_torch.collectives import Collectives
from deepreduce_tpu_torch.numerics import reciprocal_f32
from deepreduce_tpu_torch.ops import bucket_norms_ordered, quantize_levels, quantize_levels_plain, scale_from_norms

STREAM_PHASE1 = "qar/phase1"
STREAM_PHASE2 = "qar/phase2"

Stream = Tuple[int, int]  # (philox seed, philox offset)


def _check_q(quantum_num: int) -> None:
    if not 0 < quantum_num <= 127:
        raise ValueError(
            f"quantum_num={quantum_num} does not fit the int8 wire (max 127); levels would wrap"
        )


def bucket_quantize(
    flat: torch.Tensor,
    quantum_num: int,
    bucket_size: int,
    stream: Stream,
    *,
    norms: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """QSGD per-bucket stochastic quantization of f32[n] (n a multiple of
    `bucket_size`) -> (int8[n] levels, f32[n / bucket_size] norms).

    `norms`, when given, replaces the local bucket norms (the quantized
    sparse_rs route passes the workers' shared maximum so that their levels
    are summable); they must bound the local magnitudes. `uniforms` (f32[n],
    CPU only) replaces the Philox stream with given draws: the parity
    tests' hook. On the card the levels always come from the kernel."""
    _check_q(quantum_num)
    flat = flat.contiguous()
    if norms is None:
        norms = bucket_norms_ordered(flat, bucket_size)
    # contiguous: with one bucket the reshape is a stride-0 view, which the
    # kernel's wrapper refuses
    scale = scale_from_norms(norms, quantum_num)[:, None].expand(-1, bucket_size).reshape(-1).contiguous()
    if uniforms is None:
        levels = quantize_levels(flat, scale, *stream, device=flat.device)
    elif flat.device.type != "cpu":
        raise ValueError("injected uniforms are a CPU parity hook; on CUDA the kernel draws them")
    else:
        levels = quantize_levels_plain(flat, scale, uniforms)
    return levels, norms


def bucket_dequantize(levels: torch.Tensor, norms: torch.Tensor, quantum_num: int, bucket_size: int) -> torch.Tensor:
    """int8[..., n] levels and f32[..., n / bucket_size] norms -> f32[..., n]:
    level * (norm * fl(1/q)), the arithmetic the JAX package's `norms / q`
    compiles to (a multiply by the rounded reciprocal), the same on the
    card and the CPU."""
    step = norms * reciprocal_f32(quantum_num)
    b = levels.reshape(*levels.shape[:-1], -1, bucket_size).to(torch.float32)
    return (b * step[..., None]).reshape(levels.shape)


def pad_len(d: int, num_workers: int, bucket_size: int) -> int:
    """Padded length: a whole number of buckets per worker shard."""
    shard = -(-d // num_workers)
    shard = -(-shard // bucket_size) * bucket_size
    return shard * num_workers


def wire_bits_per_worker(d: int, num_workers: int, bucket_size: int) -> float:
    """int8 levels + f32 norms one worker sends over both phases (ring
    collectives transmit the (W-1)/W fraction)."""
    n = pad_len(d, num_workers, bucket_size)
    payload_bits = n * 8 + (n // bucket_size) * 32
    return 2.0 * payload_bits * (num_workers - 1) / max(1, num_workers)


def pack_rows(levels: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """int8[R, s] levels and f32[R, s / bs] norms -> uint8[R, s + 4 s / bs]:
    each row's levels, then its norms' little-endian bytes."""
    return torch.cat([levels.view(torch.uint8), norms.contiguous().view(torch.uint8)], dim=-1)


def unpack_rows(rows: torch.Tensor, shard: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_rows` for rows of `shard` levels."""
    return rows[..., :shard].view(torch.int8), rows[..., shard:].contiguous().view(torch.float32)


def quantized_allreduce(
    flat: torch.Tensor,
    coll: Collectives,
    *,
    streams: Sequence[Stream],
    quantum_num: int = 127,
    bucket_size: int = 512,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Mean over the workers of `flat` (zero-padded to `pad_len`) through
    the int8 two-phase exchange. `streams` holds this worker's phase-1 and
    phase-2 Philox streams; `uniforms` (f32[n] and f32[n / W], CPU only)
    replaces them."""
    _check_q(quantum_num)
    n = flat.shape[0]
    w = coll.world_size
    if n % (w * bucket_size):
        raise ValueError(f"flat length {n} is not a multiple of W * bucket = {w * bucket_size}; pad with pad_len()")
    shard = n // w
    u1, u2 = uniforms if uniforms is not None else (None, None)

    # phase 1: quantize, route shard i to worker i, dequantize and sum
    levels, norms = bucket_quantize(flat, quantum_num, bucket_size, streams[0], uniforms=u1)
    rx = coll.all_to_all(pack_rows(levels.view(w, shard), norms.view(w, -1)))
    contrib = bucket_dequantize(*unpack_rows(rx, shard), quantum_num, bucket_size)  # [W, shard]
    own_sum = torch.zeros(shard, dtype=torch.float32, device=flat.device)
    for row in contrib:  # worker order, from zero
        own_sum = own_sum + row

    # phase 2: re-quantize the summed shard, allgather, dequantize
    lv2, nm2 = bucket_quantize(own_sum, quantum_num, bucket_size, streams[1], uniforms=u2)
    gathered = coll.all_gather(pack_rows(lv2, nm2))  # [W, shard + norm bytes]
    full = bucket_dequantize(*unpack_rows(gathered, shard), quantum_num, bucket_size).reshape(n)
    return full * reciprocal_f32(w)
