"""Compressed in-collective allreduce, the Ok-Topk / SparCML exchange shape,
ported from `deepreduce_tpu/sparse_rs.py`: the routes `sparse`,
`adaptive`, `quantized`, `sketch` and `oktopk` (`auto` is resolved by the
caller, `comm.GradientExchanger`, through `costmodel.select_rs_mode`).

The universe splits into W contiguous shards, one per worker:

- ``sparse``: phase 1 routes each worker's top-k entries to their shard's
  owner through one `all_to_all` (a static per-shard budget; on overflow the
  smallest magnitudes stay behind in the sender's residual); the owner adds
  the W received rows into its dense shard. Phase 2 re-selects the top k/W
  of the reduced shard and `all_gather`s (values, global indices).
- ``adaptive``: the same phase 1; then each worker's phase-2 row is either
  the sparse pairs or its int8 block-quantized dense shard, whichever its
  live density picks, flagged in the row's last lane. Receivers decode both
  interpretations and select on the flag.
- ``quantized``: no sparsifier in phase 1: the whole gradient is int8
  block-quantized against the workers' shared (max) block norms with levels
  bounded by 127 // W, so one int8 reduce-scatter sums them exactly; then
  the sparse phase 2 over the dequantized summed shard.
- ``sketch``: the sortless sampled top-k (`sparse.topk_sampled`) is count
  sketched (`codecs.countsketch`), the W sketches summed by one
  `all_reduce` (a sketch is linear: the sum's sketch), and each worker
  reads back only its own shard from the summed sketch; then the sparse
  phase 2. The own-transmitted estimate is this worker's own sketch read
  at the gathered indices.
- ``oktopk``: an all-reduced bit-pattern histogram of the local top-k
  magnitudes picks one global threshold for about k survivors in all; only
  survivors route, with a W-times smaller per-(worker, shard) capacity;
  then the sparse phase 2.

Under the resilience participation mask (`mask=`), the sparse, quantized
and oktopk routes re-own shards over the live set (`owner_permutation`: a
live worker keeps its shard, a dropped worker's shard s goes to the live
worker of rank s mod n_live): senders route entries to the deputy owner
with global indices on the wire, dropped rows are zeroed on both sides,
phase 2 re-selects owned coordinates only and the mean divides by the live
count (an IEEE divide by a device tensor, as JAX divides by a traced
count). The quantized route adds one int8 all_gather of the summed shards,
so that a deputy can dequantize the shards it serves. The adaptive lanes
and the sketch rows are per-worker wire state no deputy can serve: those
routes refuse the mask.

Every shape is static, and every data-dependent decision (budget overflow,
the adaptive flag, the oktopk threshold) stays on the device as data, so a
step makes no host sync, except the sketch route's sampled threshold, which
is read on the host (`sparse.host_branch`: one sync a step). Ties are broken as `jax.lax.top_k` breaks them
(`sparse.top_order`), scatters that add go row by row in worker order, and
dequantization multiplies by the float32 reciprocal as XLA does, so every
deterministic output equals the JAX package's bit for bit and the card's
equals the CPU's; the sketch's column sums are the exception on the card,
where `index_add_` adds in atomic order (the CPU adds in slot order, as
XLA does).

Randomness (adaptive, quantized): one Philox (seed, offset) per (step,
worker) from `sparse.per_tensor_stream` under the stream names
`STREAM_ADAPTIVE` and `STREAM_QUANTIZED`; the contract with the JAX
package's `jax.random` draws is the distribution, and the parity tests pass
JAX's uniforms in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from deepreduce_tpu_torch import qar, sparse
from deepreduce_tpu_torch.codecs import countsketch
from deepreduce_tpu_torch.collectives import Collectives
from deepreduce_tpu_torch.costmodel import sketch_cols
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import reciprocal_f32
from deepreduce_tpu_torch.ops import bucket_norms_ordered
from deepreduce_tpu_torch.telemetry.spans import span

RS_MODES = ("sparse", "adaptive", "quantized", "sketch", "oktopk")
STREAM_ADAPTIVE = "sparse_rs/adaptive"
STREAM_QUANTIZED = "sparse_rs/quantized"
ADAPTIVE_Q = 127  # a dense phase-2 row is dequantized alone: the full int8 range


def shard_size(d: int, num_workers: int) -> int:
    return (d + num_workers - 1) // num_workers


def send_budget(d: int, ratio: float, num_workers: int, headroom: float) -> int:
    """Phase-1 slots per shard: the expected k/W occupancy times headroom."""
    k = sparse.num_slots(d, ratio)
    return max(1, int(math.ceil(k / num_workers * headroom)))


def out_budget(d: int, ratio: float, num_workers: int, headroom: float = 1.0) -> int:
    """Phase-2 slots per shard: k/W times headroom, capped at the shard."""
    k = sparse.num_slots(d, ratio)
    b = max(1, int(math.ceil(k / num_workers * headroom)))
    return min(b, shard_size(d, num_workers))


def padded_shard(d: int, num_workers: int, block: int) -> int:
    """Shard length rounded up to whole quantization blocks."""
    s = shard_size(d, num_workers)
    return ((s + block - 1) // block) * block


def adaptive_lanes(d: int, ratio: float, num_workers: int, out_headroom: float, block: int) -> int:
    """f32 lanes of the adaptive phase-2 row without its flag lane: the
    larger of the sparse encoding (2 lanes a slot) and the dense one (int8
    levels 4 to a lane + one f32 norm a block)."""
    sp = padded_shard(d, num_workers, block)
    return max(2 * out_budget(d, ratio, num_workers, out_headroom), sp // 4 + sp // block)


def quantized_levels_budget(num_workers: int) -> int:
    """Largest |level| a worker may emit so that the W-worker int8 sum stays
    within 127."""
    return max(1, 127 // num_workers)


def oktopk_send_budget(d: int, ratio: float, num_workers: int, cap_headroom: float = 2.0) -> int:
    """Per-(worker, shard) slots of the oktopk all_to_all: about k survivors
    in all means k/W**2 a pair, times headroom."""
    k = sparse.num_slots(d, ratio)
    return max(1, int(math.ceil(k / (num_workers * num_workers) * cap_headroom)))


def oktopk_shift(bins: int) -> int:
    """Right shift that maps a positive float32's bit pattern onto `bins`
    buckets in magnitude order."""
    return 31 - int(round(math.log2(bins)))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _scatter_set(n: int, tgt: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros[n] with `vals` at `tgt`; targets are unique, those at or past n
    are dropped (the buffer is cut after a unique-target write)."""
    out = torch.zeros(n + tgt.shape[0], dtype=vals.dtype, device=vals.device)
    out[tgt.long()] = vals
    return out[:n]


def _route(values, indices, select, coll: Collectives, S: int, B: int, label: str = "sparse"):
    """Phase 1 over the entries marked `select` (in descending-magnitude
    order): route each to its shard's owner through one all_to_all, at most
    B per (worker, shard), the smallest dropped; the owner adds the W
    received rows into its dense shard in worker order. Returns (shard
    f32[S], keep, idxs, vals, pos), the latter four in routing order for
    the own-transmitted scatter."""
    W = coll.world_size
    dev = values.device
    k = values.shape[0]
    with span("sparse_rs/route", route=label):
        shard_of = torch.where(select, indices // S, W)  # dead -> parked shard W
        # a stable sort by shard keeps the descending order within each shard
        order = torch.sort(shard_of, stable=True).indices
        sh, vals, idxs = shard_of[order], values[order], indices[order]
        pos = torch.arange(k, dtype=torch.int32, device=dev)
        starts = torch.ones(k, dtype=torch.bool, device=dev)
        starts[1:] = sh[1:] != sh[:-1]
        rank = pos - torch.cummax(torch.where(starts, pos, -1), 0).values
        keep = (sh < W) & (rank < B)
        tgt = torch.where(keep, sh * B + rank, W * B + pos)
        send_v = _scatter_set(W * B, tgt, vals).view(W, B)
        send_i = _scatter_set(W * B, tgt, (idxs - sh * S).to(torch.int32)).view(W, B)
        rx = coll.all_to_all(torch.cat([send_v, _f32(send_i)], dim=1))  # [W, 2B]
    rx_v, rx_i = rx[:, :B], _i32(rx[:, B:]).long()
    # the nonzero entries of a row have unique targets: set each row into
    # its own slice (entries of value zero, dead slots among them, park past
    # S: adding them would change nothing), then add the rows in worker
    # order from zero, the order of the JAX package's scatter-add
    with span("sparse_rs/reduce", route=label):
        slots = torch.arange(B, device=dev)
        live = rx_v != 0
        shard = torch.zeros(S, dtype=torch.float32, device=dev)
        for w in range(W):
            row = torch.zeros(S + B, dtype=torch.float32, device=dev)
            row[torch.where(live[w], rx_i[w], S + slots)] = rx_v[w]
            shard = shard + row[:S]
    return shard, keep, idxs, vals, pos


def _own_transmitted(keep, idxs, vals, pos, W: int, S: int, d: int) -> torch.Tensor:
    """What left this worker (phase-1 truncation applied), dense f32[d]."""
    return _scatter_set(W * S, torch.where(keep, idxs, W * S + pos), vals)[:d]


def _phase2_pack(shard_est: torch.Tensor, widx: int, S: int, K2: int) -> torch.Tensor:
    """Re-select the reduced shard: f32[2 K2], values then bitcast global
    indices."""
    top_i = sparse.top_order(shard_est.abs(), K2)
    out_idx = (top_i + widx * S).to(torch.int32)
    return torch.cat([shard_est[top_i], _f32(out_idx)])


def _phase2_unpack(gathered: torch.Tensor, K2: int, W: int, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (clipped global indices i64[W K2], dense numerator f32[W S]). The
    indices are unique (disjoint shards, distinct picks), so the add is a
    set into zeros."""
    gi = torch.clamp(_i32(gathered[:, K2:]).reshape(-1).long(), 0, W * S - 1)
    dense = torch.zeros(W * S, dtype=torch.float32, device=gathered.device)
    return gi, dense.index_add_(0, gi, gathered[:, :K2].reshape(-1))


def exchange(
    flat: torch.Tensor,
    coll: Collectives,
    *,
    ratio: float,
    approx_topk: bool = False,
    rs_mode: str = "sparse",
    headroom: float = 2.0,
    out_headroom: float = 1.0,
    block_size: int = 256,
    density_threshold: float = 1.0,
    sketch_rows: int = 5,
    sketch_cols: int = 0,
    sketch_seed: int = 0,
    oktopk_bins: int = 4096,
    oktopk_cap_headroom: float = 2.0,
    stream: Optional[qar.Stream] = None,
    uniforms: Optional[torch.Tensor] = None,
    collect: Optional[Dict[str, torch.Tensor]] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, WireStats]:
    """-> (mean f32[d], own-transmitted dense f32[d] for error feedback,
    wire stats) of this worker. `approx_topk` selects the sparse and adaptive
    routes' candidates through `sparse.topk(approx=True)` (the JAX package's
    approx_max_k; exact off the TPU, so the same selection); oktopk refuses
    it. `stream` is the worker's Philox stream for
    the routes that quantize (adaptive, quantized); `uniforms` (CPU only)
    replaces it. `collect`, when a dict, receives the adaptive route's
    `rs_density` / `rs_dense_switches` and the oktopk route's
    `rs_oktopk_survivors` / `rs_oktopk_threshold` / `rs_oktopk_spills`.
    `mask` (bool[W] on the device, the same on every worker) selects the
    route's participation-mask variant; an all-ones mask gives the
    mask-free route's outputs."""
    if rs_mode not in RS_MODES:
        raise ValueError(
            f"rs_mode={rs_mode!r} is not a route (routes: {list(RS_MODES)}); 'auto' is resolved by the caller "
            "(GradientExchanger, through costmodel.select_rs_mode)"
        )
    if rs_mode in ("adaptive", "quantized") and stream is None and uniforms is None:
        raise ValueError(f"rs_mode={rs_mode!r} quantizes and needs a Philox stream")
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise ValueError(f"flat must be a 1-d float32 tensor, got {flat.dtype} {tuple(flat.shape)}")
    if mask is not None:
        if rs_mode == "sparse":
            return _exchange_sparse_masked(flat, coll, ratio=ratio, approx_topk=approx_topk, headroom=headroom,
                                           out_headroom=out_headroom, mask=mask)
        if rs_mode == "quantized":
            return _exchange_quantized_masked(flat, coll, ratio=ratio, out_headroom=out_headroom, block=block_size,
                                              stream=stream, uniforms=uniforms, mask=mask)
        if rs_mode == "oktopk":
            return _exchange_oktopk_masked(flat, coll, ratio=ratio, out_headroom=out_headroom, bins=oktopk_bins,
                                           cap_headroom=oktopk_cap_headroom, collect=collect, mask=mask)
        raise ValueError(
            f"rs_mode={rs_mode!r} has no live-mask-aware variant (adaptive lane switches and sketch rows are "
            "per-worker wire state no deputy can re-own) — config fences this as resilience-vs-owner-communicator"
        )
    if rs_mode == "sparse":
        return _exchange_sparse(flat, coll, ratio=ratio, approx_topk=approx_topk, headroom=headroom,
                                out_headroom=out_headroom)
    if rs_mode == "adaptive":
        return _exchange_adaptive(
            flat, coll, ratio=ratio, approx_topk=approx_topk, headroom=headroom, out_headroom=out_headroom,
            block=block_size, density_threshold=density_threshold, stream=stream, uniforms=uniforms,
            collect=collect,
        )
    if rs_mode == "quantized":
        return _exchange_quantized(
            flat, coll, ratio=ratio, out_headroom=out_headroom, block=block_size, stream=stream, uniforms=uniforms
        )
    if rs_mode == "sketch":
        return _exchange_sketch(flat, coll, ratio=ratio, out_headroom=out_headroom, rows=sketch_rows, cols=sketch_cols,
                                seed=sketch_seed)
    if approx_topk:
        # the threshold-count containment needs the exact local top-k (config
        # fences this as 'rs-oktopk-vs-approx-topk'; this is the backstop)
        raise ValueError("rs_mode='oktopk' requires exact local top-k candidates (approx_topk=False)")
    return _exchange_oktopk(
        flat, coll, ratio=ratio, out_headroom=out_headroom, bins=oktopk_bins, cap_headroom=oktopk_cap_headroom,
        collect=collect,
    )


def _sparse_phase2(shard_est, coll: Collectives, S: int, K2: int, d: int, label: str = "sparse"):
    """Re-select, all_gather and scatter: (global indices, mean f32[d])."""
    W = coll.world_size
    with span("sparse_rs/allgather", route=label):
        gathered = coll.all_gather(_phase2_pack(shard_est, coll.rank, S, K2))  # [W, 2 K2]
        gi, dense = _phase2_unpack(gathered, K2, W, S)
    return gi, dense[:d] * reciprocal_f32(W)


def _exchange_sparse(flat, coll: Collectives, *, ratio, approx_topk, headroom, out_headroom):
    d, W = flat.shape[0], coll.world_size
    S = shard_size(d, W)
    B = send_budget(d, ratio, W, headroom)
    K2 = out_budget(d, ratio, W, out_headroom)
    with span("sparse_rs/select", route="sparse"):
        sp = sparse.topk(flat, ratio, sort_indices=False, approx=approx_topk)
        live = torch.arange(sp.k, device=flat.device) < sp.nnz
    shard, keep, idxs, vals, pos = _route(sp.values, sp.indices, live, coll, S, B)
    _, mean = _sparse_phase2(shard, coll, S, K2, d)
    own = _own_transmitted(keep, idxs, vals, pos, W, S, d)
    # every routed or gathered entry is an f32 value + an i32 index
    return mean, own, WireStats.constant((W * B + K2) * 32.0, (W * B + K2) * 32.0, d * 32.0, flat.device)


def _exchange_adaptive(
    flat, coll: Collectives, *, ratio, approx_topk, headroom, out_headroom, block, density_threshold, stream, uniforms,
    collect,
):
    d, W = flat.shape[0], coll.world_size
    dev = flat.device
    S = shard_size(d, W)
    Sp = padded_shard(d, W, block)
    B = send_budget(d, ratio, W, headroom)
    K2 = out_budget(d, ratio, W, out_headroom)
    L = adaptive_lanes(d, ratio, W, out_headroom, block)
    q = ADAPTIVE_Q
    with span("sparse_rs/select", route="adaptive"):
        sp = sparse.topk(flat, ratio, sort_indices=False, approx=approx_topk)
        live = torch.arange(sp.k, device=dev) < sp.nnz
    shard, keep, idxs, vals, pos = _route(sp.values, sp.indices, live, coll, S, B, label="adaptive")

    # the density decision stays on the device
    density = (shard != 0).sum(dtype=torch.float32) * reciprocal_f32(S)
    go_dense = (density > density_threshold).to(torch.float32)
    if collect is not None:
        collect["rs_density"] = density
        collect["rs_dense_switches"] = go_dense

    # both encodings, every step; the flag selects one as raw bits (the
    # unused lanes of a dense row may read as NaN: never pass them through
    # arithmetic)
    with span("sparse_rs/adaptive-quantize", route="adaptive"):
        sparse_row = torch.zeros(L, dtype=torch.float32, device=dev)
        sparse_row[: 2 * K2] = _phase2_pack(shard, coll.rank, S, K2)
        padded = torch.zeros(Sp, dtype=torch.float32, device=dev)
        padded[:S] = shard
        levels, norms = qar.bucket_quantize(padded, q, block, stream, uniforms=uniforms)
        dense_row = torch.zeros(L, dtype=torch.float32, device=dev)
        dense_row[: Sp // 4 + Sp // block] = torch.cat([_f32(levels), norms])
        body = torch.where(go_dense > 0.5, _i32(dense_row), _i32(sparse_row))
        row = torch.cat([_f32(body), go_dense[None]])  # [L + 1]
    with span("sparse_rs/allgather", route="adaptive"):
        gathered = coll.all_gather(row)  # [W, L + 1]

    flags = gathered[:, L:]  # [W, 1]
    body = gathered[:, :L]
    s_idx = torch.clamp(_i32(body[:, K2 : 2 * K2]).reshape(-1).long(), 0, W * S - 1)
    s_vals = torch.where(flags < 0.5, body[:, :K2], 0.0).reshape(-1)
    # live sparse indices are unique; a dense row's lanes read as indices
    # may repeat, but carry +0.0, which adds exactly in any order
    s_contrib = torch.zeros(W * S, dtype=torch.float32, device=dev).index_add_(0, s_idx, s_vals)
    lv_rx = body[:, : Sp // 4].contiguous().view(torch.int8)  # [W, Sp]
    nm_rx = body[:, Sp // 4 : Sp // 4 + Sp // block]
    deq = qar.bucket_dequantize(lv_rx, nm_rx, q, block)  # [W, Sp]
    d_contrib = torch.where(flags > 0.5, torch.nan_to_num(deq[:, :S]), 0.0).reshape(W * S)
    mean = (s_contrib + d_contrib)[:d] * reciprocal_f32(W)

    own = _own_transmitted(keep, idxs, vals, pos, W, S, d)
    return mean, own, WireStats.constant(W * B * 32.0, (W * B + L + 1) * 32.0, d * 32.0, dev)


def _exchange_quantized(flat, coll: Collectives, *, ratio, out_headroom, block, stream, uniforms):
    d, W = flat.shape[0], coll.world_size
    n = padded_shard(d, W, block) * W
    Ssh = n // W
    K2 = out_budget(d, ratio, W, out_headroom)
    q = quantized_levels_budget(W)
    gp = torch.zeros(n, dtype=torch.float32, device=flat.device)
    gp[:d] = flat
    # shared norms bound every worker's magnitudes, so each level is <= q and
    # the W-worker int8 sum cannot exceed W q <= 127
    with span("sparse_rs/norm-pmax", route="quantized"):
        norms = coll.all_reduce_max(bucket_norms_ordered(gp, block))
    with span("sparse_rs/quantize", route="quantized"):
        levels, _ = qar.bucket_quantize(gp, q, block, stream, norms=norms, uniforms=uniforms)
    with span("sparse_rs/reduce-scatter", route="quantized"):
        summed = coll.reduce_scatter_sum(levels)  # int8[Ssh], exact
    nb = Ssh // block
    shard_est = qar.bucket_dequantize(summed, norms[coll.rank * nb : (coll.rank + 1) * nb], q, block)
    gi, mean = _sparse_phase2(shard_est, coll, Ssh, K2, d, label="quantized")
    # own contribution: this worker's dequantized levels at the selected
    # indices (unique, so the add is a set)
    my_deq = qar.bucket_dequantize(levels, norms, q, block)
    own = torch.zeros(W * Ssh, dtype=torch.float32, device=flat.device).index_add_(0, gi, my_deq[gi])[:d]
    value_bits = n * 8.0 + (n // block) * 32.0 + K2 * 32.0  # the int8 levels, the block norms, the phase-2 values
    return mean, own, WireStats.constant(K2 * 32.0, value_bits, d * 32.0, flat.device)


def _exchange_sketch(flat, coll: Collectives, *, ratio, out_headroom, rows, cols, seed):
    d, W = flat.shape[0], coll.world_size
    dev = flat.device
    S = shard_size(d, W)
    K2 = out_budget(d, ratio, W, out_headroom)
    k = sparse.num_slots(d, ratio)
    C = sketch_cols(d, ratio, rows, cols)
    with span("sparse_rs/select", route="sketch"):
        sp = sparse.topk_sampled(flat, ratio, k=k)
        live = torch.arange(sp.k, device=dev) < sp.nnz
    with span("sparse_rs/sketch", route="sketch"):
        sk = countsketch.sketch_from_sparse(torch.where(live, sp.values, 0.0), sp.indices, rows, C, seed=seed)
    with span("sparse_rs/psum", route="sketch"):
        summed = coll.all_reduce_sum(sk)  # linear: the sketch of the sum
    # read back this worker's shard only
    with span("sparse_rs/unsketch", route="sketch"):
        shard_idx = torch.arange(S, dtype=torch.int64, device=dev) + coll.rank * S
        shard_est = countsketch.unsketch_at(summed, shard_idx, seed=seed)
    gi, mean = _sparse_phase2(shard_est, coll, S, K2, d, label="sketch")
    # error feedback: this worker's own sketch read at the gathered indices,
    # what it effectively contributed to the mean, collisions included (the
    # indices are unique, so the add is a set)
    own_est = countsketch.unsketch_at(sk, gi, seed=seed)
    own = torch.zeros(W * S, dtype=torch.float32, device=dev).index_add_(0, gi, own_est)[:d]
    return mean, own, WireStats.constant(K2 * 32.0, (rows * C + K2) * 32.0, d * 32.0, dev)


def _exchange_oktopk(flat, coll: Collectives, *, ratio, out_headroom, bins, cap_headroom, collect):
    d, W = flat.shape[0], coll.world_size
    dev = flat.device
    S = shard_size(d, W)
    Bo = oktopk_send_budget(d, ratio, W, cap_headroom)
    K2 = out_budget(d, ratio, W, out_headroom)
    shift = oktopk_shift(bins)

    with span("exchange/encode", route="oktopk"):
        # candidates: the local exact top-k, descending
        with span("sparse_rs/select", route="oktopk"):
            sp = sparse.topk(flat, ratio, sort_indices=False)
            k = sp.k
            live = torch.arange(k, device=dev) < sp.nnz
            mag = torch.where(live, sp.values.abs(), 0.0)
            # one global threshold from the all-reduced histogram of the bit
            # patterns (non-negative float32 patterns sort like the values);
            # the counts are integers below 2**24, exact in any order
            bucket = _i32(mag) >> shift
            nonzero = live & (mag > 0)
            hist = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(0, bucket.long(),
                                                                                 nonzero.to(torch.float32))
        with span("sparse_rs/psum", route="oktopk"):
            cum = torch.flip(torch.cumsum(torch.flip(coll.all_reduce_sum(hist), (0,)), 0), (0,))
        # the highest bucket that still admits k entries (0 if none does:
        # then every nonzero entry survives)
        b_star = torch.where(cum >= float(k), torch.arange(bins, dtype=torch.int32, device=dev), 0).amax()
        survive = nonzero & (bucket >= b_star)

    shard, keep, idxs, vals, pos = _route(sp.values, sp.indices, survive, coll, S, Bo, label="oktopk")
    with span("exchange/decode", route="oktopk"):
        _, mean = _sparse_phase2(shard, coll, S, K2, d, label="oktopk")
        own = _own_transmitted(keep, idxs, vals, pos, W, S, d)
    if collect is not None:
        collect["rs_oktopk_survivors"] = torch.index_select(cum, 0, b_star.long().reshape(1))[0]
        collect["rs_oktopk_threshold"] = _f32((b_star << shift).reshape(1))[0]
        collect["rs_oktopk_spills"] = survive.sum(dtype=torch.float32) - keep.sum(dtype=torch.float32)
    # the histogram lanes count as values
    return mean, own, WireStats.constant((W * Bo + K2) * 32.0, (W * Bo + K2 + bins) * 32.0, d * 32.0, dev)


# -- the participation-mask variants ---------------------------------------- #


def owner_permutation(mask: torch.Tensor, num_workers: int) -> torch.Tensor:
    """owner_of[s] (int64 [W]): the worker serving shard s under the mask.
    A live worker keeps its shard; a dropped worker's shard goes to the live
    worker of rank s mod n_live in the ascending live set (a stable sort of
    the not-live flags, no host sync). The identity under an all-ones mask,
    and the same on every worker."""
    W = num_workers
    live = mask.to(torch.float32).reshape(W) > 0.0
    n_live = live.sum(dtype=torch.int64)
    packed = torch.sort((~live).to(torch.int32), stable=True).indices
    ar = torch.arange(W, device=mask.device)
    deputy = packed[ar % torch.clamp(n_live, min=1)]
    return torch.where(live, ar, deputy)


def _masked_route(values, indices, select, owner_of, live_self, coll: Collectives, S: int, B: int, mask_f):
    """Masked phase 1: route the entries marked `select` (in descending
    magnitude order) to the deputy owner of their shard through one
    all_to_all, at most B per (worker, target), global indices on the wire;
    a dropped sender sends nothing and a dropped sender's received row is
    zeroed. The receiver adds the W rows into its [W S] deputy buffer in
    worker order. Returns (deputy buffer, keep, idxs, vals, pos), the latter
    four in routing order for the own-transmitted scatter."""
    W = coll.world_size
    dev = values.device
    k = values.shape[0]
    tw = torch.where(select, owner_of[torch.clamp(indices.long() // S, 0, W - 1)], W)  # dead -> parked W
    order = torch.sort(tw, stable=True).indices
    tws, vals, idxs = tw[order], values[order], indices[order]
    pos = torch.arange(k, dtype=torch.int32, device=dev)
    starts = torch.ones(k, dtype=torch.bool, device=dev)
    starts[1:] = tws[1:] != tws[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, -1), 0).values
    keep = (tws < W) & (rank < B) & live_self
    tgt = torch.where(keep, tws * B + rank, W * B + pos)
    send_v = _scatter_set(W * B, tgt, vals).view(W, B)
    send_i = _scatter_set(W * B, tgt, idxs.to(torch.int32)).view(W, B)
    rx = coll.all_to_all(torch.cat([send_v, _f32(send_i)], dim=1))  # [W, 2B]
    rx_v, rx_i = rx[:, :B] * mask_f[:, None], _i32(rx[:, B:]).long()
    # as in `_route`: each row's nonzero entries have unique targets; set a
    # row into zeros (zeros park past the buffer), add the rows in order
    n = W * S
    slots = torch.arange(B, device=dev)
    live = rx_v != 0
    buf = torch.zeros(n, dtype=torch.float32, device=dev)
    for w in range(W):
        row = torch.zeros(n + B, dtype=torch.float32, device=dev)
        row[torch.where(live[w], torch.clamp(rx_i[w], 0, n - 1), n + slots)] = rx_v[w]
        buf = buf + row[:n]
    return buf, keep, idxs, vals, pos


def _masked_phase2(est, owned, coll: Collectives, K2: int, mask_f):
    """Masked phase 2: re-select the K2 largest owned coordinates of the
    [W S] deputy estimate, all_gather (values, global indices) and add the
    live rows. Returns (clipped global indices i64[W K2], dense numerator
    f32[W S]). Owned regions are disjoint and every other pick carries an
    exact zero, so the add is exact in any order."""
    n = est.shape[0]
    top_i = sparse.top_order(torch.where(owned, est.abs(), 0.0), K2)
    out_vals = torch.where(owned[top_i], est[top_i], 0.0)
    gathered = coll.all_gather(torch.cat([out_vals, _f32(top_i.to(torch.int32))]))  # [W, 2 K2]
    gi = torch.clamp(_i32(gathered[:, K2:]).reshape(-1).long(), 0, n - 1)
    vals = (gathered[:, :K2] * mask_f[:, None]).reshape(-1)
    return gi, torch.zeros(n, dtype=torch.float32, device=est.device).index_add_(0, gi, vals)


def _mask_parts(mask, coll: Collectives):
    """(mask f32[W], this worker live: bool 0-d, owner_of, the live count
    max(n_live, 1) as a 0-d f32 on the device)."""
    W = coll.world_size
    mask_f = mask.to(torch.float32).reshape(W)
    return mask_f, mask_f[coll.rank] > 0.0, owner_permutation(mask_f, W), torch.clamp(mask_f.sum(), min=1.0)


def _exchange_sparse_masked(flat, coll: Collectives, *, ratio, approx_topk, headroom, out_headroom, mask):
    d, W = flat.shape[0], coll.world_size
    S = shard_size(d, W)
    B = send_budget(d, ratio, W, headroom)
    K2 = out_budget(d, ratio, W, out_headroom)
    mask_f, live_self, owner_of, denom = _mask_parts(mask, coll)
    sp = sparse.topk(flat, ratio, sort_indices=False, approx=approx_topk)
    live = torch.arange(sp.k, device=flat.device) < sp.nnz
    buf, keep, idxs, vals, pos = _masked_route(sp.values, sp.indices, live, owner_of, live_self, coll, S, B, mask_f)
    owned = owner_of[torch.arange(W * S, device=flat.device) // S] == coll.rank
    _, dense = _masked_phase2(buf, owned, coll, K2, mask_f)
    own = _own_transmitted(keep, idxs, vals, pos, W, S, d)
    return dense[:d] / denom, own, WireStats.constant((W * B + K2) * 32.0, (W * B + K2) * 32.0, d * 32.0,
                                                      flat.device)


def _exchange_quantized_masked(flat, coll: Collectives, *, ratio, out_headroom, block, stream, uniforms, mask):
    d, W = flat.shape[0], coll.world_size
    dev = flat.device
    n = padded_shard(d, W, block) * W
    Ssh = n // W
    K2 = out_budget(d, ratio, W, out_headroom)
    q = quantized_levels_budget(W)
    mask_f, live_self, owner_of, denom = _mask_parts(mask, coll)
    gp = torch.zeros(n, dtype=torch.float32, device=dev)
    gp[:d] = flat
    # a dropped worker's norms leave the shared max, its levels the sum
    norms = coll.all_reduce_max(torch.where(live_self, bucket_norms_ordered(gp, block), 0.0))
    levels, _ = qar.bucket_quantize(gp, q, block, stream, norms=norms, uniforms=uniforms)
    levels = torch.where(live_self, levels, torch.zeros_like(levels))
    summed = coll.reduce_scatter_sum(levels)  # int8[Ssh], exact
    shards = coll.all_gather(summed)  # int8[W, Ssh]: a deputy dequantizes the shards it serves
    nb = Ssh // block
    est = torch.cat([
        torch.where(owner_of[v] == coll.rank, qar.bucket_dequantize(shards[v], norms[v * nb : (v + 1) * nb], q, block),
                    0.0)
        for v in range(W)
    ])
    owned = owner_of[torch.arange(n, device=dev) // Ssh] == coll.rank
    gi, dense = _masked_phase2(est, owned, coll, K2, mask_f)
    # own contribution from the zeroed levels, at every gathered index (a
    # dropped row's zero-valued picks included, as in the JAX package)
    my_deq = qar.bucket_dequantize(levels, norms, q, block)
    own = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(0, gi, my_deq[gi])[:d]
    value_bits = n * 8.0 + (n // block) * 32.0 + K2 * 32.0 + Ssh * 8.0
    return dense[:d] / denom, own, WireStats.constant(K2 * 32.0, value_bits, d * 32.0, dev)


def _exchange_oktopk_masked(flat, coll: Collectives, *, ratio, out_headroom, bins, cap_headroom, collect, mask):
    d, W = flat.shape[0], coll.world_size
    dev = flat.device
    S = shard_size(d, W)
    Bo = oktopk_send_budget(d, ratio, W, cap_headroom)
    K2 = out_budget(d, ratio, W, out_headroom)
    shift = oktopk_shift(bins)
    mask_f, live_self, owner_of, denom = _mask_parts(mask, coll)
    sp = sparse.topk(flat, ratio, sort_indices=False)
    k = sp.k
    live = torch.arange(k, device=dev) < sp.nnz
    mag = torch.where(live, sp.values.abs(), 0.0)
    bucket = _i32(mag) >> shift
    nonzero = live & (mag > 0)
    # a dropped worker's candidates do not move the global threshold
    weight = torch.where(live_self, nonzero.to(torch.float32), 0.0)
    hist = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(0, bucket.long(), weight)
    cum = torch.flip(torch.cumsum(torch.flip(coll.all_reduce_sum(hist), (0,)), 0), (0,))
    b_star = torch.where(cum >= float(k), torch.arange(bins, dtype=torch.int32, device=dev), 0).amax()
    survive = nonzero & (bucket >= b_star)
    buf, keep, idxs, vals, pos = _masked_route(sp.values, sp.indices, survive, owner_of, live_self, coll, S, Bo,
                                               mask_f)
    owned = owner_of[torch.arange(W * S, device=dev) // S] == coll.rank
    _, dense = _masked_phase2(buf, owned, coll, K2, mask_f)
    own = _own_transmitted(keep, idxs, vals, pos, W, S, d)
    if collect is not None:
        collect["rs_oktopk_survivors"] = torch.index_select(cum, 0, b_star.long().reshape(1))[0]
        collect["rs_oktopk_threshold"] = _f32((b_star << shift).reshape(1))[0]
        collect["rs_oktopk_spills"] = survive.sum(dtype=torch.float32) - keep.sum(dtype=torch.float32)
    return dense[:d] / denom, own, WireStats.constant((W * Bo + K2) * 32.0, (W * Bo + K2 + bins) * 32.0, d * 32.0,
                                                      dev)
