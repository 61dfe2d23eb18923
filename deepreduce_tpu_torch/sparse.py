"""Sparse-gradient core: `SparseGrad`, exact and sampled top-k, random-k,
the magnitude threshold with its natural-sparsity diagnostics, the identity
sparsifier and the rank-inversion compaction, ported from
`deepreduce_tpu/sparse.py`.

Every sparsifier returns exactly `k` slots; `nnz` says how many are live and
dead slots carry index 0, value 0. Selections and positions are bitwise
equal to the JAX package's on the same input.

Where the JAX package picks a branch on the device (`lax.cond` on a sampled
threshold), the port reads the predicate on the host through `host_branch`:
one device-to-host sync per call, counted in `host_branch.syncs`. Only the
branch taken runs, so the sampled path never pays for the full sort it
exists to avoid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.ops.qsgd_kernel import philox_uniforms_plain


@dataclasses.dataclass(frozen=True)
class SparseGrad:
    """values f32[k], indices i32[k], nnz i32[] and the dense shape."""

    values: torch.Tensor
    indices: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, ...] = ()

    @property
    def k(self) -> int:
        return self.values.shape[0]

    @property
    def dense_size(self) -> int:
        size = 1
        for s in self.shape:
            size *= int(s)
        return size

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """Wire leaves in the JAX pytree's flatten order."""
        return (self.values, self.indices, self.nnz)

    def to_dense(self) -> torch.Tensor:
        live = torch.arange(self.k, device=self.values.device) < self.nnz
        vals = torch.where(live, self.values, torch.zeros_like(self.values))
        idxs = torch.where(live, self.indices, torch.zeros_like(self.indices)).long()
        dense = torch.zeros(self.dense_size, dtype=self.values.dtype, device=self.values.device)
        return dense.index_add_(0, idxs, vals).reshape(self.shape)


def fit_length(vals: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or truncate a value table to exactly `n` slots."""
    if vals.shape[0] < n:
        out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
        out[: vals.shape[0]] = vals
        return out
    return vals[:n]


def scatter_ascending(
    vals: torch.Tensor, pos: torch.Tensor, nsel: torch.Tensor, d: int
) -> torch.Tensor:
    """f32[d]: `vals[s]` at `pos[s]` for live slots s < nsel. Dead slots park
    at distinct targets past d and are cut off, so no host sync is needed."""
    budget = vals.shape[0]
    slots = torch.arange(budget, device=vals.device)
    tgt = torch.where(slots < nsel, pos.long(), d + slots)
    out = torch.zeros(d + budget, dtype=vals.dtype, device=vals.device)
    out[tgt] = vals
    return out[:d]


def num_slots(dense_size: int, compress_ratio: float) -> int:
    """k = max(1, N * ratio)."""
    return max(1, int(dense_size * compress_ratio))


def bucket_num_slots(sizes, compress_ratio: float) -> int:
    """Slot budget of a fused bucket: the sum of its member leaves'
    per-tensor budgets (per-leaf rounding and the max(1, .) floor kept), so
    bucketing never changes the total wire budget."""
    return sum(num_slots(int(s), compress_ratio) for s in sizes)


def top_order(mags: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest `mags` in `jax.lax.top_k`'s order:
    descending, and among equal magnitudes the lower index first. The first
    k of a stable descending sort; `torch.topk` promises no tie order, and
    ties are common (unused embedding rows have exactly-zero gradients)."""
    return torch.sort(mags, descending=True, stable=True).indices[:k]


def topk(
    tensor: torch.Tensor, compress_ratio: float, *, sort_indices: bool = True, k: Optional[int] = None
) -> SparseGrad:
    """Exact top-k by magnitude (`top_order`), indices ascending when
    `sort_indices`, else in `jax.lax.top_k`'s descending-magnitude order."""
    flat = tensor.reshape(-1)
    k = num_slots(flat.shape[0], compress_ratio) if k is None else int(k)
    idxs = top_order(flat.abs(), k)
    if sort_indices:
        idxs = torch.sort(idxs).values
    return SparseGrad(
        values=flat[idxs],
        indices=idxs.to(torch.int32),
        nnz=torch.full((), k, dtype=torch.int32, device=flat.device),
        shape=tuple(tensor.shape),
    )


def host_branch(pred: torch.Tensor) -> bool:
    """The value of a 0-d boolean tensor on the host (one sync on CUDA),
    counted in `host_branch.syncs`: the port's form of a `lax.cond`."""
    host_branch.syncs += 1
    return bool(pred)


host_branch.syncs = 0


def randomk(
    tensor: torch.Tensor,
    compress_ratio: float,
    stream: Tuple[int, int],
    *,
    sort_indices: bool = True,
    k: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> SparseGrad:
    """Uniform random k of d without replacement: the k largest of d i.i.d.
    uniform priorities drawn from the Philox `stream` (seed, offset) by
    `philox_uniforms_plain`, the same bits on the card and on the CPU.
    Uniforms take 2**24 values, so priorities tie often at large d: they are
    ranked by `top_order` (the tie order of `lax.top_k`). `uniforms` (f32[d],
    CPU only) replaces the draws: the parity tests feed the priorities JAX
    draws."""
    flat = tensor.reshape(-1)
    d = flat.shape[0]
    k = num_slots(d, compress_ratio) if k is None else int(k)
    if uniforms is None:
        priorities = philox_uniforms_plain(d, stream[0], stream[1], device=flat.device)
    else:
        if flat.device.type != "cpu":
            raise ValueError("injected uniforms are a CPU parity hook; on CUDA the priorities are drawn")
        priorities = uniforms
    idxs = top_order(priorities, k)
    if sort_indices:
        idxs = torch.sort(idxs).values
    return SparseGrad(
        values=flat[idxs],
        indices=idxs.to(torch.int32),
        nnz=torch.full((), k, dtype=torch.int32, device=flat.device),
        shape=tuple(tensor.shape),
    )


def _passing(flat: torch.Tensor, threshold_val: float) -> torch.Tensor:
    """bool mask of the elements that pass `threshold_val`: the nonzeros at
    a threshold <= 0, else |g| >= threshold_val."""
    if threshold_val <= 0.0:
        return flat != 0
    return flat.abs() >= threshold_val


def natural_sparsity(tensor: torch.Tensor, threshold_val: float = 0.0) -> torch.Tensor:
    """0-d float32 fraction of the elements that pass `threshold_val` (the
    nonzeros at 0.0): the model's true sparsity at this step. The mean is
    the sum times fl(1/d), as XLA compiles the JAX package's `jnp.mean`."""
    flat = tensor.reshape(-1)
    return mean_of_sum(_passing(flat, threshold_val).to(torch.float32).sum(), flat.shape[0])


def calibrate_threshold_budget(sample_grads, threshold_val: float = 0.0, *, safety: float = 1.25) -> float:
    """The `threshold` sparsifier's budget ratio from sample gradients (a
    dict or a sequence of tensors): the largest natural sparsity over the
    leaves times `safety`, clipped to [1e-6, 1]. Host-side (one read per
    leaf), called once before the codecs are built."""
    leaves = sample_grads.values() if isinstance(sample_grads, dict) else sample_grads
    worst = 0.0
    for leaf in leaves:
        worst = max(worst, float(natural_sparsity(leaf, threshold_val)))
    return float(min(max(worst * safety, 1e-6), 1.0))


def threshold_overflow(tensor: torch.Tensor, threshold_val: float, *, budget_ratio: float = 1.0) -> torch.Tensor:
    """0-d int: how many passing elements did not fit the static budget
    k = num_slots(d, budget_ratio) this step (0: the budget captured the
    natural sparsity). Above 0 the threshold is clamped to max |g| as
    `threshold` clamps it. No host sync."""
    flat = tensor.reshape(-1)
    k = num_slots(flat.shape[0], budget_ratio)
    if threshold_val <= 0.0:
        passing = flat != 0
    else:
        mags = flat.abs()
        passing = mags >= torch.clamp(mags.max(), max=float(threshold_val))
    return torch.clamp(passing.sum() - k, min=0)


def threshold(
    tensor: torch.Tensor,
    threshold_val: float,
    *,
    budget_ratio: float = 1.0,
    k: Optional[int] = None,
) -> SparseGrad:
    """Keep |g| >= min(threshold_val, max |g|) in a static budget of
    k = num_slots(d, budget_ratio) slots: when more pass than fit, the
    largest magnitudes win (`top_order`). At `threshold_val <= 0` only
    nonzeros are kept (natural sparsity). Live slots come first in
    ascending index order: the dead ones are moved to d and sorted past
    them, all on the device (the clamp, the count and the compaction make
    no host sync)."""
    flat = tensor.reshape(-1)
    d = flat.shape[0]
    dev = flat.device
    k = num_slots(d, budget_ratio) if k is None else int(k)
    mags = flat.abs()
    thr = torch.clamp(mags.max(), max=float(threshold_val))
    idxs = top_order(mags, k)
    vals_top = mags[idxs]
    keep = vals_top >= thr
    if threshold_val <= 0.0:
        keep = keep & (vals_top > 0)
    nnz = keep.sum().to(torch.int32)
    idxs = torch.sort(torch.where(keep, idxs, d)).values
    live = torch.arange(k, device=dev) < nnz
    idxs = torch.where(live, idxs, 0)
    vals = torch.where(live, flat[idxs], torch.zeros((), dtype=flat.dtype, device=dev))
    return SparseGrad(values=vals, indices=idxs.to(torch.int32), nnz=nnz, shape=tuple(tensor.shape))


def none_sparsifier(tensor: torch.Tensor) -> SparseGrad:
    """Identity sparsifier (the dense baseline's 'none'): every element, in
    order."""
    flat = tensor.reshape(-1)
    d = flat.shape[0]
    return SparseGrad(
        values=flat,
        indices=torch.arange(d, dtype=torch.int32, device=flat.device),
        nnz=torch.full((), d, dtype=torch.int32, device=flat.device),
        shape=tuple(tensor.shape),
    )


def sampled_kth_magnitude(
    flat: torch.Tensor, k: int, *, sample_size: int = 1 << 15, undershoot: float = 0.9
) -> torch.Tensor:
    """0-d estimate of the k-th largest |flat| from a strided sample of about
    `sample_size` elements, aimed at capturing `undershoot * k` elements
    (the sample rank uses Python's `round`, as the JAX package does). Below
    2 * sample_size elements the whole tensor is sorted instead."""
    d = flat.shape[0]
    mags = flat.abs()
    if d <= 2 * sample_size:
        return torch.sort(mags).values[d - k]
    samp = mags[:: d // sample_size]
    s = samp.shape[0]
    r = max(1, int(round(s * k * undershoot / d)))
    return torch.sort(samp).values[s - r]


def topk_sampled(
    tensor: torch.Tensor,
    compress_ratio: float,
    *,
    sample_size: int = 1 << 15,
    undershoot: float = 0.9,
    k: Optional[int] = None,
) -> SparseGrad:
    """Sortless approximate top-k: the ascending set {j : |g_j| >= t} for the
    sampled threshold t, cut to k slots by the rank-inversion compaction;
    `nnz <= k` is data-dependent. Small tensors (d <= max(4k, 2 *
    sample_size)) take exact `topk` statically. A zero threshold (a sample
    of zeros from a tensor with nonzeros elsewhere) takes exact `topk` for
    this call: a `>= 0` mask would select the first k positions whatever
    their magnitude. The branch is read on the host (`host_branch`)."""
    flat = tensor.reshape(-1)
    d = flat.shape[0]
    k = num_slots(d, compress_ratio) if k is None else int(k)
    if d <= max(4 * k, 2 * sample_size):
        return topk(tensor, compress_ratio, k=k)
    t = sampled_kth_magnitude(flat, k, sample_size=sample_size, undershoot=undershoot)
    if not host_branch(t > 0):
        return topk(tensor, compress_ratio, k=k)
    pos, nnz = _prefix_positions(flat.abs() >= t, k)
    live = torch.arange(k, device=flat.device) < nnz
    idxs = torch.where(live, pos, 0)
    vals = torch.where(live, flat[idxs.long()], torch.zeros((), dtype=flat.dtype, device=flat.device))
    return SparseGrad(values=vals, indices=idxs, nnz=nnz, shape=tuple(tensor.shape))


def _select_bit(word: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Position of the (t+1)-th set bit of each 32-bit `word` (int64) —
    the 5-step binary select over popcounts of low halves."""
    pos = torch.zeros_like(t)
    rem = t
    for width in (16, 8, 4, 2, 1):
        c = u32.popcount((word >> pos) & ((1 << width) - 1))
        hi = rem >= c
        rem = rem - torch.where(hi, c, 0)
        pos = pos + torch.where(hi, width, 0)
    return pos


def _prefix_positions(mask: torch.Tensor, budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions i32[budget], count i32[]): universe positions of the first
    `budget` True entries of `mask`, ascending, by the same rank inversion
    as the JAX package (group words, popcount prefix, one marker scatter-add,
    in-word select) so that dead slots match too."""
    d = mask.shape[0]
    dev = mask.device
    g_count = (d + 31) // 32
    padded = torch.zeros(g_count * 32, dtype=torch.int64, device=dev)
    padded[:d] = mask.to(torch.int64)
    hw = (padded.view(g_count, 32) << torch.arange(32, device=dev)).sum(dim=1)
    cnt = u32.popcount(hw)
    cs = torch.cumsum(cnt, 0)
    p_ex = cs - cnt
    count = torch.clamp(cs[-1], max=budget)
    markers = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    markers.index_add_(0, torch.clamp(p_ex, max=budget), torch.ones_like(p_ex))
    g_of_s = torch.clamp(torch.cumsum(markers, 0)[:budget] - 1, 0, g_count - 1)
    t = torch.arange(budget, device=dev) - p_ex[g_of_s]
    b = _select_bit(hw[g_of_s], t)
    pos = torch.clamp(g_of_s * 32 + b, 0, d - 1)
    return pos.to(torch.int32), count.to(torch.int32)


def stable_name_hash(name: str) -> int:
    """PYTHONHASHSEED-independent 32-bit hash of a tensor name: the murmur3
    fmix32 finalizer chained over the UTF-8 bytes, as in the JAX package,
    so every process derives the same value for the same name."""
    h = 0x9747B28C
    for b in name.encode("utf-8"):
        h = (h ^ b) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        h ^= h >> 16
    return h


def per_tensor_stream(seed: int, name: str, step: int, worker: int) -> Tuple[int, int]:
    """(philox_seed, philox_offset) of one tensor's stochastic draws at one
    step on one worker — the role of the JAX package's `per_tensor_key`.
    The key holds (config seed, name hash); the counter's upper half holds
    (worker, step), so no two tensors, steps or workers share a stream.
    Bitwise parity with `jax.random` is impossible and not attempted."""
    philox_seed = (int(seed) & 0xFFFFFFFF) | (stable_name_hash(name) << 32)
    philox_offset = (int(worker) & 0xFFFFFFFF) | ((int(step) & 0xFFFFFFFF) << 32)
    return philox_seed, philox_offset
