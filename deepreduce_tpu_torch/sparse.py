"""Sparse-gradient core: `SparseGrad`, exact top-k and the rank-inversion
compaction, ported from `deepreduce_tpu/sparse.py`.

Every sparsifier returns exactly `k` slots; `nnz` says how many are live and
dead slots carry index 0, value 0. Selections and positions are bitwise
equal to the JAX package's on the same input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch import u32


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


def topk(tensor: torch.Tensor, compress_ratio: float, *, k: Optional[int] = None) -> SparseGrad:
    """Exact top-k by magnitude, indices ascending.

    Selects like `jax.lax.top_k`: among equal magnitudes the lower index
    wins. `torch.topk` promises no tie order, and ties are common (unused
    embedding rows have exactly-zero gradients), so the selection is the
    first k of a stable descending sort."""
    flat = tensor.reshape(-1)
    k = num_slots(flat.shape[0], compress_ratio) if k is None else int(k)
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    idxs = torch.sort(order).values
    return SparseGrad(
        values=flat[idxs],
        indices=idxs.to(torch.int32),
        nnz=torch.tensor(k, dtype=torch.int32, device=flat.device),
        shape=tuple(tensor.shape),
    )


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
