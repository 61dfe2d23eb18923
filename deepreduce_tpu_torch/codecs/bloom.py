"""Bloom-filter index codec, ported from `deepreduce_tpu/codecs/bloom.py`
in three layouts:

- classic (`bloom_blocked=False`, the JAX default and the README quick
  start's): each index sets h bits of an m-bit array, at
  `fmix32(j ^ seed_i) mod m` for the derived seeds `hash_seeds(h)`;
- mod-blocked (`bloom_blocked='mod'` or True): index j sets `lane_mask(j)`
  (h bit lanes from murmur-mixed words) in word `j mod W`, W odd;
- hash-blocked (`bloom_blocked='hash'`): the same lanes in word
  `fmix32(j ^ _SEED_BLOCK) mod W`, so the universe query takes one gather
  per index.

Only the words cross the wire; both sides re-derive the index set by
querying the whole universe and running the selection policy over the
positives (`select`): the prefix policies (leftmost, p0) take the first
`budget` positives in ascending order; `random` (P1) takes the `budget`
positives of largest uniform priority; `conflict_sets_approx` (the
approximate P2) groups the positives by the filter word their bits share
and draws round-robin, one random member per set, small sets first. The
random draws are keyed by (seed, step) only (`selection_stream`), so every
worker, and the encoder and the decoder, derive the same selection from
the same filter; they are Philox uniforms, the same bits on the card and
on the CPU. The encoder is FP-aware: it re-reads the dense values at
exactly the selected positions, so receivers place true values where they
derive them.

The filter is a set, so the port builds its words any way that gives them
bitwise: the classic insert sets a bit array at the hash positions and
packs it, where the JAX package sorts and scans (`_scatter_or`). In the mod
layout the filter is built either from the selected indices (`insert`) or,
with the threshold insert, straight from the dense tensor as the set
{j : |g_j| >= t} (`insert_from_dense`); `encode_dense_direct` takes t from
a strided sample and runs no top-k at all. Where the JAX package branches
on the device (`lax.cond` on t > 0), the port reads the predicate on the
host (`sparse.host_branch`).

On the card the mod layout under a prefix policy runs as three CUDA
kernels (`ops.bloom_mod`): `insert`, the FP-aware query-and-gather and the
decoder's placement, each one launch a leaf where the torch code below is
some hundreds. `_on_kernel` is the one place that chooses them; the torch
code runs everywhere else, and the kernels equal it bit for bit.

The hashes are wrapping uint32 arithmetic, done here in int64 with
masking (`u32`); filter words, `nsel` and positions are bitwise equal to
the JAX package's, and so are the random policies' selections given the
JAX package's uniforms (the tests' hook). Words travel as int32 tensors
holding the uint32 bit pattern. The exact conflict_sets policy is the C++
host library's alone, as in the reference (`codecs.bloom_native`);
`BloomMeta.create` raises for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from deepreduce_tpu_torch import sparse as _sparse
from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.ops import bloom_mod
from deepreduce_tpu_torch.ops.qsgd_kernel import philox_uniforms_plain
from deepreduce_tpu_torch.sparse import SparseGrad, _prefix_positions

_LN2 = 0.6931471805599453
_GOLDEN = 0x9E3779B9
_QUERY_CHUNK = 1 << 16
_SEED_BLOCK = 0xA2C2A9F7
_SEED_LANE1 = 0x6A09E667
_SEED_LANE2 = 0xBB67AE85
# the stream name of the random policies' draws (`selection_stream`)
SELECT_STREAM = "bloom/select"
POLICIES = ("leftmost", "p0", "random", "conflict_sets_approx")


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64 words in [0, 2**32)."""
    x = x & u32.MASK32
    x = x ^ (x >> 16)
    x = u32.mul_lo(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = u32.mul_lo(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_seeds(num_hash: int, device=None) -> torch.Tensor:
    """The classic filter's per-hash seeds (int64 words), derived, not
    stored: fmix32(j * golden) for j = 1..h."""
    j = torch.arange(1, num_hash + 1, dtype=torch.int64, device=device)
    return fmix32(j * _GOLDEN)


def hash_positions(indices: torch.Tensor, seeds: torch.Tensor, m_bits: int) -> torch.Tensor:
    """i32[..., h]: the classic filter's bit positions of each index."""
    idx = indices.to(torch.int64) & u32.MASK32
    return (fmix32(idx[..., None] ^ seeds) % m_bits).to(torch.int32)


def _lanes(indices: torch.Tensor, num_hash: int):
    """The h bit lanes (int64 in [0, 32)) of each index, in hash order."""
    idx = indices.to(torch.int64) & u32.MASK32
    r1 = fmix32(idx ^ _SEED_LANE1)
    r2 = fmix32(idx ^ _SEED_LANE2) if num_hash > 6 else None
    return [((r1 if j < 6 else r2) >> (5 * (j % 6))) & 31 for j in range(num_hash)]


def lane_mask(indices: torch.Tensor, num_hash: int) -> torch.Tensor:
    """32-bit in-word mask (int64) for each index: h lanes from 5-bit fields
    of one or two murmur-mixed words."""
    mask = torch.zeros(indices.shape, dtype=torch.int64, device=indices.device)
    for lane in _lanes(indices, num_hash):
        mask = mask | (torch.ones_like(lane) << lane)
    return mask


def blocked_block_and_mask(indices: torch.Tensor, meta: "BloomMeta") -> Tuple[torch.Tensor, torch.Tensor]:
    """(word index, 32-bit lane mask) of each index in a blocked filter:
    word `j mod W` in the mod layout, `fmix32(j ^ _SEED_BLOCK) mod W` in the
    hash layout (int64 both)."""
    idx = indices.to(torch.int64) & u32.MASK32
    n_words = meta.n_words
    if meta.blocked == "mod":
        block = idx % n_words
    else:
        block = fmix32(idx ^ _SEED_BLOCK) % n_words
    return block, lane_mask(idx, meta.num_hash)


def bloom_config(k: int, d: int, fpr: Optional[float]) -> Tuple[int, int, float]:
    """(m_bits, num_hash, fpr) of the classic filter for (k, d)."""
    if fpr is None:
        fpr = 0.1 * k / d
    m_bytes = int(math.ceil(k * abs(math.log(fpr)) / (_LN2 * _LN2) / 8.0))
    m_bytes = max(8, (m_bytes + 7) // 8 * 8)
    num_hash = max(1, int(math.ceil((m_bytes * 8.0 / k) * _LN2)))
    return m_bytes * 8, num_hash, fpr


def _blocked_fpr(k: int, n_words: int, h: int) -> float:
    """FPR of a register-blocked filter: the Poisson mixture over block loads."""
    lam = k / n_words
    total = 0.0
    pj = math.exp(-lam)
    for j in range(0, 64):
        set_bits = 32.0 * (1.0 - (1.0 - 1.0 / 32.0) ** (j * h))
        total += pj * (set_bits / 32.0) ** h
        pj *= lam / (j + 1)
        if pj < 1e-12 and j > lam:
            break
    return total


def blocked_bloom_config(
    k: int, d: int, fpr: Optional[float], mode: str = "hash"
) -> Tuple[int, int, float]:
    if fpr is None:
        fpr = 0.1 * k / d
    classic_bits, _, _ = bloom_config(k, d, fpr)
    best = None
    n_words = max(1, classic_bits // 32)
    for _ in range(16):
        for h in range(1, 13):
            if _blocked_fpr(k, n_words, h) <= fpr:
                best = (n_words, h)
                break
        if best:
            break
        n_words = int(n_words * 1.3) + 1
    if best is None:
        best = (n_words, 12)
    n_words, h = best
    if mode == "mod":
        n_words |= 1  # odd: coprime to power-of-2 index strides
    return n_words * 32, h, fpr


def p0_budget(k: int, d: int, fpr: float) -> int:
    """Static slot budget of policy p0: the Lemma-6 expectation of the
    positive count plus headroom."""
    return min(d, int(math.ceil(k + 1.05 * fpr * (d - k))) + 64)


def policy_budget(policy: str, k: int, d: int, fpr: float) -> int:
    return p0_budget(k, d, fpr) if policy == "p0" else k


@dataclasses.dataclass(frozen=True)
class BloomMeta:
    """Static codec geometry, shared by encode and decode."""

    d: int
    k: int
    m_bits: int
    num_hash: int
    fpr: float
    policy: str
    budget: int
    blocked: str = ""  # "" = classic, "mod" = mod-blocked, "hash" = hash-blocked

    @property
    def n_words(self) -> int:
        return self.m_bits // 32

    @staticmethod
    def create(
        k: int,
        d: int,
        fpr: Optional[float] = None,
        policy: str = "leftmost",
        blocked=False,
        threshold_insert: bool = False,
    ) -> "BloomMeta":
        """`blocked`: False (classic), True / 'mod' (mod-blocked) or 'hash'
        (hash-blocked), as the JAX package's `bloom_blocked` knob spells
        them."""
        if blocked is True:
            blocked = "mod"
        elif blocked is False:
            blocked = ""
        if blocked not in ("", "mod", "hash"):
            raise ValueError(f"bloom_blocked must be a bool, 'hash' or 'mod'; got {blocked!r}")
        if threshold_insert and blocked != "mod":
            raise ValueError(f"bloom_blocked={blocked!r}: threshold_insert requires the 'mod' blocked layout")
        if policy == "conflict_sets":
            raise ValueError(
                "exact conflict_sets (P2) is native-only, as in the reference (policies.hpp:43-146): use "
                "index='bloom_native', or policy='conflict_sets_approx' for the in-graph parallel redesign"
            )
        if policy not in POLICIES:
            raise ValueError(f"unknown bloom policy {policy!r}; have {list(POLICIES)}")
        if blocked:
            m_bits, num_hash, fpr_eff = blocked_bloom_config(k, d, fpr, mode=blocked)
        else:
            m_bits, num_hash, fpr_eff = bloom_config(k, d, fpr)
        budget = policy_budget(policy, k, d, fpr_eff)
        if threshold_insert:
            # the threshold superset can exceed k (ties join the filter):
            # widen the slot budget so that the ascending-prefix cut does
            # not bias against trailing parameters
            budget = min(d, budget + int(math.ceil(0.06 * k)) + 64)
        return BloomMeta(
            d=d,
            k=k,
            m_bits=m_bits,
            num_hash=num_hash,
            fpr=fpr_eff,
            policy=policy,
            budget=budget,
            blocked=blocked,
        )


@dataclasses.dataclass(frozen=True)
class BloomPayload:
    values: torch.Tensor  # f32[budget] (f32[0] once stripped in 'both' mode)
    words: torch.Tensor  # int32[W] — uint32 filter words as bit patterns
    nsel: torch.Tensor  # i32[] — live selected count

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.values, self.words, self.nsel)


def saturated(payload: BloomPayload, meta: BloomMeta) -> torch.Tensor:
    """True when the selection filled every slot (nsel == budget), i.e.
    trailing positives may have been cut."""
    return payload.nsel.to(torch.int32) >= meta.budget


def _pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """int32 words (bit patterns) from an int64 0/1 bitmap of n_words * 32
    bits: each row of 32 summed as distinct powers of two."""
    shifts = torch.arange(32, device=bits.device)
    return u32.to_bits((bits[: n_words * 32].view(n_words, 32) << shifts).sum(dim=1))


def _on_kernel(meta: BloomMeta, t: torch.Tensor) -> bool:
    """Whether `ops.bloom_mod`'s kernels run the stage: the mod layout under
    a prefix policy, with the tensors on the card."""
    return t.is_cuda and meta.blocked == "mod" and meta.policy in bloom_mod.PREFIX_POLICIES


def insert(indices: torch.Tensor, nnz: torch.Tensor, meta: BloomMeta) -> torch.Tensor:
    """Filter words (int32 bit patterns) from the live indices.

    Mod layout: word w is the OR of the lane masks of the indices
    j = w mod W; every (index, lane) pair sets one bit of a [W, 32] bitmap,
    and dead slots set a parked bit past the end (`bloom_mod.insert` on the
    card under a prefix policy).
    Classic layout: every (index, hash) pair sets bit
    `hash_positions(j)` of an m-bit bitmap; hash layout: every (index, lane)
    pair sets bit `lane` of word `block(j)`. In both, dead slots re-point at
    the first index, as in the JAX package (a duplicate insert is a
    no-op)."""
    if _on_kernel(meta, indices):
        return bloom_mod.insert(indices, nnz, meta)
    dev = indices.device
    n_words = meta.n_words
    live = torch.arange(indices.shape[0], device=dev) < nnz
    if meta.blocked == "hash":
        idx = torch.where(live, indices, indices[0])
        block, _ = blocked_block_and_mask(idx, meta)
        bits = indices.new_zeros(n_words * 32, dtype=torch.int64)
        for lane in _lanes(idx, meta.num_hash):
            bits = bits.scatter(0, block * 32 + lane, 1)
        return _pack_bits(bits, n_words)
    if not meta.blocked:
        idx = torch.where(live, indices, indices[0])
        pos = hash_positions(idx, hash_seeds(meta.num_hash, dev), meta.m_bits)
        bits = indices.new_zeros(meta.m_bits, dtype=torch.int64)
        # scatter takes the 1 as a kernel argument; `bits[pos] = 1` would
        # copy it from the host and wait for the device (and the out-of-place
        # form has a vmap batching rule, the in-place ones loop per client)
        bits = bits.scatter(0, pos.reshape(-1).long(), 1)
        return _pack_bits(bits, n_words)
    word = indices.to(torch.int64) % n_words
    parked = torch.full_like(word, n_words * 32)
    bits = indices.new_zeros(n_words * 32 + 1, dtype=torch.int64)
    for lane in _lanes(indices, meta.num_hash):
        bits = bits.scatter(0, torch.where(live, word * 32 + lane, parked), 1)
    return _pack_bits(bits, n_words)


def _mod_grid(meta: BloomMeta, device: torch.device) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(rows, universe index grid j [rows, W], lane masks [rows, W]) — the
    [ceil(d/W), W] layout the universe query broadcasts over."""
    n_words = meta.n_words
    rows = (meta.d + n_words - 1) // n_words
    j = torch.arange(rows * n_words, dtype=torch.int64, device=device).view(rows, n_words)
    return rows, j, lane_mask(j, meta.num_hash)


def insert_from_dense(dense: torch.Tensor, thresh: torch.Tensor, meta: BloomMeta) -> torch.Tensor:
    """Filter words (int32 bit patterns) of the threshold set
    {j : |dense_j| >= thresh}: an elementwise pass over the same [rows, W]
    grid that `query_universe` tests (`_mod_grid`), OR-reduced over rows by
    folding halves (torch has no OR reduction). No scatter. Mod layout
    only."""
    if meta.blocked != "mod":
        raise ValueError("insert_from_dense requires the 'mod' blocked layout")
    rows, _, mask = _mod_grid(meta, dense.device)
    n_words = meta.n_words
    a = torch.zeros(rows * n_words, dtype=dense.dtype, device=dense.device)
    a[: meta.d] = dense.reshape(-1).abs()
    acc = torch.where(a.view(rows, n_words) >= thresh, mask, 0)
    while acc.shape[0] > 1:
        half = (acc.shape[0] + 1) // 2
        top = acc[:half].clone()
        top[: acc.shape[0] - half] |= acc[half:]
        acc = top
    return u32.to_bits(acc[0])


def query_universe(words: torch.Tensor, meta: BloomMeta) -> torch.Tensor:
    """bool[d]: membership of every universe index.

    Mod layout: block(j) = j mod W, so laying the universe out as
    [ceil(d/W), W] makes each row test against the whole word array by
    broadcast — no gather. Hash layout: one gather of each index's word and
    an in-word mask test. Classic layout: the words are unpacked into a bit
    array once, and the universe is tested in chunks of `_QUERY_CHUNK`
    indices (all h bits set), so the [chunk, h] positions stay small at any
    d."""
    if meta.blocked == "hash":
        block, mask = blocked_block_and_mask(torch.arange(meta.d, device=words.device), meta)
        return (u32.from_bits(words)[block] & mask) == mask
    if not meta.blocked:
        dev = words.device
        seeds = hash_seeds(meta.num_hash, dev)
        bits = ((u32.from_bits(words)[:, None] >> torch.arange(32, device=dev)) & 1).reshape(-1).bool()
        chunk = min(_QUERY_CHUNK, max(1, meta.d))
        hits = []
        for lo in range(0, meta.d, chunk):
            idx = torch.arange(lo, min(lo + chunk, meta.d), dtype=torch.int64, device=dev)
            hits.append(bits[hash_positions(idx, seeds, meta.m_bits).long()].all(dim=-1))
        return torch.cat(hits)
    _, j, mask = _mod_grid(meta, words.device)
    w = u32.from_bits(words)
    hit = ((w[None, :] & mask) == mask) & (j < meta.d)
    return hit.reshape(-1)[: meta.d]


def selection_stream(seed: int, step: int) -> Tuple[int, int]:
    """The Philox (seed, offset) of the random policies' draws at `step`:
    keyed by (seed, step) only, the same on every worker, for the encoder
    and the decoder."""
    return _sparse.per_tensor_stream(seed, SELECT_STREAM, step, 0)


def _uniforms(n: int, device, *, step: int, seed: int, uniforms: Optional[torch.Tensor]) -> torch.Tensor:
    """f32[n] draws of `selection_stream(seed, step)`, or the given
    `uniforms` (CPU only: the parity tests feed the JAX package's)."""
    if uniforms is None:
        return philox_uniforms_plain(n, *selection_stream(seed, step), device=device)
    if torch.device(device).type != "cpu":
        raise ValueError("injected uniforms are a CPU parity hook; on CUDA the selection draws them")
    if uniforms.shape != (n,):
        raise ValueError(f"uniforms must have shape ({n},), got {tuple(uniforms.shape)}")
    return uniforms


def conflict_group(indices: torch.Tensor, meta: BloomMeta) -> torch.Tensor:
    """The conflict set of each index (int64): the filter word its bits
    (blocked layouts) or its first hash (classic) land in."""
    if meta.blocked:
        return blocked_block_and_mask(indices, meta)[0]
    seeds = hash_seeds(meta.num_hash, indices.device)[:1]
    return hash_positions(indices, seeds, meta.m_bits)[..., 0].to(torch.int64) // 32


def _lexsort(keys, n: int, device) -> torch.Tensor:
    """The permutation sorting by keys[-1], then keys[-2], ..., then the
    position (`jnp.lexsort`'s order): chained stable sorts, the last key
    last."""
    order = torch.arange(n, device=device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _conflict_sets_select(
    mask: torch.Tensor, meta: BloomMeta, *, step: int, seed: int, uniforms: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate P2 policy: the positive pool (the first p0-budget
    positives) grouped by `conflict_group`, a histogram of the set sizes
    (`index_add_`, dead rows in a sentinel set), each row's rank within its
    set in random order (from the run starts of the rows sorted by set, then
    draw), then the round-robin visit order (rank, set size, draw) cut at
    `budget` and put back in ascending index order."""
    pool = p0_budget(meta.k, meta.d, meta.fpr)
    n_groups = meta.n_words
    dev = mask.device
    pos, cnt = _prefix_positions(mask, pool)
    slot = torch.arange(pool, device=dev)
    live = slot < cnt
    g = torch.where(live, conflict_group(pos, meta), n_groups)
    sizes = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev).index_add_(0, g, torch.ones_like(g))
    big = 1 << 30
    size_of = torch.where(live, sizes[g], big)
    r = _uniforms(pool, dev, step=step, seed=seed, uniforms=uniforms)
    order = _lexsort((r, g), pool, dev)
    gs = g[order]
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), gs[1:] != gs[:-1]])
    rank_sorted = slot - torch.cummax(torch.where(run_start, slot, 0), 0).values
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    rank = torch.where(live, rank, big)
    pick = _lexsort((r, size_of, rank), pool, dev)[: meta.budget]
    chosen = pos[pick].to(torch.int64)
    count = torch.clamp(cnt, max=meta.budget)
    out_live = torch.arange(meta.budget, device=dev) < count
    chosen = torch.sort(torch.where(out_live, chosen, meta.d)).values
    return torch.where(out_live, chosen, 0).to(torch.int32), count.to(torch.int32)


def select(
    mask: torch.Tensor, meta: BloomMeta, *, step: int = 0, seed: int = 0, uniforms: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices i32[budget] ascending, dead slots 0; count i32[]): the
    policy's selection from the positive mask, deterministic given (mask,
    step, seed). `uniforms` (CPU only) replaces the random policies' draws:
    f32[d] priorities for `random`, f32[pool] for `conflict_sets_approx`."""
    dev = mask.device
    if meta.policy in ("leftmost", "p0"):
        pos, count = _prefix_positions(mask, meta.budget)
        live = torch.arange(meta.budget, device=dev) < count
        return torch.where(live, pos, 0), count
    if meta.policy == "conflict_sets_approx":
        return _conflict_sets_select(mask, meta, step=step, seed=seed, uniforms=uniforms)
    # random (P1): the budget positives of largest priority
    pri = _uniforms(meta.d, dev, step=step, seed=seed, uniforms=uniforms)
    pri = torch.where(mask, pri, -1.0)
    chosen = _sparse.top_order(pri, meta.budget)
    count = torch.clamp(mask.sum(), max=meta.budget)
    # fewer positives than the budget: the slots of priority -1 are dead and
    # go past the live ones; the live ones in ascending order
    chosen = torch.sort(torch.where(mask[chosen], chosen, meta.d), stable=True).values
    live = torch.arange(meta.budget, device=dev) < count
    return torch.where(live, chosen, 0).to(torch.int32), count.to(torch.int32)


def _fp_aware_payload(words: torch.Tensor, flat: torch.Tensor, meta: BloomMeta) -> BloomPayload:
    """Query the universe, take the first `budget` positives and re-read the
    true dense values there (one ascending gather; `bloom_mod.select_gather`
    on the card in the mod layout)."""
    if _on_kernel(meta, flat):
        values, nsel = bloom_mod.select_gather(words, flat, meta)
        return BloomPayload(values=values, words=words, nsel=nsel)
    mask = query_universe(words, meta)
    pos, nsel = _prefix_positions(mask, meta.budget)
    live = torch.arange(meta.budget, device=flat.device) < nsel
    values = torch.where(live, flat[pos.long()], torch.zeros((), dtype=flat.dtype, device=flat.device))
    return BloomPayload(values=values, words=words, nsel=nsel)


def encode(
    sp: SparseGrad,
    dense: torch.Tensor,
    meta: BloomMeta,
    *,
    step: int = 0,
    seed: int = 0,
    threshold_insert: bool = False,
    uniforms: Optional[torch.Tensor] = None,
) -> BloomPayload:
    """Insert + FP-aware value re-read from the dense tensor: for a prefix
    policy one ascending gather at the first `budget` positives, else at the
    policy's `select`ion (keyed by (seed, step); `uniforms` replaces its
    draws on the CPU).

    `threshold_insert` builds the filter from the dense tensor with the
    smallest live |value| as the threshold (`insert_from_dense`). A zero
    threshold would insert every index, so then the scatter `insert` runs
    instead; the branch is read on the host (`sparse.host_branch`)."""
    flat = dense.reshape(-1)
    if threshold_insert:
        live = torch.arange(sp.k, device=flat.device) < sp.nnz
        inf = torch.full((), float("inf"), dtype=torch.float32, device=flat.device)
        thresh = torch.where(live, sp.values.abs().to(torch.float32), inf).min()
        if _sparse.host_branch(thresh > 0):
            words = insert_from_dense(flat, thresh.to(flat.dtype), meta)
        else:
            words = insert(sp.indices, sp.nnz, meta)
    else:
        words = insert(sp.indices, sp.nnz, meta)
    if meta.policy in ("leftmost", "p0"):
        return _fp_aware_payload(words, flat, meta)
    selected, nsel = select(query_universe(words, meta), meta, step=step, seed=seed, uniforms=uniforms)
    live = torch.arange(meta.budget, device=flat.device) < nsel
    values = torch.where(live, flat[selected.long()], torch.zeros((), dtype=flat.dtype, device=flat.device))
    return BloomPayload(values=values, words=words, nsel=nsel)


def encode_dense_direct(
    dense: torch.Tensor, meta: BloomMeta, *, sample_size: int = 1 << 15, undershoot: float = 0.9
) -> BloomPayload:
    """Sparsifier-free encode: the k-th magnitude is estimated from a strided
    sample (`sparse.sampled_kth_magnitude`), the filter is built straight
    from the dense tensor (`insert_from_dense`), and the FP-aware tail is
    `encode`'s, bit for bit. Small tensors (d <= max(4k, 2 * sample_size))
    and a zero estimate (read on the host) take exact top-k + `insert`."""
    if meta.blocked != "mod":
        raise ValueError("encode_dense_direct requires the 'mod' blocked layout")
    if meta.policy not in ("leftmost", "p0"):
        raise ValueError(f"encode_dense_direct needs a prefix policy (leftmost/p0), got {meta.policy!r}")
    flat = dense.reshape(-1)
    d = flat.shape[0]
    if d > max(4 * meta.k, 2 * sample_size):
        t = _sparse.sampled_kth_magnitude(flat, meta.k, sample_size=sample_size, undershoot=undershoot)
        if _sparse.host_branch(t > 0):
            return _fp_aware_payload(insert_from_dense(flat, t, meta), flat, meta)
    sp = _sparse.topk(flat, 1.0, k=meta.k)
    return _fp_aware_payload(insert(sp.indices, sp.nnz, meta), flat, meta)


def decode(
    payload: BloomPayload,
    meta: BloomMeta,
    shape: Tuple[int, ...],
    *,
    step: int = 0,
    seed: int = 0,
    uniforms: Optional[torch.Tensor] = None,
) -> SparseGrad:
    """The list-form decode: query the universe, re-run the policy and pair
    the selection (ascending) with the transmitted values."""
    selected, nsel = select(query_universe(payload.words, meta), meta, step=step, seed=seed, uniforms=uniforms)
    return SparseGrad(values=payload.values, indices=selected, nnz=torch.minimum(nsel, payload.nsel), shape=shape)


def decode_dense(
    payload: BloomPayload,
    meta: BloomMeta,
    shape: Tuple[int, ...],
    *,
    step: int = 0,
    seed: int = 0,
    values: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rank-inversion decode straight to the dense tensor: value slot s goes
    to universe position `_prefix_positions(mask)[s]` for s < nsel
    (`bloom_mod.place` on the card in the mod layout).
    `values` overrides the payload's values ('both' mode passes the value
    codec's output, already in rank order). The random policies decode the
    list form (`decode`) with `values` substituted slot for slot."""
    if meta.policy not in ("leftmost", "p0"):
        sp = decode(payload, meta, shape, step=step, seed=seed, uniforms=uniforms)
        if values is not None:
            sp = dataclasses.replace(sp, values=values)
        return sp.to_dense()
    vals = payload.values if values is None else values
    if _on_kernel(meta, vals):
        return bloom_mod.place(payload.words, vals, payload.nsel, meta).reshape(shape)
    n_v = vals.shape[0]
    vals = _sparse.fit_length(vals, meta.budget)
    mask = query_universe(payload.words, meta)
    pos, derived = _prefix_positions(mask, meta.budget)
    nsel = torch.minimum(torch.clamp(payload.nsel, max=meta.budget), derived)
    nsel = torch.clamp(nsel, max=n_v)
    return _sparse.scatter_ascending(vals, pos, nsel, meta.d).reshape(shape)


def wire_bits(payload: BloomPayload, meta: BloomMeta) -> torch.Tensor:
    """Filter bits + selected values + count word."""
    return (64.0 + meta.m_bits) + payload.nsel.to(torch.float32) * 32


def measured_fpr(sp: SparseGrad, words: torch.Tensor, meta: BloomMeta) -> torch.Tensor:
    """0-d float32 observed false-positive rate of a filter over the
    sparsifier's selection `sp`: positives outside every slot's index (dead
    slots mark index 0, as in the JAX package) over max(1, d - nnz)."""
    mask = query_universe(words, meta)
    truth = torch.zeros(meta.d, dtype=torch.bool, device=words.device).index_fill_(0, sp.indices.long(), True)
    fp = (mask & ~truth).sum()
    return fp.to(torch.float32) / torch.clamp(meta.d - sp.nnz, min=1).to(torch.float32)


def fp_stats(payload: BloomPayload, meta: BloomMeta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(filter positives beyond the live selected count, the not-selected
    universe) as 0-d float32: the filter has no false negatives, so the
    first is the false-positive count."""
    positives = query_universe(payload.words, meta).sum().to(torch.float32)
    nsel = payload.nsel.to(torch.float32)
    return torch.clamp(positives - nsel, min=0.0), torch.clamp(float(meta.d) - nsel, min=0.0)
