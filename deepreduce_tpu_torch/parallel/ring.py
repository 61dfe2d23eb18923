"""Ring attention, ported from `deepreduce_tpu/parallel/ring.py`:
attention over a sequence sharded on a group.

Q/K/V live sequence-sharded: each worker holds one contiguous chunk
``[batch, seq/n, heads, head_dim]``. Attention runs in ``n`` rounds: every
round each worker computes blockwise attention of its resident Q chunk
against the K/V block in hand (a flash-style streaming softmax, so nothing
seq x seq across the whole sequence materializes), then passes the K/V
block one hop around the ring (`functional.ring_hop`: to rank + 1, from
rank - 1; its backward is the hop the other way). A worker holds one remote
block at a time.

Numerics are the JAX package's: scores and the softmax accumulators are
float32 whatever the input dtype (the products of the inputs cast to
float32, JAX's `preferred_element_type=float32`, which is exact for bf16
inputs), written as `einsum`s, so the streaming softmax is JAX's. Causal
mode uses global positions (`q_off = rank * cq`, `k_off = src * ck` with
`src = (rank - i) mod n`, the block resident in round i), so the mask is
exact across the ring. Fully masked (future) blocks still run; the running
max starts at the finite floor `_NEG_INF`, so their contribution is
exactly zeroed once an unmasked block lands, and the diagonal block lands
first (round 0), so every row is anchored from the start: the order of the
rounds is part of the contract.

`_block_attend` is an XLA fusion in the JAX package, not a Pallas kernel;
plain PyTorch is its port.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepreduce_tpu_torch.collectives import collectives_for
from deepreduce_tpu_torch.parallel.functional import ring_hop

_NEG_INF = -1e30  # finite floor: keeps exp() well-defined for masked rows


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _causal(s: torch.Tensor, q_off: int, k_off: int) -> torch.Tensor:
    cq, ck = s.shape[-2], s.shape[-1]
    qpos = q_off + torch.arange(cq, device=s.device)
    kpos = k_off + torch.arange(ck, device=s.device)
    return torch.where(qpos[:, None] >= kpos[None, :], s, _NEG_INF)


def _block_attend(q, k, v, o, m, l, *, scale, causal, q_off, k_off):
    """One flash-attention block update.

    q [b,cq,h,d], k/v [b,ck,h,d]; accumulators o [b,cq,h,d] f32,
    m,l [b,h,cq] f32. Returns updated (o, m, l).
    """
    s = _scores(q, k, scale)
    if causal:
        s = _causal(s, q_off, k_off)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coll=None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention over a sequence sharded on the group `coll` (a
    `Collectives` or a `torch.distributed` group; every worker calls it with
    its chunk ``[batch, chunk, heads, head_dim]``). With ``coll=None`` it is
    plain local flash attention in one block, the JAX package's
    ``axis_name=None`` form."""
    b, cq, h, d = q.shape
    scale = (1.0 / d**0.5) if scale is None else scale
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, cq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)

    if coll is None:
        o, m, l = _block_attend(q, k, v, o, m, l, scale=scale, causal=causal, q_off=0, k_off=0)
        return (o / l[..., None].transpose(1, 2)).to(q.dtype)

    coll = collectives_for(coll)
    n, me = coll.world_size, coll.rank
    ck = k.shape[1]
    for i in range(n):  # n rounds, a hop after each
        src = (me - i) % n  # which global block is resident this round
        o, m, l = _block_attend(q, k, v, o, m, l, scale=scale, causal=causal, q_off=me * cq, k_off=src * ck)
        k, v = ring_hop(k, coll), ring_hop(v, coll)
    return (o / l[..., None].transpose(1, 2)).to(q.dtype)


def ring_self_attention_reference(q, k, v, *, causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded O(s^2) oracle: plain softmax attention, float32 scores."""
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    s = _scores(q, k, scale)
    if causal:
        s = _causal(s, 0, 0)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
