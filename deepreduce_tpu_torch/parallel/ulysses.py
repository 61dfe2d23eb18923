"""Ulysses-style all-to-all sequence parallelism, ported from
`deepreduce_tpu/parallel/ulysses.py`.

The dual of ring attention: one all_to_all re-shards the activations from
sequence-sharded ``[b, s/n, h, d]`` to head-sharded ``[b, s, h/n, d]``,
dense attention runs locally over the whole sequence for the local head
group, and a second all_to_all inverts the layout. Two collectives an
attention call against ring's n hops; the heads must divide by the group
size.

JAX's tiled `all_to_all(split_axis=2, concat_axis=1)` sends head chunk j to
worker j and concatenates what arrives along the sequence in source-rank
order. The port's `Collectives.all_to_all` exchanges rows `x[W, ...]`, so
the heads are reshaped to `[W, h/W]` in that order and the rows moved to
the front (`functional.all_to_all`, differentiable: its backward is the
same exchange).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepreduce_tpu_torch.collectives import collectives_for
from deepreduce_tpu_torch.parallel import functional
from deepreduce_tpu_torch.parallel.ring import ring_self_attention_reference


def _seq_to_heads(x: torch.Tensor, coll) -> torch.Tensor:
    """[b, c, h, d] (this worker's chunk) -> [b, W*c, h/W, d] (head group
    `rank` over the whole sequence)."""
    b, c, h, d = x.shape
    W = coll.world_size
    rows = x.reshape(b, c, W, h // W, d).permute(2, 0, 1, 3, 4).contiguous()  # [W, b, c, h/W, d]
    got = functional.all_to_all(rows, coll)  # row w: worker w's chunk of this head group
    return got.permute(1, 0, 2, 3, 4).reshape(b, W * c, h // W, d)


def _heads_to_seq(x: torch.Tensor, coll) -> torch.Tensor:
    """[b, W*c, h/W, d] -> [b, c, h, d], the inverse of `_seq_to_heads`."""
    b, s, hl, d = x.shape
    W = coll.world_size
    rows = x.reshape(b, W, s // W, hl, d).permute(1, 0, 2, 3, 4).contiguous()  # [W, b, c, h/W, d]
    got = functional.all_to_all(rows, coll)  # row j: head group j of this worker's chunk
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // W, W * hl, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coll=None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over a sequence sharded on the group `coll` (every worker
    calls it with its chunk ``[batch, chunk, heads, head_dim]``); the heads
    must divide by the group size. ``coll=None``: local dense attention."""
    if coll is None:
        return ring_self_attention_reference(q, k, v, causal=causal, scale=scale)
    coll = collectives_for(coll)
    if q.shape[2] % coll.world_size:
        raise ValueError(f"ulysses attention needs heads ({q.shape[2]}) divisible by the group size "
                         f"({coll.world_size})")
    qh, kh, vh = (_seq_to_heads(t, coll) for t in (q, k, v))
    out = ring_self_attention_reference(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(out, coll)
