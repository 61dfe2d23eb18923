"""The ring decode of the fused exchange, ported from
`deepreduce_tpu/comm_ring.py` (`decode_strategy='ring'`).

No all_gather: the fused uint8 buffer goes W - 1 hops around the workers
(`Collectives.ring_shift`: send to rank + 1, receive from rank - 1),
double-buffered. Each round starts the next hop before it decodes the
chunk in hand, so the transfer overlaps the decode (over NCCL the hop is
an `isend`/`irecv` pair on NCCL's stream). Round 0 decodes the worker's
own buffer, which is the decode the residual needs.

Each worker sums the chunks in its ring order: own, me - 1, me - 2, ...
(mod W); round r's chunk came from worker (me - r) mod W, whose mask
weight scales its decode. So the aggregate equals the loop decode's up to
float32 associativity, and bitwise where the sums are exact.

Wire bytes: each worker forwards the B-byte buffer W - 1 times
(`metrics.ring_wire_bytes`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from deepreduce_tpu_torch.collectives import Collectives

Decoded = Tuple[torch.Tensor, ...]


def ring_decode_exchange(
    buf: torch.Tensor,
    decode_row: Callable[[torch.Tensor], Decoded],
    coll: Collectives,
    *,
    need_own: bool,
    row_weights: Optional[torch.Tensor] = None,
) -> Tuple[Decoded, Optional[Decoded]]:
    """(the sum of every worker's decode, this worker's own decode or None)
    of the uint8[B] buffers, ring-exchanged over `coll`. `decode_row` maps
    one worker's buffer to a tuple of f32 tensors; `row_weights` (f32[W],
    the participation mask) scales each chunk's decode by its origin's
    weight before it is added."""
    W, me = coll.world_size, coll.rank

    def weighted(decs: Decoded, r: int) -> Decoded:
        if row_weights is None:
            return decs
        wgt = row_weights[(me - r) % W]  # round r's chunk came from me - r
        return tuple(d * wgt for d in decs)

    nxt = coll.ring_shift(buf) if W > 1 else None  # hop 1 leaves while the own buffer decodes
    own = weighted(decode_row(buf), 0)
    acc = own
    if W > 1:
        for r in range(1, W):
            cur = nxt.wait()
            if r + 1 < W:
                nxt = coll.ring_shift(cur)  # the next hop, before this chunk's decode
            acc = tuple(a + d for a, d in zip(acc, weighted(decode_row(cur), r)))
    return acc, own if need_own else None
