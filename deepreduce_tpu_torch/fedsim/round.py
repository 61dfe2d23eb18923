"""Federated round bodies: one client's uplink, and a cohort's worth of
them, ported from the synchronous half of `deepreduce_tpu/fedsim/round.py`.

`fedavg.FedAvg.run_round` runs the cohort as the JAX package's reference
`impl="scan"` does: one client after another (here a Python loop), each
through `client_step` — local training, then the update's compression
through the real `TensorCodec` stack with per-client error feedback.

Degradation semantics (as in the JAX package): a *non-participating*
client (churn) never trained: its update, wire bits and residual write are
all suppressed, and its pending error-feedback mass waits for the next time
it is sampled. Its decoded update is removed from the sum with a select
(`torch.where`), never a multiply: a masked update may be NaN, and
NaN * 0 is NaN. No mask reads a value on the host.

Not ported yet (each raises `NotImplementedError`): the batched cohort
(`impl="vmap"`, `chunk`), the wire-image stage (`layout`, chaos, a real
`checksum` gate) and the asynchronous, latency and multi-tenant rounds
(`deepreduce_tpu/fedsim/round.py:333-589`): ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map

from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec

Tree = Dict[str, torch.Tensor]
WIRE_FIELDS = ("index_bits", "value_bits", "dense_bits", "saturated")
_LATER = "is not ported yet (ROADMAP Queue 1 item 9: FedSim and the resilience uplink)"


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Round geometry (paper §6.2: 56 clients sampled from 57 VMs;
    Table 5: 10 clients, 800 rounds)."""

    num_clients: int
    clients_per_round: int
    local_steps: int = 1
    server_lr: float = 1.0

    def __post_init__(self):
        if self.num_clients <= 0:
            raise ValueError(f"num_clients must be positive, got {self.num_clients}")
        if self.clients_per_round <= 0:
            raise ValueError(
                f"clients_per_round must be positive, got {self.clients_per_round}"
            )
        if self.clients_per_round > self.num_clients:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} exceeds the "
                f"population num_clients={self.num_clients} — sampling is "
                "without replacement (Algorithm 2), so a round cannot draw "
                "more clients than exist"
            )
        if self.local_steps <= 0:
            raise ValueError(f"local_steps must be positive, got {self.local_steps}")
        if self.server_lr <= 0:
            raise ValueError(f"server_lr must be positive, got {self.server_lr}")


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {n: x - b[n] for n, x in a.items()}


def tree_add(a: Tree, b: Tree) -> Tree:
    return {n: x + b[n] for n, x in a.items()}


def index_batch(batch: Any, i: int) -> Any:
    """Row `i` of every tensor of a batch (a tensor, or a tuple, list or dict
    of them), as JAX's scan slices its `xs`."""
    return tree_map(lambda x: x[i], batch)


def make_client_step(
    tree_codec: TreeCodec,
    local_train: Callable[[Tree, Any], Tree],
    w_ref: Tree,
    step: int,
    *,
    uniforms: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
) -> Callable:
    """Build the per-client body. `pos` is the client's cohort position: the
    `worker` of its leaves' streams (`step` is the round). `uniforms[pos]`
    (path -> f32, CPU only) injects the QSGD draws.

    Returns `(dec_update_tree, new_residual_tree_or_None, wire4)` where
    `wire4` is `(index, value, dense, saturated)` bits as 0-d float32
    tensors."""

    def client_step(batch_c: Any, res_c: Optional[Tree], pos: int):
        update = tree_sub(local_train(w_ref, batch_c), w_ref)
        u = None if uniforms is None else uniforms[pos]
        dec, new_res, wire = tree_codec.compress_tree(update, res_c, step=step, worker=pos, uniforms=u)
        return dec, new_res, tuple(getattr(wire, f).to(torch.float32).reshape(()) for f in WIRE_FIELDS)

    return client_step


def _mask_tree(tree: Tree, gate: torch.Tensor) -> Tree:
    """Zero a client's contribution via SELECT (gate is a 0-d float32)."""
    return {n: torch.where(gate > 0, u, torch.zeros_like(u)) for n, u in tree.items()}


def cohort_updates(
    client_step: Callable,
    client_batches: Any,
    res_stack: Optional[Tree],
    positions: Sequence[int],
    *,
    update_template: Tree,
    rows: Optional[torch.Tensor] = None,
    participation: Optional[torch.Tensor] = None,
    checksum: bool = False,
    impl: str = "scan",
    chunk: int = 0,
) -> Tuple[Tree, Optional[Tree], Tuple[torch.Tensor, ...], torch.Tensor]:
    """Run `client_step` over a cohort and aggregate. `update_template` is
    any tree with the model's names, shapes and dtypes (e.g. `w_ref`); it
    seeds the sum.

    `client_batches` tensors are [C, local_steps, ...]; `positions` are the
    C cohort positions (ints). `res_stack` (or None) holds the residuals:
    client c's are its row `rows[c]` (int64[C] on the device; default c, a
    [C, ...] stack), read and written in place one client at a time, so
    `res_stack` may be the whole population's bank and the rows distinct.
    `participation` is an optional float32 / bool [C] churn mask on the
    device. Clients run in cohort order, and their decoded updates are summed
    from zeros in that order, as the JAX package's scan does.

    Returns (upd_sum_tree, res_stack_or_None, wire4_sums, live_f32[C]) where
    `live` is the contribution gate: the participation, or all ones."""
    if impl not in ("scan", "vmap"):
        raise ValueError(f"impl must be 'scan' or 'vmap', got {impl!r}")
    if impl == "vmap" or chunk:
        raise NotImplementedError(f"the batched cohort (impl='vmap', chunk) {_LATER}")
    if checksum:
        raise NotImplementedError(f"the checksum-gated uplink {_LATER}")
    some = next(iter(update_template.values()))
    C = len(positions)
    live = torch.ones(C, dtype=torch.float32, device=some.device) if participation is None else (
        participation.to(torch.float32))
    if res_stack is not None and rows is None:
        rows = torch.arange(C, device=some.device)

    upd_sum = {n: torch.zeros_like(t) for n, t in update_template.items()}
    wire_acc = tuple(torch.zeros((), dtype=torch.float32, device=some.device) for _ in WIRE_FIELDS)
    for c, pos in enumerate(positions):
        row = None if res_stack is None else rows[c : c + 1]
        res_c = None if row is None else {n: r.index_select(0, row)[0] for n, r in res_stack.items()}
        dec_upd, new_res_c, wire4 = client_step(index_batch(client_batches, c), res_c, pos)
        if participation is not None:
            m = live[c]
            dec_upd = _mask_tree(dec_upd, m)
            if row is not None:
                # a churned client never compressed: it keeps its old residual
                new_res_c = {n: torch.where(m > 0, new, res_c[n]) for n, new in new_res_c.items()}
            # a churned client transmitted nothing
            wire4 = tuple(w * m for w in wire4)
        upd_sum = tree_add(upd_sum, dec_upd)
        wire_acc = tuple(a + w for a, w in zip(wire_acc, wire4))
        if row is not None:
            for n, r in res_stack.items():
                r.index_copy_(0, row, new_res_c[n][None])
    return upd_sum, res_stack, wire_acc, live
