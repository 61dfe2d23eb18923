"""Federated averaging with bidirectionally compressed exchange, ported
from `deepreduce_tpu/fedavg.py` (paper §6.2, Algorithm 2, Tables 2, 5, 6).

A server and N clients; each round the server samples C clients,
broadcasts the model delta compressed (S2C), the sampled clients run E
local SGD steps and return their updates compressed (C2S), and the server
averages. Both directions run through the same `TensorCodec` stack as the
data-parallel exchange, each a `fedsim.TreeCodec`; each direction's tree is
one grouped QSGD launch (`ops.qsgd_encode_rows`), so a DRQSGD round
launches it 1 + C times. The topology is a simulation in one process:
payloads are encoded and decoded in place, and the wire is accounted in
`WireStats` as the paper's Table-2 relative volume (bits sent over dense
bits, both directions: S2C once, C2S once per sampled client).

Error feedback: the S2C broadcast compresses `params - w_ref` against the
receivers' reconstructed model `w_ref`, a closed loop with no explicit
residual; each client keeps a C2S residual in a `[num_clients, ...]` bank,
updated in place: a sampled client's rows are read (`index_select`) and
written back (`index_copy_`) at its id as it runs, so the round holds one
client's residual beside the bank (ids are drawn without replacement, so
nothing collides).

Local training is SGD with momentum restarted every round (the JAX
package's `optax.sgd(lr, momentum)` with `client_opt.init` inside
`_local_train`) on copies of `w_ref`, through the caller's
`loss_fn(params, batch)` (e.g. `model.functional(params, inputs)`); no
client mutates `w_ref`. A model with BatchNorm runs it in batch mode and
its running statistics are never read or sent (the FedBN pattern of
`benchmarks/mobilenet_table5.py`); its scale and bias travel as parameters.

The server step is taken as XLA:CPU compiles the JAX package's jitted
round: `w + server_lr * (sum / C)` becomes one fused multiply-add of the sum
and the folded constant fl(server_lr * fl(1/C)), and under a participation
mask `fma(sum / live_count, server_lr, w)` with a true divide
(`numerics.fma_f32`, the same bits on the CPU and the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves

from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec
from deepreduce_tpu_torch.fedsim.round import (
    FedConfig,
    cohort_updates,
    index_batch,
    make_client_step,
    tree_add,
    tree_sub,
)
from deepreduce_tpu_torch.metrics import WireStats, combine
from deepreduce_tpu_torch.numerics import fma_f32, reciprocal_f32

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FedAvgState:
    params: Tree  # the server's true model
    w_ref: Tree  # the model every client can reconstruct from the broadcasts
    c2s_residuals: Optional[Tree]  # [num_clients, ...] per-client error feedback
    round: int


class FedAvg:
    """Compressed-FedAvg harness.

    `loss_fn(params, batch) -> scalar loss`, `params` a dict of tensors
    under flax names; each sampled client runs `local_steps` SGD steps
    (`client_lr`, `client_momentum`) on its batches."""

    def __init__(
        self,
        loss_fn: Callable[[Tree, Any], torch.Tensor],
        cfg_c2s: DeepReduceConfig,
        fed: FedConfig,
        client_lr: float,
        client_momentum: float = 0.0,
        *,
        cfg_s2c: Optional[DeepReduceConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg_c2s = cfg_c2s
        self.cfg_s2c = cfg_s2c if cfg_s2c is not None else cfg_c2s
        self.fed = fed
        self.client_lr = client_lr
        self.client_momentum = client_momentum
        # per-direction path-keyed codec banks (see fedsim.codec_tree)
        self.tree_codecs: Dict[str, TreeCodec] = {
            "s2c": TreeCodec("s2c", self.cfg_s2c, device=self.device),
            "c2s": TreeCodec("c2s", self.cfg_c2s, device=self.device),
        }

    def init(self, params: Tree) -> FedAvgState:
        """State from the initial parameters (copied; they lie on `device`)."""
        for n, p in params.items():
            check_on(p, self.device, f"parameter {n!r}")
        use_res = self.cfg_c2s.memory == "residual"
        n_clients = self.fed.num_clients
        return FedAvgState(
            params={n: p.detach().clone() for n, p in params.items()},
            w_ref={n: p.detach().clone() for n, p in params.items()},
            c2s_residuals={n: p.new_zeros((n_clients,) + tuple(p.shape)) for n, p in params.items()}
            if use_res else None,
            round=0,
        )

    def sample_clients(self, state: FedAvgState, generator: torch.Generator) -> torch.Tensor:
        """C client ids drawn without replacement (Algorithm 2's random subset
        per round) from an explicit CPU generator: int64[C] on the CPU."""
        return torch.randperm(self.fed.num_clients, generator=generator)[: self.fed.clients_per_round]

    def _local_train(self, w_ref: Tree, batches: Any) -> Tree:
        """E steps of SGD with momentum from a copy of `w_ref`, the momentum
        restarted: `t = g + momentum * t`, `p = p - lr * t` (optax.sgd)."""
        names = list(w_ref)
        params = {n: w_ref[n].detach().clone().requires_grad_(True) for n in names}
        trace = None
        for s in range(self.fed.local_steps):
            loss = self.loss_fn(params, index_batch(batches, s))
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            with torch.no_grad():
                if trace is None or not self.client_momentum:
                    trace = list(grads)
                else:
                    trace = [g + self.client_momentum * t for g, t in zip(grads, trace)]
                for n, t in zip(names, trace):
                    params[n].sub_(self.client_lr * t)
        return {n: p.detach() for n, p in params.items()}

    def _ids_on_device(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.shape != (self.fed.clients_per_round,):
            raise ValueError(f"ids must have shape ({self.fed.clients_per_round},), got {tuple(ids.shape)}")
        ids = ids.long()
        if self.device.type == "cuda" and ids.device.type == "cpu":
            # pinned and asynchronous: a pageable host copy would wait for the card
            return ids.pin_memory().to(self.device, non_blocking=True)
        return ids.to(self.device)

    def run_round(
        self,
        state: FedAvgState,
        ids: torch.Tensor,
        client_batches: Any,
        *,
        participation: Optional[torch.Tensor] = None,
        uniforms: Optional[Dict[str, Any]] = None,
    ) -> Tuple[FedAvgState, Dict[str, Any]]:
        """One round. `ids` from `sample_clients`; `client_batches` tensors
        are [clients_per_round, local_steps, ...] for exactly those ids, on
        the device.

        `participation` (bool or float32 [C] over the sampled clients, on
        the device, or None) models a sampled client failing to return its
        C2S update: its decoded update and wire bits are zeroed, the server
        mean divides by the live count, and its C2S residual is left as it
        was. The S2C broadcast stays global.

        `uniforms` (CPU only) injects the QSGD draws: `{"s2c": {path: f32},
        "c2s": [{path: f32} for each cohort position]}`.

        Returns the new state and `{"wire", "rel_volume", "wire_s2c",
        "wire_c2s"}`: the combined wire stats, their relative volume and
        each direction's stats (0-d float32 tensors on the device)."""
        C = self.fed.clients_per_round
        lead = (C, self.fed.local_steps)
        for leaf in tree_leaves(client_batches):
            if tuple(leaf.shape[:2]) != lead:
                raise ValueError(f"client batch leaves must start with {lead}, got {tuple(leaf.shape)}")
        ids_dev = self._ids_on_device(ids)
        uniforms = uniforms or {}

        # S2C: the model delta against the receivers' state w_ref, so that
        # undelivered mass reappears in the next round's delta
        delta = tree_sub(state.params, state.w_ref)
        with record_function("fedavg/s2c"):
            dec_delta, _, wire_s2c = self.tree_codecs["s2c"].compress_tree(
                delta, None, step=state.round, worker=0, uniforms=uniforms.get("s2c")
            )
        w_ref = tree_add(state.w_ref, dec_delta)

        # local training + C2S on each sampled client, its residual read and
        # written in place at its row of the bank
        client_step = make_client_step(
            self.tree_codecs["c2s"], self._local_train, w_ref, state.round, uniforms=uniforms.get("c2s")
        )
        with record_function("fedavg/clients"):
            upd_sum, _, wire4, live = cohort_updates(
                client_step, client_batches, state.c2s_residuals, range(C), rows=ids_dev,
                update_template=state.params, participation=participation,
            )
        wire_c2s = WireStats(*wire4)

        # the server step w + server_lr * mean, as XLA:CPU compiles it: one
        # fused multiply-add, the constants server_lr * fl(1/C) folded first
        lr = self.fed.server_lr
        if participation is not None:
            live_count = torch.clamp(live.sum(), min=1.0)
            new_params = {n: fma_f32(upd_sum[n] / live_count, lr, w) for n, w in state.params.items()}
        else:
            scale = float(np.float32(lr) * np.float32(reciprocal_f32(C)))
            new_params = {n: fma_f32(upd_sum[n], scale, w) for n, w in state.params.items()}
        wire = combine({"s2c": wire_s2c, "c2s": wire_c2s})
        new_state = FedAvgState(params=new_params, w_ref=w_ref, c2s_residuals=state.c2s_residuals, round=state.round + 1)
        return new_state, {"wire": wire, "rel_volume": wire.rel_volume(), "wire_s2c": wire_s2c, "wire_c2s": wire_c2s}

