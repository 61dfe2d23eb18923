"""Data-parallel training step, ported from `deepreduce_tpu/train.py`.

One process per worker (rank of the process group; one worker without a
group), or one thread per worker of a `collectives.InProcessGroup`. The
step is forward/backward -> `compensate` -> exchange (under the step's
participation mask with `cfg.resilience`) -> `update` -> optimizer, with
`torch.optim.SGD(lr, momentum)`, whose update matches
`optax.sgd(lr, momentum)`. With `cfg.stream_exchange` the
bucketed exchange runs from the backward pass instead
(`comm_stream.StreamingExchange`). Parameters and optimizer state are
updated in place. A model with BatchNorm (ResNet-20) moves its running
statistics in the forward; the step then averages them over the workers
with one `all_reduce` (the JAX package's `pmean(new_stats)`). Every mean
over the workers multiplies by the float32 reciprocal of W, as XLA
compiles the JAX package's `pmean`.

With `cfg.hier` the exchange is the two-tier `HierarchicalExchanger` over
this worker's (ici, dcn) pair: `group` is the pair itself (an
`InProcessGrid` member), or one group that `cfg.ici_size` splits
(`collectives.split_group`, the JAX Trainer's `make_hybrid_mesh`). The loss,
the BatchNorm statistics and the wire bits are then reduced over every
worker of both tiers: summed over the slice, then across slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.collectives import collectives_for, split_group
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.exchange import build_exchanger, wrap_streaming
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.resilience.faults import participation_mask


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Dict[str, nn.Parameter]  # by flax name; the model's own tensors
    batch_stats: Dict[str, torch.Tensor]  # BatchNorm running stats by flax name, the model's buffers ({} if none)
    optimizer: torch.optim.Optimizer
    residuals: Optional[Dict[str, torch.Tensor]]  # worker-local error feedback
    step: int


def classification_loss(model: nn.Module) -> Callable:
    """batch = (inputs, int labels) -> mean softmax cross-entropy over every
    position (the JAX package's `classification_loss`). The model runs in
    training mode, so a BatchNorm layer normalizes with the batch's
    statistics and moves its running statistics in place, as flax's
    `apply(..., mutable=['batch_stats'])` returns them."""

    def loss_fn(batch) -> torch.Tensor:
        inputs, labels = batch
        logits = model(inputs)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())

    return loss_fn


def next_token_loss(model: nn.Module) -> Callable:
    """batch = (int tokens [batch, seq + 1],) -> the mean softmax
    cross-entropy of the model's logits on `tokens[:, :-1]` against
    `tokens[:, 1:]`: the `lm` loss BERT trains under in
    `benchmarks/train.py` (`make_loss`)."""

    def loss_fn(batch) -> torch.Tensor:
        (tokens,) = batch
        logits = model(tokens[:, :-1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())

    return loss_fn


class Trainer:
    """Synchronous data-parallel trainer over a process group."""

    def __init__(
        self,
        model: nn.Module,
        cfg: DeepReduceConfig,
        *,
        lr: float,
        momentum: float = 0.0,
        device: DeviceLike = "cuda",
        group: Optional[dist.ProcessGroup] = None,
        loss_fn: Optional[Callable] = None,
    ):
        if cfg.fed:
            raise ConfigError(
                "fed-vs-trainer",
                "fed=True configures the federated simulation (deepreduce_tpu_torch.fedsim); the Trainer runs the "
                "data-parallel gradient exchange and would silently ignore every fed_* knob — build a FedSim (or "
                "drop fed=True)",
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.cfg = cfg
        self.lr = lr
        self.momentum = momentum
        self.group = group
        if cfg.hier:
            self.group = split_group(group, cfg.ici_size)
            self.colls = self.group
        else:
            self.colls = (collectives_for(group),)
        self.num_workers = math.prod(c.world_size for c in self.colls)
        self.loss_fn = loss_fn or classification_loss(self.model)
        self.exchanger: Optional[GradientExchanger] = None
        self.streaming: Optional[StreamingExchange] = None

    def init_state(self) -> TrainState:
        params = self.model.flax_params()
        self.exchanger = build_exchanger(params, self.cfg, device=self.device, group=self.group)
        self.streaming = wrap_streaming(self.exchanger)
        residuals = self.exchanger.init_state({n: p.detach() for n, p in params.items()})
        opt = torch.optim.SGD(list(params.values()), lr=self.lr, momentum=self.momentum)
        return TrainState(
            params=params, batch_stats=self.model.flax_batch_stats(), optimizer=opt, residuals=residuals, step=0
        )

    def _sum_over_workers(self, x: torch.Tensor) -> torch.Tensor:
        for coll in self.colls:  # the slice first, then across slices
            x = coll.all_reduce_sum(x)
        return x

    def _mean_over_workers(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        return mean_of_sum(self._sum_over_workers(x), self.num_workers)

    def _average_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Replace each running statistic by its mean over the workers, in
        place, with one `all_reduce` of one flat buffer."""
        if self.group is None or not stats:
            return
        flat = self._mean_over_workers(torch.cat([s.reshape(-1) for s in stats.values()]))
        lo = 0
        for s in stats.values():
            s.copy_(flat[lo : lo + s.numel()].view(s.shape))
            lo += s.numel()

    def step(
        self,
        state: TrainState,
        batch,
        *,
        uniforms: Optional[Dict[str, torch.Tensor]] = None,
        collect: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[TrainState, torch.Tensor, WireStats]:
        """One synchronous step on this worker's batch shard. Returns the new
        state, the loss (mean over workers) and the wire stats (index and
        value bits averaged over workers, saturation counts summed).
        `uniforms` is the CPU parity tests' hook for the stochastic draws and
        `collect` receives the exchange's observables (see
        `GradientExchanger.exchange`) and, with `cfg.resilience`, the live
        worker count (`live_workers`) and whether any worker sat the step out
        (`dropped`), as device tensors.

        With `cfg.resilience` the step's participation mask comes from
        `faults.participation_mask` at (seed, step) and goes into the
        exchange; without it the step runs exactly the resilience-free
        ops."""
        params = state.params
        if self.streaming is not None:
            loss, _, agg, residuals, wire = self.streaming.value_and_grad_exchange(
                self.loss_fn, params, batch, state.residuals, step=state.step, uniforms=uniforms, collect=collect
            )
        else:
            for p in params.values():
                p.grad = None
            loss = self.loss_fn(batch)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            mask = None
            if self.cfg.resilience:
                # from host data every worker shares (the seed, the step): the
                # same mask on every worker, built on the device without a copy
                mask = participation_mask(self.num_workers, state.step, self.cfg.seed,
                                          drop_rate=self.cfg.drop_rate, fault_plan=self.cfg.fault_plan,
                                          device=self.device)
                if collect is not None:
                    W = self.num_workers
                    live = torch.full((), float(W), device=self.device) if mask is None else mask.sum(dtype=torch.float32)
                    collect["live_workers"] = live
                    collect["dropped"] = (live < W).to(torch.float32)
            agg, residuals, wire = self.exchanger.exchange(
                grads, state.residuals, step=state.step, uniforms=uniforms, collect=collect, mask=mask
            )
        for n, p in params.items():
            p.grad = agg[n]
        state.optimizer.step()
        self._average_stats(state.batch_stats)
        loss = self._mean_over_workers(loss.detach())
        if self.group is not None:
            # index and value bits averaged (the JAX package's pmean), the
            # saturation count summed (its psum)
            bits = self._sum_over_workers(torch.stack([wire.index_bits, wire.value_bits, wire.saturated]))
            mean = mean_of_sum(bits[:2], self.num_workers)
            # ici_bits is the same static count on every worker: no collective
            wire = WireStats(mean[0], mean[1], wire.dense_bits, bits[2], wire.ici_bits)
        return dataclasses.replace(state, residuals=residuals, step=state.step + 1), loss, wire
