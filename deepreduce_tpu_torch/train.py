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

With `cfg.telemetry` the step also adds to the on-device
`MetricAccumulators` (`telemetry`): the wire bits, the saturations, this
step's compression error against the dense mean gradient (`err_l2`,
`err_cos`; the dense mean costs one more `all_reduce`, of the flat float32
gradient, which also carries the residual norm and the exchange's
observables to their sums), the measured bloom false positives, the live
workers and the exchange's route counters; with no host sync.
`telemetry_summary()` fetches them. With `cfg.ctrl` a
`CompressionController` reads that fetch every `cfg.telemetry_every`
steps and moves `compress_ratio` (and `fpr`) one rung along its ladder:
one exchanger per rung, built at the rung's first visit and cached
(`visited_ladder_indices`: exchangers built == rungs visited), the
residuals and the optimizer state carried across. `apply_profile`
re-runs the 'auto' plan selection under a fitted machine profile: one
exchanger per distinct plan (`visited_plan_keys`), none when the profile
agrees with the static constants. With both off the step runs exactly
the ops it runs without them.

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

from deepreduce_tpu_torch import costmodel
from deepreduce_tpu_torch.collectives import collectives_for, split_group
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.exchange import build_exchanger, wrap_streaming
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import mean_of_sum, reciprocal_f32
from deepreduce_tpu_torch.resilience.faults import participation_mask
from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators, fetch_delta
from deepreduce_tpu_torch.telemetry.spans import span

# the exchange's observables the telemetry step averages over the workers
# (the JAX package's pmean); fp_* and bucket_saturated are summed (psum)
_RS_MEANS = ("rs_density", "rs_dense_switches", "rs_oktopk_survivors", "rs_oktopk_threshold", "rs_oktopk_spills")


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
        self._telemetry_acc: Optional[MetricAccumulators] = None
        # the last fetched cumulative counters: the window_* rows' baseline
        self._prev_summary_fetch: Optional[dict] = None
        self._params_like: Optional[Dict[str, torch.Tensor]] = None
        # the adaptive controller: one exchanger per ladder rung, built at
        # the rung's first visit and cached by rung index
        self._ctrl = None
        self._exchanger_cache: Dict[int, GradientExchanger] = {}
        # the host-side mirror of state.step, taken from the first step's
        # state (resume-safe) and then counted here
        self._host_step: Optional[int] = None
        # profile-driven re-selection: one exchanger per distinct plan
        self._plan_key = None
        self._plan_ex_cache: Dict[Tuple, object] = {}
        if cfg.ctrl:
            from deepreduce_tpu_torch.controller import CompressionController

            self._ctrl = CompressionController(cfg)

    def init_state(self) -> TrainState:
        params = self.model.flax_params()
        self._params_like = {n: p.detach() for n, p in params.items()}
        if self._ctrl is not None:
            # the rung nearest cfg.compress_ratio; residual and optimizer
            # state have the gradients' shapes on every rung
            self._set_exchanger(self._exchanger_for(self._ctrl.index))
        else:
            self._set_exchanger(build_exchanger(params, self.cfg, device=self.device, group=self.group))
            self._plan_key = self._plan_key_of(self.exchanger)
            if self._plan_key is not None:
                self._plan_ex_cache[self._plan_key] = self.exchanger
        residuals = self.exchanger.init_state(self._params_like)
        opt = torch.optim.SGD(list(params.values()), lr=self.lr, momentum=self.momentum)
        return TrainState(
            params=params, batch_stats=self.model.flax_batch_stats(), optimizer=opt, residuals=residuals, step=0
        )

    def _set_exchanger(self, ex) -> None:
        self.exchanger = ex
        self.streaming = wrap_streaming(ex)

    def _exchanger_for(self, idx: int) -> GradientExchanger:
        """The cached flat exchanger of ladder rung `idx`: the base config
        with the rung's ratio (and fpr) substituted, and with buckets the
        rung's per-bucket operating points (uniform: every bucket moves
        together)."""
        ex = self._exchanger_cache.get(idx)
        if ex is None:
            cfg_i = self._ctrl.ladder.apply(self.cfg, idx)
            points = None
            if self.exchanger is not None and self.exchanger.num_buckets:
                pt = self._ctrl.ladder[idx]
                points = tuple((pt.ratio, pt.fpr) for _ in range(self.exchanger.num_buckets))
            ex = GradientExchanger(self._params_like, cfg_i, device=self.device, group=self.group,
                                   bucket_points=points)
            self._exchanger_cache[idx] = ex
        return ex

    def _control_update(self) -> None:
        """One controller evaluation at a telemetry fetch boundary: the
        fetch telemetry_every already pays, the controller's vote on the
        window, and on a switch the new rung's exchanger."""
        with span("ctrl/update"):
            fetch = self._telemetry_acc.fetch()
            decision = self._ctrl.observe(self._host_step, fetch)
        if decision is None or not decision["switched"]:
            return
        self._set_exchanger(self._exchanger_for(self._ctrl.index))

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
        ops. With `cfg.telemetry` the step adds to `telemetry` (see the
        module's description); with `cfg.ctrl` a step at a telemetry
        boundary first lets the controller move the rung."""
        if self._ctrl is not None:
            if self._host_step is None:
                self._host_step = int(state.step)
            if (self._host_step > 0 and self._host_step % self.cfg.telemetry_every == 0
                    and self._telemetry_acc is not None):
                self._control_update()
        telemetry = self.cfg.telemetry
        if telemetry and collect is None:
            collect = {}
        params = state.params
        mask = None
        if self.streaming is not None:
            # the whole exchange runs inside the backward pass
            with span("train/forward_backward"):
                loss, grads, agg, residuals, wire = self.streaming.value_and_grad_exchange(
                    self.loss_fn, params, batch, state.residuals, step=state.step, uniforms=uniforms, collect=collect
                )
        else:
            with span("train/forward_backward"):
                for p in params.values():
                    p.grad = None
                loss = self.loss_fn(batch)
                loss.backward()
                grads = {n: p.grad for n, p in params.items()}
            if self.cfg.resilience:
                # from host data every worker shares (the seed, the step): the
                # same mask on every worker, built on the device without a copy
                with span("resilience/mask"):
                    mask = participation_mask(self.num_workers, state.step, self.cfg.seed,
                                              drop_rate=self.cfg.drop_rate, fault_plan=self.cfg.fault_plan,
                                              device=self.device)
                if collect is not None:
                    W = self.num_workers
                    live = torch.full((), float(W), device=self.device) if mask is None else mask.sum(dtype=torch.float32)
                    collect["live_workers"] = live
                    collect["dropped"] = (live < W).to(torch.float32)
            with span("train/exchange"):
                agg, residuals, wire = self.exchanger.exchange(
                    grads, state.residuals, step=state.step, uniforms=uniforms, collect=collect, mask=mask
                )
        with span("train/apply_updates"):
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
        if telemetry:
            self._accumulate(grads, agg, residuals, wire, collect, mask)
        if self._ctrl is not None:
            self._host_step += 1
        return dataclasses.replace(state, residuals=residuals, step=state.step + 1), loss, wire

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def _accumulate(self, grads, agg, residuals, wire: WireStats, collect: dict, mask) -> None:
        """Add this step's terms to the accumulator, on the device. The dense
        mean gradient goes through one `all_reduce` of one float32 buffer,
        which also sums the residual norm and the exchange's per-worker
        observables (a W = 1 run without a group makes none)."""
        names = sorted(grads)
        dev = self.device
        if self._telemetry_acc is None:
            self._telemetry_acc = MetricAccumulators.zeros(num_buckets=self.exchanger.num_buckets, device=dev)
        flat_g = torch.cat([grads[n].reshape(-1).to(torch.float32) for n in names])
        d = flat_g.numel()
        if residuals is not None:
            res_sq = None
            for n in sorted(residuals):
                sq = torch.square(residuals[n].to(torch.float32)).sum()
                res_sq = sq if res_sq is None else res_sq + sq
            res_norm = torch.sqrt(res_sq)
        else:
            res_norm = torch.zeros((), dtype=torch.float32, device=dev)
        rs = [k for k in _RS_MEANS if k in collect]
        bucket_sat = collect.get("bucket_saturated")
        scalars = [res_norm, collect["fp_count"], collect["fp_universe"]] + [collect[k] for k in rs]
        parts = [flat_g, torch.stack([x.reshape(()).to(torch.float32) for x in scalars])]
        if bucket_sat is not None:
            parts.append(bucket_sat.to(torch.float32))
        packed = torch.cat(parts)
        if self.group is not None:
            packed = self._sum_over_workers(packed)
        W = self.num_workers
        sums = packed[d:]
        # pmean: times the float32 reciprocal of W; psum: the sum itself
        df = packed[:d] if self.group is None else mean_of_sum(packed[:d], W)
        means = sums if self.group is None else sums * reciprocal_f32(W)
        af = torch.cat([agg[n].reshape(-1).to(torch.float32) for n in names])
        ref = torch.linalg.vector_norm(df)
        err_l2 = torch.linalg.vector_norm(af - df) / torch.clamp(ref, min=1e-12)
        err_cos = torch.dot(af, df) / torch.clamp(torch.linalg.vector_norm(af) * ref, min=1e-12)
        if mask is not None:
            live = mask.sum(dtype=torch.float32)
            dropped = (live < W).to(torch.float32)
        else:
            live, dropped = float(W), 0.0
        rs_terms = {k: means[3 + i] for i, k in enumerate(rs)}
        self._telemetry_acc = self._telemetry_acc.accumulate(
            wire,
            residual_l2=means[0],
            err_l2=err_l2,
            err_cos=err_cos,
            fp_count=sums[1],
            fp_universe=sums[2],
            live_workers=live,
            dropped_steps=dropped,
            checksum_failures=collect.get("checksum_failures", 0.0),
            bucket_saturated=sums[3 + len(rs):] if bucket_sat is not None else 0.0,
            **rs_terms,
        )

    @property
    def telemetry(self) -> Optional[MetricAccumulators]:
        """The live on-device accumulator (None until the first telemetry
        step, or with cfg.telemetry off). A resume assigns a restored one
        here."""
        return self._telemetry_acc

    @telemetry.setter
    def telemetry(self, acc: Optional[MetricAccumulators]) -> None:
        self._telemetry_acc = acc

    def telemetry_summary(self) -> dict:
        """Fetch the accumulators (the telemetry_every host sync) and derive
        the cumulative rows, plus the same rates over the steps since the
        previous call under `window_*` keys; {} when telemetry is off or no
        step has run."""
        if self._telemetry_acc is None:
            return {}
        acc = self._telemetry_acc
        vals = acc.fetch()
        out = acc.derive(vals)
        # first call: no baseline yet, so the window is the whole run
        window_src = vals if self._prev_summary_fetch is None else fetch_delta(vals, self._prev_summary_fetch)
        out.update({f"window_{k}": v for k, v in acc.derive(window_src).items()})
        self._prev_summary_fetch = vals
        return out

    # ------------------------------------------------------------------ #
    # fitted-profile re-selection (costmodel.MachineProfile)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _plan_key_of(exchanger) -> Optional[Tuple]:
        """The auto-selected plan of an exchanger, or None when every
        selector was explicit (nothing a profile could re-select)."""
        plan = getattr(exchanger, "plan", None)
        if plan is not None:
            return ("hier", plan["ici"], plan["dcn"])
        if exchanger.cfg.rs_mode == "auto":
            # a hier stack without auto legs resolves the route in its
            # inner cross-slice exchanger
            inner = getattr(exchanger, "exchanger", exchanger)
            return ("rs", inner._rs_mode)
        return None

    @property
    def visited_plan_keys(self) -> Tuple[Tuple, ...]:
        """The auto-selected plans an exchanger was kept for: exchangers
        built for the step == plans visited."""
        return tuple(sorted(self._plan_ex_cache))

    def apply_profile(self, profile) -> dict:
        """Re-run this config's 'auto' plan selection under a fitted machine
        profile (a `costmodel.MachineProfile` or a path to one) and, when
        the calibrated argmin differs from the current plan, swap in the
        re-selected exchanger (cached by plan). A profile that agrees with
        the static constants is a no-op: same plan key, same exchanger
        object. Returns the decision record."""
        if self._ctrl is not None:
            raise ValueError(
                "apply_profile with ctrl=True would fight the adaptive controller for the operating point — use "
                "one or the other"
            )
        if self.exchanger is None or self._params_like is None:
            raise ValueError("apply_profile requires init_state() first")
        if isinstance(profile, (str, bytes)) or hasattr(profile, "__fspath__"):
            profile = costmodel.load_profile(profile)
        old_key = self._plan_key_of(self.exchanger)
        if old_key is None:
            return {"switched": False, "old": None, "new": None,
                    "reason": "no 'auto' selector in the config — nothing to re-select"}
        new_key = new_ex = None
        for key, ex in self._plan_ex_cache.items():
            if getattr(ex, "profile", None) is profile:
                new_key, new_ex = key, ex
                break
        if new_key is None:
            new_ex = build_exchanger(self._params_like, self.cfg, device=self.device, group=self.group,
                                     profile=profile)
            new_key = self._plan_key_of(new_ex)
        record = {"switched": new_key != old_key, "old": old_key, "new": new_key, "fitted": tuple(profile.fitted)}
        if getattr(new_ex, "plan", None) is not None:
            plan = new_ex.plan
            record["modeled_new_s"] = plan["modeled_step_s"]
            record["modeled_old_s"] = plan["table"][f"{old_key[1]}+{old_key[2]}"]
        if new_key == old_key:
            # the same plan: keep the committed exchanger; the candidate
            # differs only in the profile it consulted
            return record
        self._set_exchanger(self._plan_ex_cache.setdefault(new_key, new_ex))
        self._plan_key = new_key
        return record

    # ------------------------------------------------------------------ #
    # the adaptive controller (cfg.ctrl)
    # ------------------------------------------------------------------ #

    @property
    def controller(self):
        """The live CompressionController (None with cfg.ctrl off)."""
        return self._ctrl

    @property
    def visited_ladder_indices(self) -> Tuple[int, ...]:
        """The ladder rungs an exchanger was built for: exchangers built ==
        rungs visited."""
        return tuple(sorted(self._exchanger_cache))

    def attach_decision_log(self, path) -> None:
        """Persist every controller decision to `path` (decisions.jsonl)."""
        if self._ctrl is None:
            raise ValueError("attach_decision_log requires cfg.ctrl=True")
        from deepreduce_tpu_torch.controller import DecisionLog

        self._ctrl.log = DecisionLog(path)

    def controller_state(self) -> dict:
        """The controller's state for a checkpoint (after init_state, once
        the bucket geometry is known)."""
        if self._ctrl is None:
            raise ValueError("controller_state requires cfg.ctrl=True")
        if self.exchanger is None:
            raise ValueError("controller_state requires init_state() first")
        return self._ctrl.state_dict(self.exchanger.num_buckets)

    def load_controller_state(self, state: dict) -> None:
        """Restore a checkpointed controller trajectory: the next decision
        continues bitwise from the restored window baseline and vote
        streaks, on the restored rung's exchanger."""
        if self._ctrl is None:
            raise ValueError("load_controller_state requires cfg.ctrl=True")
        self._ctrl.load_state_dict(state)
        self._set_exchanger(self._exchanger_for(self._ctrl.index))
        self._host_step = None  # taken from state.step at the next step()
