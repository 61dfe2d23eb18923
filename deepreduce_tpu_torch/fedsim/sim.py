"""Population-scale federated simulation: client-sharded cohorts, ported
from `deepreduce_tpu/fedsim/sim.py`.

`fedavg.FedAvg` is the paper's harness: tens of clients, one after another.
This driver holds the population's per-client error-feedback state in a
residual *bank* (`[num_clients / W, ...]` tensors on each of W workers: a
worker owns a contiguous stratum of the clients) and each round

1. every worker samples its stratum's share of the cohort on the device (a
   permutation of its clients by hashed keys, the first C/W kept: gather
   and scatter against the bank stay local),
2. makes the sampled clients' batches from their global client ids
   (`data_fn`, batched over clients: no [population, ...] dataset exists),
3. runs the shared client body of `fedsim.round` (local SGD, the real
   `TensorCodec` compression with per-client error feedback, and when
   engaged the pack -> chaos -> checksum uplink) over its cohort share as
   batched blocks of `client_chunk` clients (`impl="vmap"`; `impl="scan"`
   runs them one by one, the reference),
4. contributes to exactly ONE `all_reduce` of one flat float32 buffer: the
   update sum, the four wire scalars, the live count and the checksum
   failures (and the per-class histogram with a population), the whole
   cross-worker traffic of a round (`collectives.all_reduce_counted`), and
   applies the live-count renormalized server step on every worker.

The asynchronous mode (FedBuff-style) turns the round into an ingest tick:
staleness-weighted deltas land in a buffer carried across ticks
(`AsyncBuffer`), the server applies once K live contributions arrived, the
S2C broadcast is paid on the tick after an apply, and clients train from
the `w_hist` ring of the last D reference models. The multi-tenant mode
stacks T populations (`MultiTenantState`) through the one tick: every
tenant's reduce members go into the one buffer, so the tick still makes
one all_reduce.

Draws: the JAX package draws with `jax.random` from the round key. The port
draws from the counter-based stream of `resilience.stream`, keyed by the
round key (an int), a domain tag, and the (global) position or client id,
on the device without a host sync: the cohort (`_SAMPLE_TAG`), churn (the
dropout stream of `resilience.faults` keyed by `_PART_TAG`), latency
(`fedsim.round._LATENCY_TAG`) and the population's draws
(`population.sampler`). The QSGD draws are the codec's streams at (step =
round, worker = cohort position), as `FedAvg` keys them. A `FedDraws`
object replaces any of them: the parity tests fill it with the JAX
package's draws.

The state is mutable where the JAX package donates it: the bank is updated
in place every round, and the async buffer's ring and the multi-tenant
state's stacked tensors every tick; keep only the returned state.
Checkpoints go through `checkpoint.py` (`save` / `restore` take these
states).

With `cfg.telemetry` the state carries the JAX package's
`MetricAccumulators` (`telemetry`; [T] per-tenant rows in the multi-tenant
state): each round or tick adds its wire bits, live clients, dropped
rounds, checksum failures and, where engaged, the staleness and per-class
histograms, all already reduced by the one all_reduce, so telemetry adds
no collective and no host sync. `summary()` fetches them (fleet totals for
the multi-tenant state) and reports the JAX package's telemetry rows next
to the round rates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import grad

from deepreduce_tpu_torch.collectives import all_reduce_counted, collectives_for
from deepreduce_tpu_torch.comm import PayloadLayout
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, check_on, resolve_device
from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec
from deepreduce_tpu_torch.telemetry.device_metrics import MetricAccumulators
from deepreduce_tpu_torch.telemetry.spans import span
from deepreduce_tpu_torch.fedsim.round import (
    WIRE_FIELDS,
    FedConfig,
    class_latency,
    cohort_updates,
    draw_latency,
    index_batch,
    latency_uniforms,
    make_async_client_step,
    make_client_step,
    parse_class_latency,
    parse_latency,
    parse_tenant_floats,
    parse_tenant_latency,
    staleness_weights,
    tree_add,
    tree_sub,
)
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import fma_f32
from deepreduce_tpu_torch.resilience import stream
from deepreduce_tpu_torch.resilience.chaos import ChaosInjector
from deepreduce_tpu_torch.resilience.faults import live_mask, participation_mask

Tree = Dict[str, torch.Tensor]

# domain tags of the round's draws (the latency tag is round.py's)
_S2C_TAG = 0x52C
_SAMPLE_TAG = 0x5A3
_PART_TAG = 0xFA1
_DATA_TAG = 0xDA7
# the linear problem's teacher stream
_TEACHER_SEED = 42


@dataclasses.dataclass
class FedDraws:
    """Given draws in place of FedSim's own (None: draw). Each callable
    takes the round and the tenant (0 single-tenant):

    - `cohort(rnd, worker, tenant)`: the worker's C/W sampled local ids;
    - `participation(rnd, tenant)`: C live flags over global positions;
    - `taus(rnd, tenant)`: C staleness levels over global positions;
    - `chaos(rnd, tenant)`: {position: chaos draws} (`ChaosInjector.perturb`);
    - `labels(rnd, gids, tenant)`: int [B, local_steps, batch] labels of
      the population transform;
    - `classes`: the population's N class ids."""

    cohort: Optional[Callable[[int, int, int], Sequence[int]]] = None
    participation: Optional[Callable[[int, int], Sequence[bool]]] = None
    taus: Optional[Callable[[int, int], Sequence[int]]] = None
    chaos: Optional[Callable[[int, int], Dict[int, Dict[str, Any]]]] = None
    labels: Optional[Callable[[int, Any, int], Any]] = None
    classes: Optional[Sequence[int]] = None


@dataclasses.dataclass
class AsyncBuffer:
    """Server-side aggregation buffer of the asynchronous mode, carried
    across ingest ticks in the state (checkpointed with it):

    - `delta_sum`: staleness-weighted sum of decoded client deltas since
      the last apply (tree like params);
    - `weight` / `count`: the accumulated `sum(1/(1+tau)^alpha)` over live
      contributions (the apply denominator) and the live count (compared
      with `k`, the apply threshold);
    - `version`: the server model version (number of applies);
    - `hist`: the w_ref ring, [D, ...] tensors of the last D reference
      models; None when D == 1;
    - `stale_sum` / `stale_max`: staleness counters of the buffered
      contributions (reset at apply);
    - `pending`: 1.0 when the previous tick applied, so this tick pays the
      S2C broadcast.

    Every field is a float32 (version int64) tensor on the device, with a
    leading [T] in the multi-tenant state."""

    delta_sum: Tree
    weight: torch.Tensor
    count: torch.Tensor
    k: torch.Tensor
    version: torch.Tensor
    hist: Optional[Tree]
    stale_sum: torch.Tensor
    stale_max: torch.Tensor
    pending: torch.Tensor


@dataclasses.dataclass
class FedSimState:
    params: Tree  # the server's true model
    w_ref: Tree  # what every client can reconstruct from the broadcasts
    residuals: Optional[Tree]  # [num_clients / W, ...] bank: this worker's stratum
    round: int
    buffer: Optional[AsyncBuffer] = None  # the async mode's buffer
    classes: Optional[torch.Tensor] = None  # int32 class ids of this worker's stratum
    telemetry: Optional[MetricAccumulators] = None  # the counters (cfg.telemetry)


@dataclasses.dataclass
class MultiTenantState:
    """T federated populations stacked along a leading tenant dimension
    through the one tick. `params` / `w_ref` / `residuals` / `buffer` are
    the single-tenant leaves with a leading [T] (the bank [T, N / W, ...]);
    `round` the per-tenant round counters; `active` which tenant slots run
    (an inactive slot's state is left as it is, its metrics are zero);
    `alpha` / `latency` / `cohort` the per-tenant knobs (host floats, D-row
    tuples, cohort sizes; None where the subsystem is off); `tick` the
    global tick counter that keys the stream."""

    params: Tree
    w_ref: Tree
    residuals: Optional[Tree]
    round: Tuple[int, ...]
    buffer: Optional[AsyncBuffer]
    active: Tuple[bool, ...]
    alpha: Optional[Tuple[float, ...]]
    latency: Optional[Tuple[Tuple[float, ...], ...]]
    cohort: Optional[Tuple[float, ...]]
    tick: int
    telemetry: Optional[MetricAccumulators] = None  # [T] rows of counters (cfg.telemetry)


def synthetic_linear_problem(
    dim: int, batch_size: int, local_steps: int, *, device: DeviceLike = "cuda"
) -> Tuple[Tree, Callable, Callable]:
    """A linear-teacher population: every client sees noiseless samples of
    one shared ground-truth regressor, with batches derived from the
    client's GLOBAL id (same id -> same data whichever worker simulates it).
    Returns (params0, data_fn, loss_fn); `data_fn(gids, rnd, key)` gives the
    clients' (x [B, E, b, dim], y [B, E, b]) from the stream keyed by the
    round's data key at the client's positions."""
    dev = resolve_device(device)
    m = local_steps * batch_size * dim
    w_true = teacher(dim, dev)

    def loss_fn(params, batch):
        x, y = batch
        pred = x @ params["w"] + params["b"]
        return torch.mean((pred - y) ** 2)

    def data_fn(gids, rnd, key):
        pos = gids.long()[:, None] * m + torch.arange(m, device=gids.device)
        x = stream.normals(key, pos).reshape(gids.shape[0], local_steps, batch_size, dim)
        return x, x @ w_true

    params0 = {"b": torch.zeros((), device=dev), "w": torch.zeros(dim, device=dev)}
    return params0, data_fn, loss_fn


def teacher(dim: int, device) -> torch.Tensor:
    """The linear problem's ground-truth regressor, a constant of the
    problem: f32[dim] standard normals of the teacher stream."""
    return stream.normals(stream.key(_TEACHER_SEED), torch.arange(dim, device=device))


def _stack(tree: Tree, n: int) -> Tree:
    return {k: torch.stack([v] * n) for k, v in tree.items()}


def _flat(tree: Tree, names: Sequence[str]) -> List[torch.Tensor]:
    return [tree[n].reshape(-1) for n in names]


class FedSim:
    """Client-sharded federated round driver.

    loss_fn(params, batch) -> scalar, functional (it runs under
    `torch.func.grad` and, batched, `torch.func.vmap`); data_fn(gids, rnd,
    key) -> the clients' batches, each leaf [B, local_steps, ...]. Clients
    run `local_steps` steps of SGD (`client_lr`, `client_momentum`, the
    momentum restarted every round). `group` (None, a `torch.distributed`
    process group or a `collectives.Collectives`) gives the W workers the
    population is sharded over; `num_clients` and `clients_per_round` must
    divide over them.
    """

    def __init__(
        self,
        loss_fn: Callable,
        cfg_c2s: DeepReduceConfig,
        fed: FedConfig,
        client_lr: float,
        data_fn: Callable,
        *,
        client_momentum: float = 0.0,
        cfg_s2c: Optional[DeepReduceConfig] = None,
        group=None,
        client_chunk: int = 0,
        impl: str = "vmap",
        draws: Optional[FedDraws] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg_c2s = cfg_c2s
        self.cfg_s2c = cfg_s2c if cfg_s2c is not None else cfg_c2s
        self.fed = fed
        self.client_lr = float(client_lr)
        self.client_momentum = float(client_momentum)
        self.data_fn = data_fn
        self.draws = draws or FedDraws()
        self._rows: Dict[Any, torch.Tensor] = {}
        if impl not in ("scan", "vmap"):
            raise ValueError(f"impl must be 'scan' or 'vmap', got {impl!r}")
        self.impl = impl
        self.colls = collectives_for(group)
        self.W = self.colls.world_size
        self.widx = self.colls.rank
        if fed.num_clients % self.W:
            raise ValueError(
                f"num_clients={fed.num_clients} must divide evenly over the {self.W} workers — each worker owns "
                "a contiguous stratum of the residual bank"
            )
        if fed.clients_per_round % self.W:
            raise ValueError(
                f"clients_per_round={fed.clients_per_round} must divide evenly over the {self.W} workers — "
                "cohorts are sampled stratum by stratum"
            )
        self.n_local = fed.num_clients // self.W
        self.c_local = fed.clients_per_round // self.W
        if client_chunk and self.c_local % client_chunk:
            raise ValueError(f"client_chunk={client_chunk} must divide the per-worker cohort {self.c_local}")
        self.client_chunk = int(client_chunk)
        self.use_res = cfg_c2s.memory == "residual"
        res_on = bool(cfg_c2s.resilience)
        self.drop_rate = cfg_c2s.drop_rate if res_on else 0.0
        self.fault_plan = cfg_c2s.fault_plan if res_on else None
        self.checksum = bool(res_on and cfg_c2s.payload_checksum)
        self.chaos = ChaosInjector.from_config(cfg_c2s)
        self.fed_async = bool(cfg_c2s.fed_async)
        self.async_k = int(cfg_c2s.fed_async_k or 0)
        self.async_alpha = float(cfg_c2s.fed_async_alpha)
        self.latency_probs = parse_latency(cfg_c2s.fed_async_latency or "")
        self.pop = self.pop_data_fn = self.pop_latency_rows = None
        if cfg_c2s.pop_spec is not None:
            from deepreduce_tpu_torch.population.sampler import make_population_data_fn
            from deepreduce_tpu_torch.population.spec import PopulationSpec

            spec = PopulationSpec.load_any(cfg_c2s.pop_spec)
            if cfg_c2s.pop_labels:
                spec = spec.with_overrides(num_labels=int(cfg_c2s.pop_labels))
            self.pop = spec
            self.pop_data_fn = make_population_data_fn(spec, data_fn)
            if spec.skew_on:
                from deepreduce_tpu_torch.population.sampler import tables_on

                tables_on(spec, self.device)  # the label tables' one copy to the device
            if self.fed_async and spec.latency_on:
                rows = parse_class_latency([c.latency for c in spec.classes], cfg_c2s.fed_async_latency or "")
                # one common depth D across the class rows and the global row
                D = max(len(rows[0]), len(self.latency_probs))
                self.pop_latency_rows = tuple(r + (0.0,) * (D - len(r)) for r in rows)
                self.latency_probs = tuple(self.latency_probs) + (0.0,) * (D - len(self.latency_probs))
        self.tenants = int(cfg_c2s.fed_tenants or 0)
        self.mt_k = self.mt_alpha = self.mt_latency = self.mt_cohort = None
        if self.tenants >= 1:
            T = self.tenants
            self.mt_k = parse_tenant_floats(cfg_c2s.fed_mt_k or "", T, "fed_mt_k", float(max(self.async_k, 1)))
            self.mt_alpha = parse_tenant_floats(cfg_c2s.fed_mt_alpha or "", T, "fed_mt_alpha", self.async_alpha)
            self.mt_latency = parse_tenant_latency(cfg_c2s.fed_mt_latency or "", T, cfg_c2s.fed_async_latency or "")
            coh = cfg_c2s.fed_mt_cohort or ""
            self.mt_cohort = (parse_tenant_floats(coh, T, "fed_mt_cohort", float(fed.clients_per_round))
                              if coh else None)
        # the latency rows on the device, copied once here, not in a tick
        for row in (self.latency_probs, self.pop_latency_rows, *(self.mt_latency or ())):
            if row is not None:
                self._row(row)
        self.tc_c2s = TreeCodec("c2s", cfg_c2s, device=self.device)
        self.tc_s2c = TreeCodec("s2c", self.cfg_s2c, device=self.device)
        self._layout: Optional[PayloadLayout] = None
        self._round_times: List[float] = []

    # ------------------------------------------------------------------ #

    def _local_train(self, params: Tree, batches: Any) -> Tree:
        """`local_steps` steps of SGD with momentum restarted (optax.sgd:
        `t = g + momentum * t`, `p = p - lr * t`), functional: it runs
        under `torch.func.vmap` in the batched cohort."""
        lr, mom = self.client_lr, self.client_momentum
        trace = None
        for s in range(self.fed.local_steps):
            g = grad(self.loss_fn)(params, index_batch(batches, s))
            trace = g if trace is None or not mom else {n: g[n] + mom * trace[n] for n in g}
            params = {n: params[n] - lr * trace[n] for n in params}
        return params

    def _row(self, probs: Tuple[float, ...]) -> torch.Tensor:
        """A latency row (or table) on the device, copied once."""
        if probs not in self._rows:
            self._rows[probs] = torch.tensor(probs, dtype=torch.float32).to(self.device)
        return self._rows[probs]

    def build_layout(self, params_like: Tree) -> None:
        """The checksum / chaos uplink's payload layout, from the parameter
        shapes alone."""
        spec = self.tc_c2s.spec(params_like)
        self._layout = PayloadLayout(self.tc_c2s.payload_specs(spec), checksum=self.checksum)

    def init(self, params: Tree):
        for n, p in params.items():
            check_on(p, self.device, f"parameter {n!r}")
        if self.checksum or self.chaos is not None:
            self.build_layout(params)
        if self.tenants >= 1:
            return self._init_mt(params)
        params = {n: p.detach().clone() for n, p in params.items()}
        bank = None
        if self.use_res:
            bank = {n: p.new_zeros((self.n_local,) + tuple(p.shape)) for n, p in params.items()}
        classes = None
        if self.pop is not None:
            if self.draws.classes is not None:
                classes = torch.as_tensor(list(self.draws.classes), dtype=torch.int32).to(self.device)
            else:
                from deepreduce_tpu_torch.population.sampler import class_assignments

                classes = class_assignments(self.pop, self.fed.num_clients, device=self.device)
            # this worker's stratum, as it owns the bank's
            classes = classes[self.widx * self.n_local : (self.widx + 1) * self.n_local].clone()
        w_ref = {n: p.clone() for n, p in params.items()}
        buffer = self._init_buffer(w_ref) if self.fed_async else None
        acc = None
        if self.cfg_c2s.telemetry:
            # the staleness histogram over the latency levels in async mode,
            # the per-class histogram with a population
            acc = MetricAccumulators.zeros(
                num_stale_levels=len(self.latency_probs) if self.fed_async else 0,
                num_pop_classes=self.pop.num_classes if self.pop is not None else 0, device=self.device)
        return FedSimState(params=params, w_ref=w_ref, residuals=bank, round=0, buffer=buffer, classes=classes,
                           telemetry=acc)

    def _init_buffer(self, w_ref: Tree) -> AsyncBuffer:
        """Empty buffer: version 0, pending broadcast (tick 0 pays the S2C as
        synchronous round 0 does), every ring slot the initial model."""
        D = len(self.latency_probs)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)  # noqa: E731
        return AsyncBuffer(
            delta_sum={n: torch.zeros_like(w) for n, w in w_ref.items()},
            weight=zero(), count=zero(),
            k=torch.full((), float(max(self.async_k, 1)), dtype=torch.float32, device=self.device),
            version=torch.zeros((), dtype=torch.int64, device=self.device),
            hist={n: torch.stack([w] * D) for n, w in w_ref.items()} if D > 1 else None,
            stale_sum=zero(), stale_max=zero(),
            pending=torch.ones((), dtype=torch.float32, device=self.device),
        )

    def _init_mt(self, params: Tree) -> MultiTenantState:
        """Every tenant slot starts from the caller's params; the tenants'
        trajectories part through their keys."""
        T = self.tenants
        params = {n: p.detach() for n, p in params.items()}
        bank = None
        if self.use_res:
            bank = {n: p.new_zeros((T, self.n_local) + tuple(p.shape)) for n, p in params.items()}
        buffer = alpha = latency = None
        if self.fed_async:
            D = len(self.mt_latency[0])
            zt = lambda: torch.zeros(T, dtype=torch.float32, device=self.device)  # noqa: E731
            buffer = AsyncBuffer(
                delta_sum={n: p.new_zeros((T,) + tuple(p.shape)) for n, p in params.items()},
                weight=zt(), count=zt(),
                k=torch.tensor(self.mt_k, dtype=torch.float32).to(self.device),
                version=torch.zeros(T, dtype=torch.int64, device=self.device),
                hist={n: torch.stack([torch.stack([p] * D)] * T) for n, p in params.items()} if D > 1 else None,
                stale_sum=zt(), stale_max=zt(),
                pending=torch.ones(T, dtype=torch.float32, device=self.device),
            )
            alpha, latency = self.mt_alpha, self.mt_latency
        acc = None
        if self.cfg_c2s.telemetry:
            acc = MetricAccumulators.zeros(num_stale_levels=len(self.mt_latency[0]) if self.fed_async else 0,
                                           device=self.device, batch=(T,))
        return MultiTenantState(
            params=_stack(params, T), w_ref=_stack(params, T), residuals=bank, round=(0,) * T, buffer=buffer,
            active=(True,) * T, alpha=alpha, latency=latency, cohort=self.mt_cohort, tick=0, telemetry=acc,
        )

    def set_active(self, state: MultiTenantState, mask: Sequence[bool]) -> MultiTenantState:
        """Tenant join / leave: an inactive slot's state stays as it is (its
        round counter too) until it rejoins."""
        mask = tuple(bool(m) for m in mask)
        if len(mask) != self.tenants:
            raise ValueError(f"the active mask needs {self.tenants} flags, got {len(mask)}")
        return dataclasses.replace(state, active=mask)

    # ------------------------------------------------------------------ #
    # the round body, in two halves around the fused all_reduce: `_local`
    # computes this worker's reduce members, `_finish` the server step from
    # their sums. The multi-tenant tick puts every tenant's members into the
    # same buffer.
    # ------------------------------------------------------------------ #

    def _keys(self, key: int, tenant: int) -> Dict[str, int]:
        # tenant 0 replays the single-tenant stream (the T = 1 degeneracy)
        k = key if tenant == 0 else stream.key(key, tenant)
        return {"round": k, "s2c": stream.key(k, _S2C_TAG), "sample": stream.key(k, _SAMPLE_TAG),
                "part": stream.key(k, _PART_TAG), "data": stream.key(k, _DATA_TAG)}

    def _sample(self, rnd: int, keys: Dict[str, int], tenant: int) -> torch.Tensor:
        """This worker's C/W sampled local ids (int64, on the device): the
        first C/W of its stratum sorted by hashed keys, without repeats."""
        if self.draws.cohort is not None:
            ids = self.draws.cohort(rnd, self.widx, tenant)
            return torch.as_tensor([int(i) for i in ids], dtype=torch.int64).to(self.device)
        gids = torch.arange(self.widx * self.n_local, (self.widx + 1) * self.n_local, device=self.device)
        order = torch.sort(stream.words_at(keys["sample"], gids), stable=True).indices
        return order[: self.c_local]

    def _mask(self, rnd: int, keys: Dict[str, int], tenant: int) -> Optional[torch.Tensor]:
        """The churn mask over GLOBAL cohort positions (every worker draws
        the same), bool[C] on the device, or None."""
        C = self.fed.clients_per_round
        if self.draws.participation is not None and (self.drop_rate > 0 or self.fault_plan is not None):
            return live_mask([bool(x) for x in self.draws.participation(rnd, tenant)], self.device)
        return participation_mask(C, rnd, keys["part"], drop_rate=self.drop_rate, fault_plan=self.fault_plan,
                                  device=self.device)

    def _local(self, params, w_ref, bank, rnd, key, *, tenant=0, classes=None, buf=None, alpha=None,
               lat_row=None, cohort=None):
        """One round's (or tick's) local half: S2C, sampling, the cohort,
        and this worker's reduce members. Returns (context, members)."""
        fed = self.fed
        C, C_local, n_local, w = fed.clients_per_round, self.c_local, self.n_local, self.widx
        if (self.checksum or self.chaos is not None) and self._layout is None:
            self.build_layout(params)  # a state restored or carried over without init
        keys = self._keys(key, tenant)
        asynchronous = buf is not None
        names = self.tc_c2s.spec(params).names

        # S2C: the compressed model delta against the receivers' w_ref
        delta = tree_sub(params, w_ref)
        dec_delta, _, wire_s2c = self.tc_s2c.compress_tree(delta, None, step=rnd, worker=0)
        hist = None
        if asynchronous:
            # staged every tick, paid only after an apply (exact selects)
            pending = buf.pending
            w_ref = {n: torch.where(pending > 0, r + dec_delta[n], r) for n, r in w_ref.items()}
            hist = buf.hist
            if hist is not None:
                D = next(iter(hist.values())).shape[0]
                slot = torch.remainder(buf.version, D).reshape(1)
                for n, h in hist.items():
                    h.index_copy_(0, slot, w_ref[n][None])
        else:
            w_ref = tree_add(w_ref, dec_delta)

        # stratified sampling, data, residual rows, churn
        ids_local = self._sample(rnd, keys, tenant)
        gids = w * n_local + ids_local
        positions = list(range(w * C_local, (w + 1) * C_local))
        cls_sampled = None
        if classes is not None:
            cls_sampled = classes.long()[ids_local]
            labels = None if self.draws.labels is None else self.draws.labels(rnd, gids, tenant)
            batches = self.pop_data_fn(gids, cls_sampled, rnd, keys["data"], labels=labels)
        else:
            batches = self.data_fn(gids, rnd, keys["data"])
        mask = self._mask(rnd, keys, tenant)
        part_local = None if mask is None else mask[w * C_local : (w + 1) * C_local].to(torch.float32)
        coh_global = None
        if cohort is not None:
            # the tenant's effective cohort: global positions < cohort
            coh_global = (torch.arange(C, device=self.device) < cohort).to(torch.float32)
            coh_local = coh_global[w * C_local : (w + 1) * C_local]
            part_local = coh_local if part_local is None else part_local * coh_local
        chaos_draws = None if self.draws.chaos is None else self.draws.chaos(rnd, tenant)

        taus = pop_rows = None
        if asynchronous:
            D = len(lat_row) if lat_row is not None else len(self.latency_probs)
            pop_rows = self.pop_latency_rows if classes is not None else None
            if self.draws.taus is not None:
                taus = torch.as_tensor([int(t) for t in self.draws.taus(rnd, tenant)], dtype=torch.int64).to(
                    self.device)
            elif pop_rows is not None:
                # per-class rows: each worker draws its own positions only
                u = latency_uniforms(keys["round"], C, self.device)[w * C_local : (w + 1) * C_local]
                taus = torch.zeros(C, dtype=torch.int64, device=self.device)
                taus[w * C_local : (w + 1) * C_local] = class_latency(u, self._row(pop_rows), cls_sampled)
            else:
                taus = draw_latency(keys["round"], self._row(lat_row or self.latency_probs), C, device=self.device)
            a = self.async_alpha if alpha is None else alpha
            client_step = make_async_client_step(
                self.tc_c2s, self._local_train, w_ref, hist, buf.version, taus, a, rnd,
                layout=self._layout, chaos=self.chaos, chaos_draws=chaos_draws)
        else:
            client_step = make_client_step(self.tc_c2s, self._local_train, w_ref, rnd, layout=self._layout,
                                           chaos=self.chaos, chaos_draws=chaos_draws)
        upd_sum, _, wire4, live = cohort_updates(
            client_step, batches, bank, positions, update_template=params, rows=ids_local,
            participation=part_local, checksum=self.checksum, impl=self.impl, chunk=self.client_chunk)
        nlive = live.sum()
        sent = part_local.sum() if part_local is not None else torch.full((), float(C_local), device=self.device)
        nfail = sent - nlive  # transmitted, rejected by the checksum
        members = _flat(upd_sum, names) + [torch.stack(wire4), nlive.reshape(1), nfail.reshape(1)]
        ctx = dict(params=params, w_ref=w_ref, names=names, wire_s2c=wire_s2c, rnd=rnd, buf=buf, hist=hist,
                   mask=mask, coh_global=coh_global, taus=taus, alpha=alpha, lat_row=lat_row, classes=classes)
        levels = None
        if asynchronous:
            taus_local = taus[w * C_local : (w + 1) * C_local]
            a = self.async_alpha if alpha is None else alpha
            wsum = (live * staleness_weights(taus_local.to(torch.float32), a)).sum()
            levels = torch.arange(D, device=self.device)
            # exact per-level histogram of ACCEPTED contributions
            st_hist = (live[:, None] * (taus_local[:, None] == levels[None, :]).to(torch.float32)).sum(dim=0)
            members += [wsum.reshape(1), st_hist]
            ctx.update(D=D, levels=levels)
        if classes is not None:
            k_levels = torch.arange(self.pop.num_classes, device=self.device)
            members.append((live[:, None] * (cls_sampled[:, None] == k_levels[None, :]).to(torch.float32)).sum(dim=0))
        if asynchronous and pop_rows is not None:
            # the transmit-side histogram (churn-gated, not checksum-gated)
            m_local = part_local if part_local is not None else torch.ones(C_local, device=self.device)
            members.append((m_local[:, None] * (taus_local[:, None] == levels[None, :]).to(torch.float32)).sum(dim=0))
        ctx["sizes"] = [m.numel() for m in members]
        return ctx, members

    def _finish(self, ctx, reduced: torch.Tensor):
        """The round's (tick's) second half from the summed members:
        the live-count renormalized server step (async: the buffer, applied
        at K), the wire accounting and the metrics. Returns (params, w_ref,
        buffer, metrics, the round's wire stats)."""
        fed = self.fed
        parts = list(torch.split(reduced, ctx["sizes"]))
        names, params = ctx["names"], ctx["params"]
        upd_sum = {n: parts[i].reshape(params[n].shape) for i, n in enumerate(names)}
        rest = parts[len(names):]
        wire4, nlive, nfail = rest[0], rest[1][0], rest[2][0]
        rest = rest[3:]
        wire_s2c = ctx["wire_s2c"]
        lr = fed.server_lr
        buf = ctx["buf"]
        if buf is None:
            pop_hist = rest[0] if ctx["classes"] is not None else None
            denom = torch.clamp(nlive, min=1.0)
            new_params = {n: fma_f32(upd_sum[n] / denom, lr, w) for n, w in params.items()}
            wire = WireStats(*(wire4[i] + getattr(wire_s2c, f) for i, f in enumerate(WIRE_FIELDS)))
            metrics = {
                "clients": nlive, "checksum_failures": nfail, "uplink_bytes": (wire4[0] + wire4[1]) / 8.0,
                "downlink_bytes": wire_s2c.total_bits / 8.0, "rel_volume": wire.rel_volume(),
            }
            if pop_hist is not None:
                metrics["pop_hist"] = pop_hist
            return new_params, ctx["w_ref"], None, metrics, wire

        wsum, st_hist = rest[0][0], rest[1]
        rest = rest[2:]
        pop_hist = tx_hist = None
        if ctx["classes"] is not None:
            pop_hist, rest = rest[0], rest[1:]
            if rest:
                tx_hist = rest[0]
        C, D = fed.clients_per_round, ctx["D"]
        taus_f = ctx["taus"].to(torch.float32)
        mask, coh = ctx["mask"], ctx["coh_global"]
        neg = torch.full((), -1.0, device=self.device)
        if tx_hist is not None:
            levels_f = ctx["levels"].to(torch.float32)
            sent_global = tx_hist.sum()
            st_sum = (levels_f * tx_hist).sum()
            st_max = torch.clamp(torch.where(tx_hist > 0, levels_f, neg).max(), min=0.0)
        elif coh is not None or mask is not None:
            m_f = coh if mask is None else (mask.to(torch.float32) if coh is None else mask.to(torch.float32) * coh)
            sent_global = m_f.sum()
            st_sum = (m_f * taus_f).sum()
            st_max = torch.clamp(torch.where(m_f > 0, taus_f, neg).max(), min=0.0)
        else:
            sent_global = torch.full((), float(C), device=self.device)
            st_sum = taus_f.sum()
            st_max = taus_f.max() if D > 1 else torch.zeros((), device=self.device)
        st_mean = st_sum / torch.clamp(sent_global, min=1.0)

        new_sum = tree_add(buf.delta_sum, upd_sum)
        new_weight = buf.weight + wsum
        new_count = buf.count + nlive
        applied = (new_count >= buf.k).to(torch.float32)
        denom = torch.clamp(new_weight, min=1.0)
        new_params = {n: torch.where(applied > 0, fma_f32(new_sum[n] / denom, lr, w), w) for n, w in params.items()}
        zero = torch.zeros((), device=self.device)
        new_buf = AsyncBuffer(
            delta_sum={n: torch.where(applied > 0, torch.zeros_like(s), s) for n, s in new_sum.items()},
            weight=torch.where(applied > 0, zero, new_weight),
            count=torch.where(applied > 0, zero, new_count),
            k=buf.k,
            version=buf.version + applied.to(torch.int64),
            hist=ctx["hist"],
            stale_sum=torch.where(applied > 0, zero, buf.stale_sum + st_sum),
            stale_max=torch.where(applied > 0, zero, torch.maximum(buf.stale_max, st_max)),
            pending=applied,
        )
        pending = buf.pending
        wire = WireStats(*(wire4[i] + pending * getattr(wire_s2c, f) for i, f in enumerate(WIRE_FIELDS)))
        metrics = {
            "clients": nlive, "checksum_failures": nfail, "uplink_bytes": (wire4[0] + wire4[1]) / 8.0,
            "downlink_bytes": pending * wire_s2c.total_bits / 8.0, "rel_volume": wire.rel_volume(),
            "staleness_mean": st_mean, "staleness_max": st_max, "staleness_hist": st_hist,
            "buffer_fill": new_count, "buffer_weight": new_weight, "applied": applied,
            "version": new_buf.version.to(torch.float32),
        }
        if pop_hist is not None:
            metrics["pop_hist"] = pop_hist
        return new_params, ctx["w_ref"], new_buf, metrics, wire

    def _tele_delta(self, acc: MetricAccumulators, wire: WireStats, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One round's accumulator terms from its reduced results: the wire,
        the live clients, whether any sampled client was lost, the checksum
        failures and the histograms (no collective of its own)."""
        nlive = metrics["clients"]
        return acc.delta(
            wire, live_workers=nlive, dropped_steps=(nlive < self.fed.clients_per_round).to(torch.float32),
            checksum_failures=metrics["checksum_failures"], staleness_hist=metrics.get("staleness_hist", 0.0),
            pop_hist=metrics.get("pop_hist", 0.0),
        )

    def _reduce(self, members: List[torch.Tensor]) -> torch.Tensor:
        """The round's ONE cross-worker collective: every member in one flat
        float32 buffer, one all_reduce."""
        return all_reduce_counted(self.colls, torch.cat([m.reshape(-1).to(torch.float32) for m in members]))

    def _single(self, state: FedSimState, key: int):
        ctx, members = self._local(state.params, state.w_ref, state.residuals, state.round, key,
                                   classes=state.classes, buf=state.buffer)
        params, w_ref, buf, metrics, wire = self._finish(ctx, self._reduce(members))
        acc = state.telemetry
        if acc is not None:
            acc = acc.add(self._tele_delta(acc, wire, metrics))
        return FedSimState(params=params, w_ref=w_ref, residuals=state.residuals, round=state.round + 1,
                           buffer=buf, classes=state.classes, telemetry=acc), metrics

    def _mt_tick(self, state: MultiTenantState, key: int):
        """One multi-tenant tick: every active tenant's local half, ONE
        all_reduce of all tenants' members (zeros in an inactive tenant's
        place), then every active tenant's server step."""
        T = self.tenants
        ctxs, members, sizes = [], [], None
        for t in range(T):
            sl = lambda tree: None if tree is None else {n: x[t] for n, x in tree.items()}  # noqa: E731
            buf_t = None
            if state.buffer is not None:
                b = state.buffer
                buf_t = AsyncBuffer(delta_sum=sl(b.delta_sum), weight=b.weight[t], count=b.count[t], k=b.k[t],
                                    version=b.version[t], hist=sl(b.hist), stale_sum=b.stale_sum[t],
                                    stale_max=b.stale_max[t], pending=b.pending[t])
            if not state.active[t]:
                ctxs.append(None)
                members.append(None)
                continue
            ctx, mem = self._local(
                sl(state.params), sl(state.w_ref), sl(state.residuals), state.round[t], key, tenant=t, buf=buf_t,
                alpha=None if state.alpha is None else state.alpha[t],
                lat_row=None if state.latency is None else tuple(state.latency[t]),
                cohort=None if state.cohort is None else state.cohort[t])
            ctxs.append(ctx)
            members.append(mem)
            sizes = ctx["sizes"]
        if sizes is None:  # no tenant active: nothing ran, the tick still counts
            return dataclasses.replace(state, tick=state.tick + 1), {}
        width = sum(sizes)
        flat = [torch.cat([m.reshape(-1).to(torch.float32) for m in mem]) if mem is not None
                else torch.zeros(width, device=self.device) for mem in members]
        reduced = all_reduce_counted(self.colls, torch.cat(flat)).view(T, width)
        rows: List[Optional[Dict[str, torch.Tensor]]] = []
        new_rounds = list(state.round)
        acc = state.telemetry
        deltas: List[Optional[torch.Tensor]] = []
        for t in range(T):
            if ctxs[t] is None:
                rows.append(None)
                deltas.append(None)
                continue
            params, w_ref, buf, metrics, wire = self._finish(ctxs[t], reduced[t])
            if acc is not None:
                deltas.append(self._tele_delta(acc, wire, metrics))
            for n in state.params:
                state.params[n][t].copy_(params[n])
                state.w_ref[n][t].copy_(w_ref[n])
            if buf is not None:
                b = state.buffer
                for n in b.delta_sum:
                    b.delta_sum[n][t].copy_(buf.delta_sum[n])
                for f in ("weight", "count", "version", "stale_sum", "stale_max", "pending"):
                    getattr(b, f)[t].copy_(getattr(buf, f))
            new_rounds[t] += 1
            rows.append(metrics)
        template = next(r for r in rows if r is not None)
        metrics = {k: torch.stack([r[k] if r is not None else torch.zeros_like(v) for r in rows])
                   for k, v in template.items()}
        if acc is not None:
            # an inactive tenant's row stays as it is: a zero delta
            width = next(x for x in deltas if x is not None)
            acc = acc.add(torch.stack([x if x is not None else torch.zeros_like(width) for x in deltas]))
        return dataclasses.replace(state, round=tuple(new_rounds), tick=state.tick + 1, telemetry=acc), metrics

    # ------------------------------------------------------------------ #

    def step(self, state, key: int, *, block: bool = False):
        """One federated round (or async / multi-tenant tick) under the round
        key `key` (an int). Returns (new_state, metrics): 0-d float32 tensors
        on the device ([T] per tenant), read on the host only by the caller.
        `block` waits for the device at the end, so that the host time
        recorded for `summary()` is the round's."""
        t0 = time.perf_counter()
        if isinstance(state, MultiTenantState):
            with span("fedsim/mt-tick"):
                out = self._mt_tick(state, key)
        else:
            with span("fedsim/tick" if self.fed_async else "fedsim/round"):
                out = self._single(state, key)
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._round_times.append(time.perf_counter() - t0)
        return out

    def stream(self, state, key: int, num_ticks: int, *, on_tick: Optional[Callable[[int], None]] = None):
        """`num_ticks` async ingest ticks back to back with no host sync per
        tick: tick r's key is `stream.key(key, r)` with r the state's round
        (the tick counter, multi-tenant), so `stream(state, key, T)` lands
        on the state of T calls of `step(state, stream.key(key, r))`.
        `on_tick(t)` runs on the host before tick t and once more after the
        last (t = num_ticks), e.g. to record CUDA events. Returns
        (final_state, per-tick metrics list, wall seconds); it waits for the
        device once, at the end."""
        if state.buffer is None:
            raise ValueError(
                "stream() drives the asynchronous buffered mode — build the FedSim with fed_async=True "
                "(state.buffer is None)"
            )
        mt = isinstance(state, MultiTenantState)
        r0 = state.tick if mt else state.round
        t0 = time.perf_counter()
        hist = []
        with span("fedsim/stream"):
            for t in range(num_ticks):
                if on_tick is not None:
                    on_tick(t)
                tick_key = stream.key(key, r0 + t)
                state, m = self._mt_tick(state, tick_key) if mt else self._single(state, tick_key)
                hist.append(m)
        if on_tick is not None:
            on_tick(num_ticks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if num_ticks > 0:
            self._round_times.extend([wall / num_ticks] * num_ticks)
        return state, hist, wall

    def summary(self, state) -> Dict[str, float]:
        """Host-side report: clients/sec from the recorded round times (the
        first dropped when there are more, as it pays the first calls'
        set-up) and, with telemetry, the accumulators' rows (one fetch;
        the multi-tenant state's rows summed over the tenants first) and
        the uplink bytes a round."""
        mt = isinstance(state, MultiTenantState)
        out: Dict[str, float] = {
            "clients_per_round": float(self.fed.clients_per_round),
            "num_clients": float(self.fed.num_clients),
            "rounds": float(len(self._round_times)),
        }
        if mt:
            out["fed_tenants"] = float(self.tenants)
            out["active_tenants"] = float(sum(state.active))
        if self.pop is not None:
            out["pop_classes"] = float(self.pop.num_classes)
        times = self._round_times[1:] if len(self._round_times) > 1 else self._round_times
        if times:
            per_round = sum(times) / len(times)
            out["round_time_s"] = per_round
            out["clients_per_sec"] = self.fed.clients_per_round / per_round
            if mt:
                out["clients_per_sec_per_tenant"] = out["clients_per_sec"]
                out["clients_per_sec"] *= max(out["active_tenants"], 1.0)
        if state.telemetry is not None:
            acc = state.telemetry.sum_tenants() if mt else state.telemetry
            tele = acc.summary()
            steps = max(tele["steps"], 1.0)
            out.update(tele)
            out["uplink_bytes_per_round"] = tele["cumulative_total_bits"] / 8.0 / steps
        return out
