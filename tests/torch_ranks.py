"""One rank of a real multi-process exchange of the port over gloo, for
`tests/test_torch_arms.py`. Imports torch and the port only, so that a
spawned rank starts fast; the test compares what each rank saves with the
single-process virtual-worker decode."""

import torch
import torch.distributed as dist

import deepreduce_tpu_torch as port


def run_rank(rank: int, world: int, store_path: str, out_path: str, arms, shapes, inputs) -> None:
    """Exchange `inputs[arm][rank]` = (grads, residuals) through
    `GradientExchanger.exchange` over a gloo group for each arm, and save
    {arm: (aggregate, new residuals)} to `out_path`."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        out = {}
        for arm, knobs, step in arms:
            ex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu", group=dist.group.WORLD)
            grads, res = inputs[arm][rank]
            agg, new_res, _ = ex.exchange(grads, res, step=step)
            out[arm] = (agg, new_res)
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def run_hier_rank(rank: int, world: int, store_path: str, out_path: str, knobs, shapes, inputs, step: int) -> None:
    """The hierarchical exchange of `inputs[rank]` = (grads, residuals) over
    a gloo group that `exchange.build_exchanger` splits into this rank's
    (ici, dcn) pair by `knobs['ici_size']`; saves (aggregate, residuals)."""
    from deepreduce_tpu_torch.exchange import build_exchanger

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        ex = build_exchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu", group=dist.group.WORLD)
        grads, res = inputs[rank]
        agg, new_res, _ = ex.exchange(grads, res, step=step)
        torch.save((agg, new_res), out_path)
    finally:
        dist.destroy_process_group()


def run_trainer_rank(rank: int, world: int, store_path: str, out_path: str, knobs, batches,
                     model=("ResNet20", {"seed": 0})) -> None:
    """One `Trainer.step` of `model` (a class of `deepreduce_tpu_torch.models`
    and its keyword arguments; a ResNet-20 of seed 0 by default) on
    `batches[rank]` over a gloo group. Saves this rank's gradient and
    running statistics (none without BatchNorm) from a probe
    copy of the model (what the step computes locally before any
    collective), then the step's aggregate (`p.grad` after the exchange),
    residuals, parameters, averaged statistics and loss."""
    import copy

    from deepreduce_tpu_torch import models
    from deepreduce_tpu_torch.train import classification_loss

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        model = getattr(models, model[0])(**model[1])
        trainer = port.Trainer(model, port.DeepReduceConfig(**knobs), lr=0.1, momentum=0.9, device="cpu",
                               group=dist.group.WORLD)
        state = trainer.init_state()
        probe = copy.deepcopy(model)
        classification_loss(probe)(batches[rank]).backward()
        out = {
            "grads": {n: p.grad.clone() for n, p in probe.flax_params().items()},
            "local_stats": {n: s.clone() for n, s in probe.flax_batch_stats().items()},
        }
        state, loss, _ = trainer.step(state, batches[rank])
        out.update(
            agg={n: p.grad.clone() for n, p in state.params.items()},
            residuals=state.residuals,
            params={n: p.detach().clone() for n, p in state.params.items()},
            stats={n: s.clone() for n, s in state.batch_stats.items()},
            loss=float(loss),
        )
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def run_fedsim_rank(rank: int, world: int, store_path: str, out_path: str, knobs, rounds: int, tables) -> None:
    """`rounds` rounds of `fedsim.FedSim` on the linear problem (dimension
    16, batch 4) over a gloo group, drawing the given draws: `tables` holds
    the cohort by (round, worker), the churn flags and the chaos draws by
    round, and each sampled client's batch by (round, global id). Saves this
    rank's final state (params, its stratum of the bank), the rounds'
    metrics and the counted all_reduce calls."""
    from deepreduce_tpu_torch import collectives
    from deepreduce_tpu_torch.fedsim import FedDraws, FedSim

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        cfg = port.DeepReduceConfig(**knobs)

        def data_fn(gids, rnd, key):
            xs, ys = zip(*(tables["batches"][rnd, g] for g in gids.tolist()))
            return torch.stack(xs), torch.stack(ys)

        def loss_fn(p, b):
            x, y = b
            return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

        draws = FedDraws(cohort=lambda r, w, t: tables["cohort"][r, w],
                         participation=lambda r, t: tables["participation"][r],
                         chaos=lambda r, t: tables["chaos"][r])
        sim = FedSim(loss_fn, cfg, cfg.fed_config(), 0.1, data_fn, group=dist.group.WORLD, client_chunk=2,
                     draws=draws, device="cpu")
        state = sim.init({"b": torch.zeros(()), "w": torch.zeros(16)})
        collectives.reset_reduce_counts()
        metrics = []
        for r in range(rounds):
            state, m = sim.step(state, r)
            metrics.append(m)
        torch.save(({"params": state.params, "residuals": state.residuals}, metrics, collectives.reduce_counts()),
                   out_path)
    finally:
        dist.destroy_process_group()


def run_telemetry_rank(rank: int, world: int, store_path: str, out_path: str, knobs, params, batches) -> None:
    """`len(batches)` telemetry steps of the JAX check's MLP (flax names,
    initial weights `params`) on `batches[step][rank]` over a gloo group.
    Saves this rank's accumulator fetch and final parameters."""
    from deepreduce_tpu_torch.resilience.__main__ import MLP

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        model = MLP()
        model.load_flax_params(params)
        trainer = port.Trainer(model, port.DeepReduceConfig(**knobs), lr=0.1, momentum=0.9, device="cpu",
                               group=dist.group.WORLD)
        state = trainer.init_state()
        for step_batches in batches:
            state, _, _ = trainer.step(state, step_batches[rank])
        torch.save({"fetch": trainer.telemetry.fetch(),
                    "params": {n: p.detach().clone() for n, p in state.params.items()}}, out_path)
    finally:
        dist.destroy_process_group()


def run_mesh_rank(rank: int, world: int, store_path: str, out_path: str, axes, qkv, cotangent) -> None:
    """`parallel.make_mesh(axes)` and `make_hybrid_mesh` over a gloo group:
    saves, for each axis, this rank's (rank, size, the group's global
    ranks); then ring and Ulysses attention over the 'seq' axis on this
    rank's sequence chunk of `qkv` (the chunks laid out over the whole
    mesh's 'seq' coordinate), forward and the gradients of
    sum(out * cotangent)."""
    from deepreduce_tpu_torch.parallel import make_hybrid_mesh, make_mesh, ring_attention, ulysses_attention
    from deepreduce_tpu_torch.parallel.functional import backward

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        def layout(mesh):
            return {a: (c.rank, c.world_size, dist.get_process_group_ranks(c.group)) for a, c in mesh.items()}

        mesh = make_mesh(axes, dist.group.WORLD)
        out = {"mesh": layout(mesh), "hybrid": layout(make_hybrid_mesh(2, world // 2))}
        seq = mesh["seq"]
        c = qkv[0].shape[1] // seq.world_size
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            q, k, v = (t[:, seq.rank * c : (seq.rank + 1) * c].clone().requires_grad_() for t in qkv)
            o = fn(q, k, v, seq, causal=True)
            backward((o * cotangent[:, seq.rank * c : (seq.rank + 1) * c]).sum())
            out[name] = (o.detach(), q.grad, k.grad, v.grad)
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
