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


def run_trainer_rank(rank: int, world: int, store_path: str, out_path: str, knobs, batches) -> None:
    """One `Trainer.step` of a ResNet-20 (seed 0) on `batches[rank]` over a
    gloo group. Saves this rank's gradient and running statistics from a
    probe copy of the model (what the step computes locally before any
    collective), then the step's aggregate (`p.grad` after the exchange),
    residuals, parameters, averaged statistics and loss."""
    import copy

    from deepreduce_tpu_torch.models import ResNet20
    from deepreduce_tpu_torch.train import classification_loss

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        model = ResNet20(seed=0)
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
