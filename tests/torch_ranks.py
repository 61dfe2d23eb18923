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
