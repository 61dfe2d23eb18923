"""The reference training run: the configuration's plain model, the plain
exchange of the traffic's knobs (`codecs/<codec_reference>.py`), residual
error feedback and `torch.optim.SGD`, over the same first steps and inputs
as the program, from the same weights (made again from the seed).

Readings, per leaf where a norm: the loss of each step (mean over the
workers), the norm of the first step's update as the optimizer got it, the
norms of the parameters' change, of the residuals and of the running
statistics' change after the last step, and the largest norm of the raw
mean gradient over the steps (what decides which leaves count)."""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def precision_flags(precision: str):
    """TF32 off for the reference; on for the TF32 control."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def model_module(config: dict):
    return importlib.import_module(f"h100bench.configs.{config['name']}")


def exchange_for(traffic: dict, shapes, knobs: dict, workers: int):
    mod = importlib.import_module(f"h100bench.codecs.{traffic['codec_reference']}")
    return mod.Exchange(shapes, knobs, workers)


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.linalg.vector_norm(t.float()) for n, t in tree.items()}


def run(config: dict, traffic: dict, knobs: dict, params0, stats0, steps: List[List[tuple]], *,
        precision: str = "config", fault: Optional[str] = None) -> dict:
    """`steps[s][w]`: worker w's batch at step s. `fault='half_batch'`
    drops the second half of every batch (the control of a fault, not a
    reference)."""
    mod = model_module(config)
    workers = len(steps[0])
    inv = float(torch.tensor(1.0) / torch.tensor(float(workers)))
    params = {n: t.clone().requires_grad_(True) for n, t in params0.items()}
    stats = {n: t.clone() for n, t in stats0.items()}
    ex = exchange_for(traffic, {n: tuple(t.shape) for n, t in params.items()}, knobs, workers)
    opt = torch.optim.SGD(list(params.values()), lr=traffic["optimizer"]["lr"],
                          momentum=traffic["optimizer"]["momentum"])
    residual = knobs.get("memory") == "residual"
    res = [{n: torch.zeros_like(t) for n, t in params.items()} for _ in range(workers)] if residual else None
    out = {"loss": [], "grad_max": {}}
    with precision_flags(precision):
        for s, per_worker in enumerate(steps):
            grads, losses, new_stats = [], [], []
            for batch in per_worker:
                if fault == "half_batch":
                    batch = tuple(t[: t.shape[0] // 2] for t in batch)
                loss, st = mod.loss_and_stats(config, params, stats, batch, precision)
                g = torch.autograd.grad(loss, list(params.values()))
                grads.append(dict(zip(params, g)))
                losses.append(loss.detach().float())
                new_stats.append(st)
            raw = {n: sum(g[n] for g in grads) * inv for n in params}
            for n, v in _norms(raw).items():
                out["grad_max"][n] = torch.maximum(out["grad_max"].get(n, v), v)
            comp = [{n: r[n] + g[n] for n in params} for r, g in zip(res, grads)] if residual else grads
            mean, own = ex.step(comp, s)
            if residual:
                res = [{n: c[n] - o[n].to(c[n].dtype) for n in params} for c, o in zip(comp, own)]
            for n, p in params.items():
                p.grad = mean[n].to(p.dtype)
            opt.step()
            if stats:
                stats = {n: sum(st[n] for st in new_stats) * inv for n in stats}
            out["loss"].append(sum(losses) * inv)
            if s == 0:
                out["first"] = _norms({n: opt.state[p]["momentum_buffer"] for n, p in params.items()})
            del grads, comp, mean, own
    out["change"] = _norms({n: params[n].detach() - params0[n] for n in params})
    if residual:
        out["residual"] = _norms(res[0])
    if stats:
        out["stats"] = _norms({n: stats[n] - stats0[n] for n in stats})
    return to_host(out)


def to_host(readings: dict) -> dict:
    """Device scalars to floats, one copy."""
    flat, keys = [], []
    for k, v in readings.items():
        if isinstance(v, dict):
            for n, t in v.items():
                keys.append((k, n))
                flat.append(torch.as_tensor(t, dtype=torch.float32).reshape(()))
        else:
            for i, t in enumerate(v):
                keys.append((k, i))
                flat.append(torch.as_tensor(t, dtype=torch.float32).reshape(()))
    vals = torch.stack([t.to(flat[0].device) for t in flat]).cpu().tolist() if flat else []
    out: dict = {}
    for (k, n), v in zip(keys, vals):
        if isinstance(n, int):
            out.setdefault(k, []).append(v)
        else:
            out.setdefault(k, {})[n] = v
    return out
