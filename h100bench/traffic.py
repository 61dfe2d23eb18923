"""The one generator of inputs and weights, from the run's seed, on the
device, with a `torch.Generator` on the card and a few large calls.

A traffic file (`traffic/<name>.json`) gives the loop and its sizes:
`batch_per_worker`, `tokens_per_sequence` (token inputs), `ring` (how many
distinct batches each worker cycles through), `steps_checked` (the first
steps the reference follows), `optimizer` and the DeepReduce `knobs` of the
step with the name of their plain reference (`codec_reference`). The
configuration says what one input is (`inputs`: images or tokens)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# distinct generator streams of one seed (the seed is any integer below 2**63)
_WEIGHTS, _INPUTS = 0, 1


def _generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + purpose) % (1 << 63))
    return g


def make_tensors(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors of `specs` ((name, shape, kind, scale)): one standard
    normal draw for every "normal" leaf at once, sliced and scaled per leaf;
    "const" leaves filled with their value."""
    normal = [(n, s) for n, s, kind, _ in specs if kind == "normal"]
    total = sum(int(torch.Size(s).numel()) for _, s in normal)
    flat = torch.randn(total, generator=_generator(seed, _WEIGHTS, device), device=device) if total else None
    out, lo = {}, 0
    for name, shape, kind, scale in specs:
        n = int(torch.Size(shape).numel())
        if kind == "normal":
            out[name] = flat[lo : lo + n].view(shape).mul_(scale)
            lo += n
        else:
            out[name] = torch.full(shape, float(scale), device=device)
    return out


def make_ring(config: dict, traffic: dict, workers: int, seed: int, device) -> List[List[Tuple[torch.Tensor, ...]]]:
    """ring[r][w]: worker w's r-th batch; every batch differs."""
    g = _generator(seed, _INPUTS, device)
    spec, b = config["inputs"], traffic["batch_per_worker"]
    ring = []
    for _ in range(traffic["ring"]):
        row = []
        for _ in range(workers):
            if spec["kind"] == "image":
                x = torch.randn((b, *spec["shape"]), generator=g, device=device)
                y = torch.randint(0, spec["classes"], (b,), generator=g, device=device)
                row.append((x, y))
            elif spec["kind"] == "tokens":
                row.append((torch.randint(0, spec["vocab"], (b, traffic["tokens_per_sequence"] + 1), generator=g,
                                          device=device),))
            else:
                raise ValueError(f"no generator for inputs of kind {spec['kind']!r}")
        ring.append(row)
    return ring

