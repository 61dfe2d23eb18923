"""Reference of the dense exchange (`communicator='allreduce'`, no codec):
the mean of every worker's gradient, the sum times fl(1/W)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


class Exchange:
    def __init__(self, shapes: Dict[str, Tuple[int, ...]], knobs: dict, workers: int):
        if knobs.get("compressor") != "none" or knobs.get("deepreduce") is not None:
            raise NotImplementedError(f"dense references the uncompressed exchange, not {knobs}")
        self.workers = workers

    def step(self, comp: List[Dict[str, torch.Tensor]], step: int):
        inv = float(torch.tensor(1.0) / torch.tensor(float(self.workers)))
        mean = {n: sum(c[n].float() for c in comp) * inv for n in comp[0]}
        return mean, [dict(c) for c in comp]
