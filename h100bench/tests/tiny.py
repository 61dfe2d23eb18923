"""Tiny copies of the benchmark's configurations and traffic for the CPU
tests: the same code paths at a size a CPU step runs in seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(workload: str, small: bool = False):
    """(config, traffic) of `workload`, shrunk; `small` keeps BERT wide
    enough (hidden 256) that a TF32 product differs from a float32 one by
    more than the sound run's rounding."""
    from h100bench.run import load_cell

    _, config, traffic = load_cell(bench(), workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if config["inputs"]["kind"] == "image":
        config["inputs"] = {"kind": "image", "shape": [32, 32, 3], "classes": 10}
        config["num_classes"] = 10
        config["stage_sizes"] = [1, 1, 1, 1]
        config["program"]["kwargs"].update(num_classes=10, stage_sizes=[1, 1, 1, 1])
        traffic["batch_per_worker"] = 4
    else:
        v, h, m, n, t = (4096, 256, 1024, 128, 8) if small else (128, 32, 64, 8, 2)
        sizes = dict(vocab_size=v, hidden_size=h, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=m, max_position_embeddings=n)
        config.update(sizes)
        config["inputs"] = {"kind": "tokens", "vocab": v}
        config["program"]["kwargs"] = dict(vocab_size=v, hidden=h, layers=1, heads=2, mlp_dim=m, max_len=n)
        traffic["batch_per_worker"] = t
        traffic["tokens_per_sequence"] = n
    return config, traffic
