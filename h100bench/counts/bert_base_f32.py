"""FLOPs a training sample (one sequence of `tokens` positions) of the
BERT-base encoder: two per multiply-add of the projections, the attention's
two products, the MLP and the vocabulary head, forward plus backward (twice
the forward). LayerNorm, softmax, GELU and the loss are left out."""

from __future__ import annotations


def forward_macs(cfg: dict, tokens: int) -> int:
    h, m, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    per_layer = tokens * (4 * h * h + 2 * h * m) + 2 * tokens * tokens * h
    return cfg["num_hidden_layers"] * per_layer + tokens * h * v


def flops_per_sample(cfg: dict, traffic: dict) -> float:
    return 3 * 2 * forward_macs(cfg, traffic["tokens_per_sequence"])
