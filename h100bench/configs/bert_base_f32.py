"""Plain PyTorch reference of the BERT-base encoder as the port's flax
layout has it: token and position embeddings, LayerNorm, 12 pre-LayerNorm
layers (dense bidirectional self-attention of 12 heads of 64, the query
scaled by 1/8; an MLP of 3,072 with tanh GELU), a final LayerNorm and an
untied float32 vocabulary head, all in float32 with TF32 off. LayerNorm
uses the biased variance max(0, E[x^2] - E[x]^2) and epsilon 1e-6. The loss
is the mean cross-entropy of the logits on tokens[:, :-1] against
tokens[:, 1:].

Under `precision='tf32'` (the control, the step below the configuration's
float32) the caller turns TF32 matrix products on around the forward and
the backward (`reference.precision_flags`). Imports nothing of the port."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str, float]


def param_specs(cfg: dict) -> List[Spec]:
    h, v, m = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    hd = h // heads
    specs: List[Spec] = [("tok/embedding", (v, h), "normal", 1 / math.sqrt(h)),
                         ("pos/embedding", (cfg["max_position_embeddings"], h), "normal", 1 / math.sqrt(h))]

    def ln(name):
        return [(f"{name}/scale", (h,), "const", 1.0), (f"{name}/bias", (h,), "const", 0.0)]

    specs += ln("LayerNorm_0")
    for i in range(cfg["num_hidden_layers"]):
        layer = f"TransformerLayer_{i}"
        att = f"{layer}/MultiHeadDotProductAttention_0"
        specs += ln(f"{layer}/LayerNorm_0")
        for p in ("query", "key", "value"):
            specs += [(f"{att}/{p}/kernel", (h, heads, hd), "normal", 1 / math.sqrt(h)),
                      (f"{att}/{p}/bias", (heads, hd), "const", 0.0)]
        specs += [(f"{att}/out/kernel", (heads, hd, h), "normal", 1 / math.sqrt(h)),
                  (f"{att}/out/bias", (h,), "const", 0.0)]
        specs += ln(f"{layer}/LayerNorm_1")
        specs += [(f"{layer}/Dense_0/kernel", (h, m), "normal", 1 / math.sqrt(h)),
                  (f"{layer}/Dense_0/bias", (m,), "const", 0.0),
                  (f"{layer}/Dense_1/kernel", (m, h), "normal", 1 / math.sqrt(m)),
                  (f"{layer}/Dense_1/bias", (h,), "const", 0.0)]
    specs += ln("LayerNorm_1")
    specs += [("mlm/kernel", (h, v), "normal", 1 / math.sqrt(h)), ("mlm/bias", (v,), "const", 0.0)]
    return specs


def stat_specs(cfg: dict) -> List[Spec]:
    return []


def _ln(x, p, name, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * p[f"{name}/scale"]) + p[f"{name}/bias"]


def loss_and_stats(cfg: dict, params, stats, batch, precision: str = "config"):
    """(the next-token loss of `batch` = (int tokens [batch, seq + 1],), {})."""
    p, eps = params, cfg["layer_norm_eps"]
    (tokens,) = batch
    inp, target = tokens[:, :-1], tokens[:, 1:]
    heads = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    x = F.embedding(inp, p["tok/embedding"]) + p["pos/embedding"][: inp.shape[1]][None]
    x = _ln(x, p, "LayerNorm_0", eps)
    for i in range(cfg["num_hidden_layers"]):
        layer = f"TransformerLayer_{i}"
        att = f"{layer}/MultiHeadDotProductAttention_0"
        y = _ln(x, p, f"{layer}/LayerNorm_0", eps)
        q, k, v = (torch.tensordot(y, p[f"{att}/{n}/kernel"], dims=1) + p[f"{att}/{n}/bias"]
                   for n in ("query", "key", "value"))
        scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        x = x + torch.tensordot(o, p[f"{att}/out/kernel"], dims=2) + p[f"{att}/out/bias"]
        y = _ln(x, p, f"{layer}/LayerNorm_1", eps)
        y = F.gelu(y @ p[f"{layer}/Dense_0/kernel"] + p[f"{layer}/Dense_0/bias"], approximate="tanh")
        x = x + y @ p[f"{layer}/Dense_1/kernel"] + p[f"{layer}/Dense_1/bias"]
    logits = _ln(x, p, "LayerNorm_1", eps) @ p["mlm/kernel"] + p["mlm/bias"]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1).long())
    return loss, {}
