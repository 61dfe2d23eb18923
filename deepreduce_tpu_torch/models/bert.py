"""BERT-base encoder with dense self-attention, the model of BASELINE.json
config 5: 200 leaves and 132,363,066 parameters at the published widths
(vocabulary 30,522, hidden 768, 12 layers of 12 heads, MLP 3,072, 512
positions), trained on next-token prediction (`train.next_token_loss`).

Ported from `deepreduce_tpu/models/bert.py` (flax) with `attention='dense'`.
The parameters keep flax's names and layouts, because the codecs read each
flattened leaf in the JAX package's order: `tok/embedding`,
`pos/embedding`, `LayerNorm_0`, `TransformerLayer_{i}` (named explicitly,
so `remat` leaves the tree as it is), `LayerNorm_1` and the float32 head
`mlm`; in a layer `LayerNorm_0`, `MultiHeadDotProductAttention_0/{query,
key,value}` (`DenseGeneral`: kernel `[hidden, heads, head_dim]`, bias
`[heads, head_dim]`), `.../out` (kernel `[heads, head_dim, hidden]`),
`LayerNorm_1`, `Dense_0`, `Dense_1`.

A layer is pre-LayerNorm self-attention and a pre-LayerNorm MLP
(`Dense_0`, tanh-approximated GELU as flax's `nn.gelu`, `Dense_1`), each
added to its input. The attention is flax's `dot_product_attention` written
as products and a softmax: the query divided by sqrt(head_dim), the
scores, a softmax in the compute dtype (flax's `force_fp32_for_softmax`
is off), the weighted values. No mask: the dense encoder is bidirectional.

The sequence-parallel modes (`attention='ring'` / `'ulysses'`, a
`seq_axis`) need the port of `parallel/ring.py` and `parallel/ulysses.py`
(ROADMAP Queue 1 item 12) and raise `NotImplementedError`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepreduce_tpu_torch.models.common import Dense, DenseGeneral, Embed, FlaxNamed, LayerNorm


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, gen: torch.Generator, dtype: Optional[torch.dtype]):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.head_dim = hidden // heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((hidden,), (heads, self.head_dim), gen, dtype=dtype))
        self.out = DenseGeneral((heads, self.head_dim), (hidden,), gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [batch, seq, hidden] -> [batch, seq, hidden]."""
        q, k, v = self.query(x), self.key(x), self.value(x)  # [batch, seq, heads, head_dim]
        q = q / math.sqrt(self.head_dim)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class TransformerLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, gen: torch.Generator, dtype: Optional[torch.dtype]):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(hidden, heads, gen, dtype)
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)
        self.Dense_0 = Dense(hidden, mlp_dim, gen, dtype=dtype)
        self.Dense_1 = Dense(mlp_dim, hidden, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class BertEncoder(FlaxNamed, nn.Module):
    def __init__(
        self,
        vocab_size: int = 30_522,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_dim: int = 3072,
        max_len: int = 512,
        *,
        dtype: Optional[torch.dtype] = None,
        attention: str = "dense",
        seq_axis: Optional[str] = None,
        remat: bool = False,
        seed: int = 0,
    ):
        super().__init__()
        if attention != "dense" or seq_axis is not None:
            raise NotImplementedError(
                f"attention={attention!r} with seq_axis={seq_axis!r}: only attention='dense' without a sequence "
                "axis is ported; ring and Ulysses attention wait for parallel/ring.py and parallel/ulysses.py "
                "(ROADMAP Queue 1 item 12)"
            )
        gen = torch.Generator().manual_seed(seed)
        self.remat = remat
        self.num_layers = layers
        self.tok = Embed(vocab_size, hidden, gen, dtype=dtype)
        self.pos = Embed(max_len, hidden, gen, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        for i in range(layers):
            self.add_module(f"TransformerLayer_{i}", TransformerLayer(hidden, heads, mlp_dim, gen, dtype))
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)
        self.mlm = Dense(hidden, vocab_size, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """int tokens [batch, seq] -> float32 logits [batch, seq, vocab]."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.LayerNorm_0(self.tok(tokens) + self.pos(positions)[None])
        for i in range(self.num_layers):
            layer = getattr(self, f"TransformerLayer_{i}")
            # remat: recompute the layer's activations in the backward pass
            x = checkpoint(layer, x, use_reentrant=False) if self.remat and torch.is_grad_enabled() else layer(x)
        return self.mlm(self.LayerNorm_1(x))
