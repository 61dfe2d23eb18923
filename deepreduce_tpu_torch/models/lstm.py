"""Next-word LSTM (the StackOverflow FedAvg model): embed 96 -> LSTM 670 ->
dense 96 -> vocab projection, 4,050,748 parameters at full width.

Ported from `deepreduce_tpu/models/lstm.py` (flax). The parameters keep
flax's layout and names — `Embed_0/embedding [V, E]`,
`OptimizedLSTMCell_0/{ii,if,ig,io}/kernel [E, H]`,
`OptimizedLSTMCell_0/{hi,hf,hg,ho}/{kernel [H, H], bias [H]}` and
`Dense_{0,1}/{kernel [in, out], bias}` — because top-k, the bloom hash and
the fused buffer all work on each leaf's flattened layout in sorted name
order: only the flax layout keeps the wire comparable with the JAX package.
The gate equations are flax's `OptimizedLSTMCell`:

    i = sigmoid(h@hi + x@ii)   f = sigmoid(h@hf + x@if)
    g = tanh(h@hg + x@ig)      o = sigmoid(h@ho + x@io)
    c' = f*c + i*g             h' = o * tanh(c')
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deepreduce_tpu_torch.models.common import Dense, FlaxNamed, _normal


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.embedding = _normal((vocab, dim), 1.0 / math.sqrt(dim), gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens]


class OptimizedLSTMCell(nn.Module):
    def __init__(self, d_in: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.hidden = hidden
        for gate in "ifgo":
            self.add_module(f"i{gate}", Dense(d_in, hidden, gen, use_bias=False))
        for gate in "ifgo":
            dense = Dense(hidden, hidden, gen)
            with torch.no_grad():
                q, _ = torch.linalg.qr(torch.randn(hidden, hidden, generator=gen))
                dense.kernel.copy_(q)  # flax's orthogonal recurrent init
            self.add_module(f"h{gate}", dense)

    def _cat(self, prefix: str, attr: str) -> torch.Tensor:
        return torch.cat([getattr(getattr(self, f"{prefix}{g}"), attr) for g in "ifgo"], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [batch, seq, E] -> hidden states [batch, seq, H], zero carry."""
        batch, seq, _ = x.shape
        hdim = self.hidden
        dense_i = x @ self._cat("i", "kernel")  # [B, T, 4H], all steps at once
        kernel_h = self._cat("h", "kernel")
        bias_h = self._cat("h", "bias")
        c = x.new_zeros(batch, hdim)
        h = x.new_zeros(batch, hdim)
        outs = []
        for t in range(seq):
            z = (h @ kernel_h + bias_h) + dense_i[:, t]
            i, f, g, o = z.split(hdim, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class WordLSTM(FlaxNamed, nn.Module):
    def __init__(
        self,
        vocab_size: int = 10_004,
        embed_dim: int = 96,
        hidden_dim: int = 670,
        *,
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.vocab_size = vocab_size
        self.Embed_0 = Embed(vocab_size, embed_dim, gen)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embed_dim, hidden_dim, gen)
        self.Dense_0 = Dense(hidden_dim, embed_dim, gen)
        self.Dense_1 = Dense(embed_dim, vocab_size, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens int [batch, seq] -> logits f32 [batch, seq, vocab]."""
        h = self.OptimizedLSTMCell_0(self.Embed_0(tokens))
        return self.Dense_1(self.Dense_0(h))
