"""BERT-base encoder, the model of BASELINE.json config 5: 200 leaves and
132,363,066 parameters at the published widths (vocabulary 30,522, hidden
768, 12 layers of 12 heads, MLP 3,072, 512 positions), trained on
next-token prediction (`train.next_token_loss`).

Ported from `deepreduce_tpu/models/bert.py` (flax). The parameters keep
flax's names and layouts, because the codecs read each flattened leaf in
the JAX package's order: `tok/embedding`, `pos/embedding`, `LayerNorm_0`,
`TransformerLayer_{i}` (named explicitly, so `remat` leaves the tree as it
is), `LayerNorm_1` and the float32 head `mlm`; in a layer `LayerNorm_0`,
the attention, `LayerNorm_1`, `Dense_0`, `Dense_1`. The attention's
`query`, `key`, `value` (`DenseGeneral`: kernel `[hidden, heads,
head_dim]`, bias `[heads, head_dim]`) and `out` (kernel `[heads, head_dim,
hidden]`) sit under `MultiHeadDotProductAttention_0` with
`attention='dense'` and under `SeqParallelSelfAttention_0` with `'ring'` or
`'ulysses'`: checkpoints do not transfer across the two layouts.

A layer is pre-LayerNorm self-attention and a pre-LayerNorm MLP
(`Dense_0`, tanh-approximated GELU as flax's `nn.gelu`, `Dense_1`), each
added to its input. The dense attention is flax's `dot_product_attention`
written as products and a softmax: the query divided by sqrt(head_dim), the
scores, flax's boolean `mask` where a layer is given one, a softmax in the
compute dtype, the weighted values. The encoder passes no mask: it is
bidirectional, and ignores `causal`, as the JAX package's does.

Long-context modes: `attention='ring'` / `'ulysses'` with `seq_axis` (the
sequence group: a `collectives.Collectives` or a `torch.distributed`
group, the port's counterpart of a named mesh axis) shard the sequence:
every worker of the group calls the model with its chunk of tokens, in rank
order, and the position embeddings are offset by `rank * chunk`. The
projections are per-token products and need no communication; the score
and softmax stage runs `parallel.ring.ring_attention` or
`parallel.ulysses.ulysses_attention`, with `causal` as the mask. For a
given non-dense mode, `seq_axis=None` computes the same function locally
with the identical parameter tree (the local twin). A worker's backward
runs on its own thread (`parallel.functional.backward`).

Tensor parallelism: `model_axis` (the model group, dense attention only)
keeps this rank's shards of the parameters under `parallel.tp`'s
`bert_tp_rules()` (the shards of the dense model of `seed`;
`parallel.tp.from_params` cuts a given model's) and computes the function
XLA's GSPMD computes from them: column-parallel `query`, `key`, `value`
and `Dense_0` (this rank's heads and MLP columns, no communication),
row-parallel `out` and `Dense_1` (one all-reduce each, the replicated bias
added once after the sum). `shard_vocab` also shards the vocabulary, as
the rules do under the variables dict's scope "params": the embedding
lookup is a masked gather of this rank's rows plus an all-reduce, and the
head's logits are all-gathered. Every rank returns the same logits, and a
replicated parameter receives the full gradient on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepreduce_tpu_torch.collectives import collectives_for
from deepreduce_tpu_torch.models.common import Dense, DenseGeneral, Embed, FlaxNamed, LayerNorm
from deepreduce_tpu_torch.parallel.functional import copy_to_group, gather_from_group, reduce_from_group
from deepreduce_tpu_torch.parallel.ring import ring_attention
from deepreduce_tpu_torch.parallel.tp import bert_tp_rules, shard_params
from deepreduce_tpu_torch.parallel.ulysses import ulysses_attention

ATTENTION = ("dense", "ring", "ulysses")


def _qkv_out(module: nn.Module, hidden: int, heads: int, head_dim: int, gen: torch.Generator, dtype) -> None:
    for name in ("query", "key", "value"):
        module.add_module(name, DenseGeneral((hidden,), (heads, head_dim), gen, dtype=dtype))
    module.out = DenseGeneral((heads, head_dim), (hidden,), gen, dtype=dtype)


def _column_input(x: torch.Tensor, model) -> torch.Tensor:
    """The input of a column-parallel product: its gradient is summed over
    the model group."""
    return x if model is None else copy_to_group(x, model)


def _row_parallel(dense: nn.Module, h: torch.Tensor, model) -> torch.Tensor:
    """`dense(h)` with `dense`'s input rows sharded over the model group:
    the partial products summed over the group, the bias added once after."""
    if model is None:
        return dense(h)
    y = reduce_from_group(dense.project(h), model)
    return y + dense.bias.to(y.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax's MHA self-attention; over a model group `model`, this rank's
    heads (column parallel) and a row-parallel `out`."""

    def __init__(self, hidden: int, heads: int, gen: torch.Generator, dtype: Optional[torch.dtype], model=None):
        super().__init__()
        self.head_dim = hidden // heads
        self.model = model
        _qkv_out(self, hidden, heads, self.head_dim, gen, dtype)

    def attend(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [batch, seq, hidden] -> the heads' outputs [batch, seq, heads,
        head_dim], before `out`. `mask` (bool, broadcast to [batch, heads,
        q, k]) keeps the scores where True, as flax's."""
        q, k, v = self.query(x), self.key(x), self.value(x)  # [batch, seq, heads, head_dim]
        q = q / math.sqrt(self.head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [batch, seq, hidden] -> [batch, seq, hidden]."""
        return _row_parallel(self.out, self.attend(_column_input(x, self.model), mask), self.model)


class SeqParallelSelfAttention(nn.Module):
    """Self-attention whose score / softmax stage runs ring, Ulysses or
    their local twin over the sequence group `seq` (None: local)."""

    def __init__(self, hidden: int, heads: int, gen: torch.Generator, dtype: Optional[torch.dtype], *,
                 attention: str, seq=None, causal: bool = False):
        super().__init__()
        self.attention, self.seq, self.causal = attention, seq, causal
        _qkv_out(self, hidden, heads, hidden // heads, gen, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [batch, chunk, hidden] -> [batch, chunk, hidden]."""
        q, k, v = self.query(x), self.key(x), self.value(x)
        attend = ulysses_attention if self.attention == "ulysses" else ring_attention
        return self.out(attend(q, k, v, self.seq, causal=self.causal))


class TransformerLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, gen: torch.Generator, dtype: Optional[torch.dtype],
                 *, attention: str = "dense", seq_axis=None, causal: bool = False, model=None):
        super().__init__()
        if attention not in ATTENTION:
            raise ValueError(f"attention={attention!r}: one of {ATTENTION}")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        if attention == "dense":
            if seq_axis is not None:
                raise ValueError(
                    "attention='dense' cannot run sequence-sharded; use attention='ring' or 'ulysses' with seq_axis"
                )
            self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(hidden, heads, gen, dtype, model)
        else:
            seq = None if seq_axis is None else collectives_for(seq_axis)
            self.SeqParallelSelfAttention_0 = SeqParallelSelfAttention(
                hidden, heads, gen, dtype, attention=attention, seq=seq, causal=causal)
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)
        self.Dense_0 = Dense(hidden, mlp_dim, gen, dtype=dtype)
        self.Dense_1 = Dense(mlp_dim, hidden, gen, dtype=dtype)
        self.model = model

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        if hasattr(self, "MultiHeadDotProductAttention_0"):
            attn = self.MultiHeadDotProductAttention_0(h, mask)
        else:
            if mask is not None:
                raise ValueError(
                    "ring/ulysses attention supports only the built-in causal mask; arbitrary masks need the dense path"
                )
            attn = self.SeqParallelSelfAttention_0(h)
        x = x + attn
        h = F.gelu(self.Dense_0(_column_input(self.LayerNorm_1(x), self.model)), approximate="tanh")
        return x + _row_parallel(self.Dense_1, h, self.model)


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
        seq_axis=None,
        causal: bool = False,
        remat: bool = False,
        model_axis=None,
        shard_vocab: bool = False,
        seed: int = 0,
    ):
        super().__init__()
        if model_axis is not None and attention != "dense":
            raise ValueError(f"tensor parallelism (model_axis) runs attention='dense', not {attention!r}")
        if shard_vocab and model_axis is None:
            raise ValueError("shard_vocab shards the vocabulary over model_axis, which is None")
        gen = torch.Generator().manual_seed(seed)
        self.remat = remat
        self.num_layers = layers
        self.seq = None if seq_axis is None or attention == "dense" else collectives_for(seq_axis)
        self.model = None if model_axis is None else collectives_for(model_axis)
        self.shard_vocab = shard_vocab
        self.tok = Embed(vocab_size, hidden, gen, dtype=dtype)
        self.pos = Embed(max_len, hidden, gen, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        for i in range(layers):
            self.add_module(f"TransformerLayer_{i}", TransformerLayer(
                hidden, heads, mlp_dim, gen, dtype, attention=attention, seq_axis=seq_axis, causal=causal,
                model=self.model))
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)
        self.mlm = Dense(hidden, vocab_size, gen)
        if self.model is not None:  # keep this rank's shards of the dense model's draw
            shards = shard_params(self.flax_params(), {"model": self.model}, bert_tp_rules(),
                                  scope="params" if shard_vocab else None)
            for n, p in self.flax_params().items():
                p.data = shards[n]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if not self.shard_vocab:
            return self.tok(tokens)
        # a masked gather of this rank's rows, summed over the model group
        rows = self.tok.embedding.shape[0]
        local = tokens - self.model.rank * rows
        inside = ((local >= 0) & (local < rows))[..., None]
        emb = self.tok(local.clamp(0, rows - 1))
        return reduce_from_group(emb.masked_fill(~inside, 0), self.model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """int tokens [batch, chunk] -> float32 logits [batch, chunk, vocab]."""
        chunk = tokens.shape[1]
        offset = 0 if self.seq is None else self.seq.rank * chunk  # the chunk's global start
        positions = offset + torch.arange(chunk, device=tokens.device)
        x = self.LayerNorm_0(self._embed(tokens) + self.pos(positions)[None])
        for i in range(self.num_layers):
            layer = getattr(self, f"TransformerLayer_{i}")
            # remat: recompute the layer's activations in the backward pass
            x = checkpoint(layer, x, use_reentrant=False) if self.remat and torch.is_grad_enabled() else layer(x)
        h = self.LayerNorm_1(x)
        if self.shard_vocab:  # this rank's vocabulary columns, gathered
            return gather_from_group(self.mlm(copy_to_group(h, self.model)), self.model, dim=-1)
        return self.mlm(h)
