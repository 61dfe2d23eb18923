"""Neural Collaborative Filtering (NeuMF = GMF + MLP), the naturally sparse
model of the paper's Table 6: at the ML-20m widths (138,493 users, 26,744
items, `mf_dim` 64, MLP (256, 256, 128, 64)) 31,832,577 parameters in 12
leaves.

Ported from `deepreduce_tpu/models/ncf.py` (flax), with its names:
`{mf,mlp}_{user,item}/embedding` and `Dense_{0..3}/{kernel,bias}`. The
embeddings are gathered with `F.embedding`, whose gradient is a dense
tensor: the rows a batch does not touch are exactly zero, which is the
natural sparsity the Table-6 codecs (threshold 0.0) read.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepreduce_tpu_torch.models.common import Dense, Embed, FlaxNamed


class NeuMF(FlaxNamed, nn.Module):
    def __init__(
        self,
        num_users: int = 138_493,
        num_items: int = 26_744,
        mf_dim: int = 64,
        mlp_layers: Sequence[int] = (256, 256, 128, 64),
        *,
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.num_users, self.num_items = num_users, num_items
        mlp_dim = mlp_layers[0] // 2
        self.mf_user = Embed(num_users, mf_dim, gen)
        self.mf_item = Embed(num_items, mf_dim, gen)
        self.mlp_user = Embed(num_users, mlp_dim, gen)
        self.mlp_item = Embed(num_items, mlp_dim, gen)
        widths = list(mlp_layers)
        self.num_hidden = len(widths) - 1
        for j in range(self.num_hidden):
            self.add_module(f"Dense_{j}", Dense(widths[j], widths[j + 1], gen))
        self.add_module(f"Dense_{self.num_hidden}", Dense(mf_dim + widths[-1], 1, gen))

    def forward(self, user_ids: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        """int ids [batch] -> logits f32 [batch]."""
        gmf = self.mf_user(user_ids) * self.mf_item(item_ids)
        h = torch.cat([self.mlp_user(user_ids), self.mlp_item(item_ids)], dim=-1)
        for j in range(self.num_hidden):
            h = F.relu(getattr(self, f"Dense_{j}")(h))
        return getattr(self, f"Dense_{self.num_hidden}")(torch.cat([gmf, h], dim=-1))[..., 0]


def sigmoid_bce_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy, written as the JAX package's loss
    computes it (`optax.sigmoid_binary_cross_entropy`):
    -z * log_sigmoid(x) - (1 - z) * log_sigmoid(-x), where log_sigmoid(x) =
    -(max(-x, 0) + log1p(exp(-|x|))) (jax's softplus through `logaddexp`)."""
    tail = torch.log1p(torch.exp(-logits.abs()))
    log_p = -(F.relu(-logits) + tail)
    log_not_p = -(F.relu(logits) + tail)
    return (-labels * log_p - (1.0 - labels) * log_not_p).mean()
