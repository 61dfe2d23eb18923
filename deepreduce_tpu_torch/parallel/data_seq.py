"""The data x sequence training step: ring-attention (or Ulysses) BERT
sequence-sharded over the `seq` group, composed with the compressed
exchange over the `data` group in one step, the counterpart of the JAX
package's `__graft_entry__._dryrun_dp_sp` (its `spmd` body):

1. the loss is the mean softmax cross-entropy of the model's logits on this
   worker's chunk against the tokens themselves;
2. the gradients are summed over the seq group (one flat buffer, one
   all_reduce): the parameters replicate over the sequence;
3. the reported loss is the mean over seq, then over data;
4. a `comm.GradientExchanger` runs over the data group;
5. the update is `p - LR * agg`, the JAX body's constant step size.

After the seq sum every worker of a data line holds the same gradient, and
the exchanger's draws are keyed by the data rank, so all replicas stay
bitwise alike. The step makes no host sync: the loss stays on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepreduce_tpu_torch.collectives import collectives_for
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.parallel.functional import backward

LR = 0.1


def token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`softmax_cross_entropy_with_integer_labels(logits, tokens).mean()`."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1).long())


class DataSeqStep:
    """One worker of a (data, seq) mesh. `model` is a sequence-parallel
    `models.BertEncoder` built with `seq_axis=seq` (its parameters the
    same on every worker); `data` and `seq` are this worker's groups
    (`parallel.mesh.make_mesh({'data': D, 'seq': S}, group)`, or an
    `InProcessMesh` member)."""

    def __init__(self, model, cfg: DeepReduceConfig, *, data=None, seq=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data, self.seq = collectives_for(data), collectives_for(seq)
        self.params = model.flax_params()
        self.exchanger = GradientExchanger({n: tuple(p.shape) for n, p in self.params.items()}, cfg,
                                           device=self.device, group=self.data)

    def step(self, tokens: torch.Tensor, *, step: int = 0,
             uniforms: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, WireStats]:
        """One step on this worker's chunk `tokens` [batch, chunk]: (the
        loss, meaned over seq and data, on the device; the exchange's wire
        stats). `uniforms` (CPU only) replaces the exchanger's QSGD draws."""
        for p in self.params.values():
            p.grad = None
        loss = token_loss(self.model(tokens), tokens)
        backward(loss)
        flat = self.seq.all_reduce_sum(torch.cat([p.grad.reshape(-1) for p in self.params.values()]))
        grads, lo = {}, 0
        for n, p in self.params.items():
            grads[n] = flat[lo : lo + p.numel()].view(p.shape)
            lo += p.numel()
        loss = mean_of_sum(self.data.all_reduce_sum(
            mean_of_sum(self.seq.all_reduce_sum(loss.detach()), self.seq.world_size)), self.data.world_size)
        agg, _, wire = self.exchanger.exchange(grads, None, step=step, uniforms=uniforms)
        with torch.no_grad():
            for n, p in self.params.items():
                p.sub_(agg[n], alpha=LR)
        return loss, wire
