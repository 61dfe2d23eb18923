"""Parallelism over groups of workers, ported from `deepreduce_tpu/parallel/`.

- `mesh`: `factor_devices`, `make_mesh` (this worker's group for each named
  axis) and `make_hybrid_mesh`;
- `functional`: the collectives as autograd Functions (the ring hop, the
  all_to_all, Megatron's pair, the all_gather) and the in-thread backward;
- `ring`: ring attention over a sequence-sharded group;
- `ulysses`: all-to-all sequence parallelism;
- `tp`: the tensor-parallel rules, this rank's shards and the tensor-parallel
  BERT;
- `data_seq`: the data x sequence training step of ring-attention BERT with
  the compressed exchange over the data group;
- `hierarchical`: the two-tier (intra-node x inter-node) exchange.
"""

from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger
from deepreduce_tpu_torch.parallel.mesh import factor_devices, make_hybrid_mesh, make_mesh
from deepreduce_tpu_torch.parallel.ring import ring_attention
from deepreduce_tpu_torch.parallel.tp import bert_tp_rules, tp_shardings
from deepreduce_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "factor_devices",
    "make_mesh",
    "ring_attention",
    "ulysses_attention",
    "bert_tp_rules",
    "tp_shardings",
    "HierarchicalExchanger",
    "make_hybrid_mesh",
]
