"""Multi-group exchanges, ported from `deepreduce_tpu/parallel/`: the
two-tier (intra-node x inter-node) hierarchical exchange."""

from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger

__all__ = ["HierarchicalExchanger"]
