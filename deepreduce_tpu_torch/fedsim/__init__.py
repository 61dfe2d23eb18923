"""Federated round bodies (`round.py`) and the path-keyed per-leaf codec
bank (`codec_tree.py`) that `fedavg.FedAvg` runs on."""

from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec, TreeSpec
from deepreduce_tpu_torch.fedsim.round import FedConfig, cohort_updates, make_client_step

__all__ = ["FedConfig", "TreeCodec", "TreeSpec", "cohort_updates", "make_client_step"]
