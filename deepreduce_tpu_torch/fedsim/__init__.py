"""Population-scale federated simulation (see sim.py's module docstring).

- `FedConfig`, `cohort_updates`, `make_client_step`, `make_async_client_step`
  (round.py): the round bodies `fedavg.FedAvg` and `FedSim` run;
- `TreeCodec` (codec_tree.py): the path-keyed per-leaf `TensorCodec` bank;
- `FedSim`, `FedSimState`, `AsyncBuffer`, `MultiTenantState`, `FedDraws`,
  `synthetic_linear_problem` (sim.py): the client-sharded population driver.
"""

from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec, TreeSpec
from deepreduce_tpu_torch.fedsim.round import (
    FedConfig,
    cohort_updates,
    make_async_client_step,
    make_client_step,
    parse_latency,
)
from deepreduce_tpu_torch.fedsim.sim import (
    AsyncBuffer,
    FedDraws,
    FedSim,
    FedSimState,
    MultiTenantState,
    synthetic_linear_problem,
)

__all__ = [
    "AsyncBuffer",
    "FedConfig",
    "FedDraws",
    "FedSim",
    "FedSimState",
    "MultiTenantState",
    "TreeCodec",
    "TreeSpec",
    "cohort_updates",
    "make_async_client_step",
    "make_client_step",
    "parse_latency",
    "synthetic_linear_problem",
]
