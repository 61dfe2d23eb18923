"""PyTorch/CUDA port of deepreduce_tpu for NVIDIA Hopper.

This package imports `torch` and never `jax`, and nothing of the JAX
package: it keeps its own copies of what it needs (the config knobs, the
name hash, the bloom geometry). Module names follow `deepreduce_tpu`'s so
each counterpart is easy to find. Every entry point takes an explicit
`device` that defaults to "cuda" and raises when CUDA is absent; tests pass
`device="cpu"`.

The slice ported so far is the DRQSGD-BF-P0 data-parallel step: exact
top-k, a mod-blocked bloom index under the p0 policy, QSGD values (every
compressed leaf of a step encoded by one launch of a hand-written CUDA
kernel, `ops/csrc/qsgd_encode.cu`), one fused uint8 allgather, residual
error feedback and SGD.
"""

from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig, from_params
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.train import Trainer, TrainState
from deepreduce_tpu_torch.wrappers import TensorCodec

__all__ = [
    "ConfigError",
    "DeepReduceConfig",
    "GradientExchanger",
    "TensorCodec",
    "Trainer",
    "TrainState",
    "from_params",
]
