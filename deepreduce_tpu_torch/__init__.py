"""PyTorch/CUDA port of deepreduce_tpu for NVIDIA Hopper.

This package imports `torch` and never `jax`, and nothing of the JAX
package: it keeps its own copies of what it needs (the config knobs, the
name hash, the bloom geometry). Module names follow `deepreduce_tpu`'s so
each counterpart is easy to find. Every entry point takes an explicit
`device` that defaults to "cuda" and raises when CUDA is absent; tests pass
`device="cpu"`.

The slices ported so far run the data-parallel step of every arm of the
paper's Table 4 on the WordLSTM: the DRQSGD-BF-P0 flagship (exact top-k,
a mod-blocked bloom index under the p0 policy, QSGD values with every
compressed leaf of a step encoded by one launch of a hand-written CUDA
kernel, `ops/csrc/qsgd_encode.cu`, one fused uint8 allgather, residual
error feedback and SGD), the dense allreduce baseline, Top-r, DRQSGD over
a delta-bitpacked integer index, sampled top-k, the sparsifier-free direct
bloom encode and bloom index-only; and the README quick start: top-k 1%
with the classic bloom index (fpr 0.001, leftmost) and the PolyFit value
codec on ResNet-20 with BatchNorm (`models.ResNet20`,
`codecs.registry.PolyFitCodec`), whose running statistics the trainer
averages over the workers; and the in-collective communicators, where the
reduction happens inside a reduce-scatter: the int8 quantized allreduce
(`communicator='qar'`, `qar.py`, whose levels come from the per-leaf
quantizer kernel `ops/csrc/qsgd_quantize.cu`) and the `sparse_rs` routes
sparse, adaptive, quantized and oktopk (`sparse_rs.py`); and the bucketed
exchange (`bucket_bytes`: one codec and one all_gather per bucket,
`comm_bucket.py`), pipelined, barrier or streamed from the backward pass
(`comm_stream.py`), built through `exchange.build_exchanger`; and every
codec, policy, layout, wrapper mode and sparsifier that the JAX package runs
on the device: the bloom random policy P1 and the approximate P2, the
hash-blocked layout, the run-length index (`codecs/rle.py`), the value-only
mode with PolyFit, Fit-DExp (`codecs/doubleexp.py`), PolySeg
(`codecs/polyseg.py`), the count sketch (`codecs/countsketch.py`) or QSGD,
and the random-k and threshold sparsifiers; and the paper's federated
deployment: compressed FedAvg (`fedavg.FedAvg`, the round body of
`fedsim.round`, the per-leaf codec bank `fedsim.TreeCodec`, whose every
direction's QSGD rows are one grouped launch) on MobileNetV1
(`models.MobileNetV1`) and the WordLSTM, and NeuMF (`models.NeuMF`) for the
Table-6 natural-sparsity encode; and the paper's remaining models at their
published widths, ResNet-50 (in bfloat16 as `bench.py` trains it),
DenseNet-40, VGG16 and BERT-base with dense attention and its next-token
loss (`train.next_token_loss`), with a checkpoint that carries the
residuals (`checkpoint.py`); and the resilient fused exchange: the unfused
exchange, the vmap and ring decodes (`comm_ring.py`), the payload checksum,
chaos at the wire boundary and participation masks (`resilience/`), with
the JAX package's reason codes on every rejection; and the sparse_rs
count-sketch route and the cost model's route choice (`rs_mode='sketch'`,
`'auto'`, `costmodel.py`, the JAX package's pricing and selectors with its
machine profiles), and the two-tier exchange (`parallel.
HierarchicalExchanger`, `cfg.hier`): a dense or int8-quantized slice mean
over the intra-node group, then the compressed exchange across slices,
planned by `costmodel.select_hier_plan` where asked, and streamed from the
backward pass; and the population-scale federated simulator
(`fedsim.FedSim`: client-sharded rounds over a residual bank with the
batched cohort, one fused all_reduce a round, the asynchronous and
multi-tenant ticks), heterogeneous populations (`population.
PopulationSpec`) and the SLO health monitor (`slo.HealthMonitor`); and
sequence and tensor parallelism (`parallel`): ring and Ulysses attention
over a sequence group (`BertEncoder(attention='ring' | 'ulysses',
seq_axis=group)`), the tensor-parallel rules, shards and BERT
(`parallel.tp`), the mesh helpers (`parallel.make_mesh`) and the data x
sequence step (`parallel.data_seq.DataSeqStep`); and the training driver
(`python -m deepreduce_tpu_torch.driver`, the counterpart of
`benchmarks/train.py`) with the reference's debug dumps
(`logging_utils.DumpLogger`). Collectives run through
`collectives.Collectives`: a `torch.distributed` group, an `InProcessGroup`
of W lockstep workers in one process, an `InProcessGrid` of slices x
workers a slice, or an `InProcessMesh` over named axes.
"""

from deepreduce_tpu_torch.collectives import Collectives, InProcessGrid, InProcessGroup, InProcessMesh
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig, from_params
from deepreduce_tpu_torch.codecs.registry import PolyFitCodec
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.fedavg import FedAvg, FedAvgState
from deepreduce_tpu_torch.fedsim import FedConfig, FedSim, FedSimState, TreeCodec
from deepreduce_tpu_torch.logging_utils import DumpLogger, policy_errors
from deepreduce_tpu_torch.parallel import HierarchicalExchanger
from deepreduce_tpu_torch.population import PopulationSpec
from deepreduce_tpu_torch.slo import HealthMonitor, SLOSpec
from deepreduce_tpu_torch.train import Trainer, TrainState
from deepreduce_tpu_torch.wrappers import TensorCodec

__all__ = [
    "Collectives",
    "ConfigError",
    "DeepReduceConfig",
    "DumpLogger",
    "FedAvg",
    "FedAvgState",
    "FedConfig",
    "FedSim",
    "FedSimState",
    "GradientExchanger",
    "HealthMonitor",
    "HierarchicalExchanger",
    "InProcessGrid",
    "InProcessGroup",
    "InProcessMesh",
    "PolyFitCodec",
    "PopulationSpec",
    "SLOSpec",
    "TensorCodec",
    "TreeCodec",
    "Trainer",
    "TrainState",
    "from_params",
    "policy_errors",
]
