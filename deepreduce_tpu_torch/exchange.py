"""The exchange stacks as legs, and the factory from a config to a stack,
ported from `deepreduce_tpu/exchange.py` for the flat stacks the port has
(the hierarchical wrapper is not ported).

Every stack has one shape, encode -> collective -> decode -> stats, and
`Leg` names one stage of it: its role, the mesh axis its collectives ride
(the data-parallel group is the JAX package's axis "data") and its
mechanism. `leg_plan` derives a built stack's plan by inspection and
`describe` prints it as the JAX package does. `build_exchanger` is the
factory; `wrap_streaming` adds the backprop-streamed schedule on top.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch.distributed as dist

from deepreduce_tpu_torch.collectives import Collectives
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike

AXIS = "data"  # the JAX package's default axis name for the data-parallel workers


@dataclasses.dataclass(frozen=True)
class Leg:
    """One stage of an exchange stack's plan. `role`: 'encode',
    'collective', 'decode', 'stats' or 'schedule'; `axis`: the mesh axis of
    its collectives (None for compute-only legs); `kind`: the mechanism,
    e.g. 'fused-allgather', 'bucketed-allgather', 'sparse_rs:oktopk',
    'qar', 'stream-hooks'."""

    role: str
    axis: Optional[str]
    kind: str

    def __str__(self) -> str:
        return f"{self.role}@{self.axis or '-'}:{self.kind}"


def _flat_legs(ex, axis: str) -> Tuple[Leg, ...]:
    cfg = ex.cfg
    if cfg.communicator == "qar":
        return (Leg("encode", None, "int8-bucket-quantize"), Leg("collective", axis, "qar"),
                Leg("decode", None, "dequantize"), Leg("stats", None, "wire"))
    if cfg.communicator == "sparse_rs":
        # under resilience the route re-owns a dropped worker's shards
        masked = (Leg("decode", axis, "masked-reowner"),) if cfg.resilience else ()
        return (Leg("encode", None, "topk-route"),) + masked + (
            Leg("collective", axis, f"sparse_rs:{cfg.rs_mode}"), Leg("decode", None, "shard-reselect"),
            Leg("stats", None, "wire"))
    if ex.dense:
        return (Leg("collective", axis, "dense-psum"), Leg("stats", None, "wire"))
    gather = "bucketed-allgather" if ex.bucketed is not None else "fused-allgather"
    decode = {"loop": "per-worker-loop", "vmap": "batched-vmap", "ring": "ring-permute"}[cfg.decode_strategy]
    collective = "ring-permute" if cfg.decode_strategy == "ring" else gather
    masked = (Leg("decode", None, "masked-row-weights"),) if cfg.resilience else ()
    return (Leg("encode", None, "codec-pack"), Leg("collective", axis, collective)) + masked + (
        Leg("decode", None, decode), Leg("stats", None, "wire"))


def leg_plan(ex) -> Tuple[Leg, ...]:
    """The collective plan of a built stack: a `GradientExchanger`, or a
    `StreamingExchange` over one."""
    if hasattr(ex, "value_and_grad_exchange"):
        return (Leg("schedule", None, "stream-hooks"),) + leg_plan(ex.exchanger)
    return _flat_legs(ex, AXIS)


def describe(ex) -> str:
    """One-line plan, e.g. 'encode@-:codec-pack | collective@data:fused-allgather | ...'."""
    return " | ".join(str(leg) for leg in leg_plan(ex))


def build_exchanger(
    grads_like: Dict[str, object],
    cfg: DeepReduceConfig,
    *,
    device: DeviceLike = "cuda",
    group: Optional[Union[dist.ProcessGroup, Collectives]] = None,
):
    """The factory from a config to a flat `GradientExchanger`. Streaming is
    a schedule of the step, not of the stack: see `wrap_streaming`."""
    return GradientExchanger(grads_like, cfg, device=device, group=group)


def wrap_streaming(exchanger):
    """A `StreamingExchange` over the stack when `cfg.stream_exchange` is
    set, else None."""
    if not exchanger.cfg.stream_exchange:
        return None
    return StreamingExchange(exchanger)
