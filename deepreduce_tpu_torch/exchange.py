"""The exchange stacks as legs, and the factory from a config to a stack,
ported from `deepreduce_tpu/exchange.py`.

Every stack has one shape, encode -> collective -> decode -> stats.
`Exchanger` is the protocol the stacks implement (`GradientExchanger`,
`parallel.HierarchicalExchanger`), and `Leg` names one stage of a stack:
its role, the mesh axis its collectives ride (the flat data-parallel group
is the JAX package's axis "data"; the hierarchical exchange's groups are
its "ici" and "dcn") and its mechanism. `leg_plan` derives a built stack's
plan by inspection and `describe` prints it as the JAX package does.
`build_exchanger` is the factory; `wrap_streaming` adds the
backprop-streamed schedule on top of a flat or a hierarchical stack.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Tuple, Union, runtime_checkable

import torch.distributed as dist

from deepreduce_tpu_torch.collectives import Collectives, split_group
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike
from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger

AXIS = "data"  # the JAX package's default axis name for the data-parallel workers


@runtime_checkable
class Exchanger(Protocol):
    """What every exchange stack implements: `exchange` runs one encode ->
    collective -> decode round of this worker and returns (the aggregate,
    the new residuals, its `WireStats`); `payload_bytes` is the static
    per-worker injection on the stack's wire-accounted (scarce) link."""

    cfg: DeepReduceConfig

    def init_state(self, grads_like: Any) -> Any: ...

    def exchange(self, grads: Any, residuals: Any, *, step: int, uniforms=None, collect=None,
                 mask=None) -> Tuple[Any, Any, Any]: ...

    def payload_bytes(self) -> int: ...


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
            Leg("collective", axis, f"sparse_rs:{ex._rs_mode}"), Leg("decode", None, "shard-reselect"),
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
    """The collective plan of a built stack: a `GradientExchanger`, a
    `HierarchicalExchanger` (its slice leg, then its inner plan across
    slices), or a `StreamingExchange` over either."""
    if hasattr(ex, "value_and_grad_exchange"):
        return (Leg("schedule", None, "stream-hooks"),) + leg_plan(ex.hier if ex.hier is not None else ex.exchanger)
    if isinstance(ex, HierarchicalExchanger):
        ici = Leg("collective", "ici", "dense-psum" if ex.ici_leg == "dense" else "qar")
        return (ici,) + _flat_legs(ex.exchanger, "dcn")
    return _flat_legs(ex, AXIS)


def describe(ex) -> str:
    """One-line plan, e.g. 'encode@-:codec-pack | collective@data:fused-allgather | ...'."""
    return " | ".join(str(leg) for leg in leg_plan(ex))


def build_exchanger(
    grads_like: Dict[str, object],
    cfg: DeepReduceConfig,
    *,
    device: DeviceLike = "cuda",
    group: Union[dist.ProcessGroup, Collectives, Tuple, None] = None,
    profile=None,
):
    """The factory from a config to a stack: with `cfg.hier` the
    `HierarchicalExchanger` over this worker's (ici, dcn) pair, which
    `group` is or from which `collectives.split_group` makes it with
    `cfg.ici_size`; else a flat `GradientExchanger` over `group`. Streaming
    is a schedule of the step, not of the stack: see `wrap_streaming`."""
    if cfg.hier:
        ici, dcn = split_group(group, cfg.ici_size)
        return HierarchicalExchanger(grads_like, cfg, ici=ici, dcn=dcn, device=device, profile=profile)
    return GradientExchanger(grads_like, cfg, device=device, group=group, profile=profile)


def wrap_streaming(exchanger):
    """A `StreamingExchange` over the stack when `cfg.stream_exchange` is
    set, else None."""
    if not exchanger.cfg.stream_exchange:
        return None
    return StreamingExchange(exchanger)
