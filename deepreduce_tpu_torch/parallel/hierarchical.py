"""The two-tier exchange, ported from `deepreduce_tpu/parallel/hierarchical.py`.

Workers are grouped in slices: the workers of one slice share a fast link
(the JAX package's ICI axis, intra-node here), and slices are joined by a
scarce one (its DCN axis, across nodes). Compression belongs on the scarce
link only:

1. the slice mean over the `ici` group, `cfg.hier_ici`: 'dense' is one
   float32 `all_reduce` of the flat gradient times the float32 reciprocal
   of the slice size (`numerics.mean_of_sum`, as XLA compiles `/ n_ici`);
   'qar' is the int8 quantized allreduce (`qar.quantized_allreduce`, whose
   levels come from the `qsgd_quantize` kernel on the card);
2. the exchange the config describes over the `dcn` group, one worker a
   slice: a `comm.GradientExchanger` of any route (the fused or bucketed
   allgather, the sparse_rs routes, qar, the dense baseline).
   `cfg.hier_dcn='auto'` rewrites its config to the cost model's pick.

With `hier_ici` or `hier_dcn` 'auto', `costmodel.select_hier_plan` argmins
both legs at construction and the winning plan is `self.plan`.

The replica contract: every replica of a slice (the workers of one `ici`
group) enters step 2 with the identical slice mean and must run the
identical stochastic encode, or the replicas drift apart. The JAX package
gathers replica 0's key over the slice for that. The port's draws are
Philox streams keyed by (seed, name, step, worker), and the inner
exchanger's worker is its rank in the `dcn` group, which is the slice's
index and the same on every replica of it; so the replicas draw alike by
construction and there is no caller key to repair. The qar slice leg's
streams are keyed by the rank within the slice, as the JAX package keys
its draws by the ICI index.

Wire accounting is split by link: `payload_bytes()` and the index and
value bits are the scarce link's, as for a flat exchange, and the slice
leg's bits are `WireStats.ici_bits` (`ici_payload_bytes()` statically).
The JAX package adds the key-repair gather's bits to `ici_bits` where its
caller passes a key; the port has no such gather.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from deepreduce_tpu_torch import costmodel, qar
from deepreduce_tpu_torch.collectives import Collectives, collectives_for
from deepreduce_tpu_torch.comm import GradientExchanger
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.sparse import per_tensor_stream
from deepreduce_tpu_torch.telemetry.spans import span

Tree = Dict[str, torch.Tensor]
Group = Union[dist.ProcessGroup, Collectives, None]


def _cfg_dcn_leg(cfg: DeepReduceConfig, d: int, n_slices: int,
                 profile: Optional[costmodel.MachineProfile]) -> Optional[str]:
    """The cost model's name of the cross-slice route this config describes,
    or None where the route has no model row (allreduce, qar)."""
    if cfg.communicator == "sparse_rs":
        if cfg.rs_mode != "auto":
            return cfg.rs_mode
        return costmodel.select_rs_mode(
            d, n_slices, cfg.compress_ratio, headroom=cfg.rs_headroom, out_headroom=cfg.rs_out_headroom,
            block=cfg.rs_block_size, rows=cfg.rs_sketch_rows, cols=cfg.rs_sketch_cols, profile=profile,
        )
    if cfg.communicator == "allgather":
        return "bucketed" if cfg.bucket_bytes else "fused"
    return None


class HierarchicalExchanger:
    """The slice mean over `ici`, then the compressed exchange over `dcn`;
    `exchange` has `GradientExchanger.exchange`'s contract. `ici` and `dcn`
    are this worker's two groups (`collectives.split_group`,
    `collectives.InProcessGrid`)."""

    def __init__(
        self,
        grads_like: Dict[str, object],
        cfg: DeepReduceConfig,
        *,
        ici: Group,
        dcn: Group,
        device: DeviceLike = "cuda",
        profile: Optional[costmodel.MachineProfile] = None,
    ):
        self.cfg = cfg
        self.ici = collectives_for(ici)
        self.dcn = collectives_for(dcn)
        self.num_slices = self.dcn.world_size
        self.per_slice = self.ici.world_size
        if profile is None and cfg.profile is not None:
            profile = costmodel.load_profile(cfg.profile)
        self.profile = profile
        d = sum(math.prod(getattr(s, "shape", s)) for s in grads_like.values())
        self.ici_leg = cfg.hier_ici
        self.plan: Optional[Dict] = None
        inner_cfg = cfg
        if "auto" in (cfg.hier_ici, cfg.hier_dcn):
            if cfg.hier_dcn == "auto":
                # the routes the planner may rewrite to; the allgather one is
                # bucketed only where the config has a bucket partition
                dcn_legs = (("bucketed",) if cfg.bucket_bytes else ("fused",)) + (
                    "sparse", "adaptive", "quantized", "sketch")
            else:
                leg = _cfg_dcn_leg(cfg, d, self.num_slices, profile)
                if leg is None:
                    raise ValueError(
                        "hier_ici='auto' needs a cost-modelable DCN leg to argmin against, but "
                        f"communicator={cfg.communicator!r} has no cross-slice model row: pick hier_ici explicitly"
                    )
                dcn_legs = (leg,)
            self.plan = costmodel.select_hier_plan(
                d, self.num_slices, self.per_slice, cfg.compress_ratio, ici_block=cfg.bucket_size,
                ici_legs=None if cfg.hier_ici == "auto" else (cfg.hier_ici,), dcn_legs=dcn_legs,
                headroom=cfg.rs_headroom, out_headroom=cfg.rs_out_headroom, block=cfg.rs_block_size,
                rows=cfg.rs_sketch_rows, cols=cfg.rs_sketch_cols, profile=profile,
            )
            if cfg.hier_ici == "auto":
                self.ici_leg = self.plan["ici"]
            if cfg.hier_dcn == "auto":
                leg = self.plan["dcn"]
                if leg in ("fused", "bucketed"):
                    inner_cfg = dataclasses.replace(cfg, communicator="allgather", rs_mode="sparse")
                else:
                    inner_cfg = dataclasses.replace(cfg, communicator="sparse_rs", rs_mode=leg, bucket_bytes=None)
        self.inner_cfg = inner_cfg
        self.exchanger = GradientExchanger(grads_like, inner_cfg, device=device, group=self.dcn, profile=profile)
        self.device = self.exchanger.device
        self.names, self.shapes, self.d = self.exchanger.names, self.exchanger.shapes, self.exchanger.d

    @property
    def num_workers(self) -> int:
        """Every worker of both tiers."""
        return self.num_slices * self.per_slice

    @property
    def num_buckets(self) -> int:
        """The cross-slice exchanger's buckets (the telemetry accumulator's
        per-bucket rows)."""
        return self.exchanger.num_buckets

    def init_state(self, grads_like: Tree) -> Optional[Tree]:
        return self.exchanger.init_state(grads_like)

    def slice_mean(self, grads: Tree, *, step: int, uniforms: Optional[Tree] = None) -> Tree:
        """The mean of `grads` over this worker's slice through the ICI leg.
        `uniforms` (the qar leg's `qar.STREAM_PHASE1` / `STREAM_PHASE2`
        draws, CPU only) replaces its Philox streams."""
        cfg, ex, n_ici = self.cfg, self.exchanger, self.per_slice
        if self.ici_leg == "qar":
            # encode / decode sub-spans under route "qar": calibrate()
            # charges them to this codec's row, apart from the DCN leg's
            with span("exchange/encode", route="qar"):
                n = qar.pad_len(self.d, n_ici, cfg.bucket_size)
                padded = torch.zeros(n, dtype=torch.float32, device=ex.device)
                padded[: self.d] = ex._flatten(grads)
            names = (qar.STREAM_PHASE1, qar.STREAM_PHASE2)
            mean = qar.quantized_allreduce(
                padded, self.ici, streams=[per_tensor_stream(cfg.seed, s, step, self.ici.rank) for s in names],
                quantum_num=cfg.quantum_num, bucket_size=cfg.bucket_size,
                uniforms=None if uniforms is None else [uniforms[s] for s in names],
            )
            with span("exchange/decode", route="qar"):
                return ex._unflatten(mean[: self.d], grads)
        if n_ici == 1:
            return dict(grads)  # the mean of one: XLA drops the psum of a size-1 axis
        return ex._unflatten(mean_of_sum(self.ici.all_reduce_sum(ex._flatten(grads)), n_ici), grads)

    def ici_bits(self) -> float:
        """Bits this worker moves on the ICI leg a step (ring-adjusted), in
        the JAX package's exchange arithmetic (`ici_payload_bytes` keeps its
        static form: the two round alike only by that)."""
        if self.ici_leg == "qar":
            return qar.wire_bits_per_worker(self.d, self.per_slice, self.cfg.bucket_size)
        n = self.per_slice
        return 2.0 * (n - 1) / n * 32.0 * self.d if n > 1 else 0.0

    def exchange(
        self,
        grads: Tree,
        residuals: Optional[Tree],
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        ici_uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """(aggregate, new residuals, wire stats with `ici_bits`). `uniforms`
        replaces the cross-slice exchange's draws, `ici_uniforms` the qar
        slice leg's (both CPU only, the parity tests' hooks)."""
        if mask is not None:
            raise ValueError(
                "hierarchical exchange takes no participation mask (the ici slice mean is an unmasked psum; "
                "config rejects resilience=True with hier=True)"
            )
        with span("exchange/ici"):
            slice_mean = self.slice_mean(grads, step=step, uniforms=ici_uniforms)
        with span("exchange/dcn"):
            agg, new_residuals, wire = self.exchanger.exchange(slice_mean, residuals, step=step, uniforms=uniforms,
                                                               collect=collect)
        ici = torch.full((), self.ici_bits(), dtype=torch.float32, device=self.device)
        return agg, new_residuals, dataclasses.replace(wire, ici_bits=wire.ici_bits + ici)

    def payload_bytes(self) -> int:
        """Bytes this worker sends across slices a step: the scarce link
        only, comparable with a flat exchange's `payload_bytes()`."""
        return self.exchanger.payload_bytes()

    def ici_payload_bytes(self, per_slice: Optional[int] = None) -> float:
        """Ring-adjusted bytes this worker moves on the ICI leg a step."""
        p = self.per_slice if per_slice is None else per_slice
        if self.ici_leg == "qar":
            return qar.wire_bits_per_worker(self.d, p, self.cfg.bucket_size) / 8.0
        if p <= 1:
            return 0.0
        return 2.0 * (p - 1) / p * 4.0 * self.d
