"""Gradient exchange: compress -> one fused uint8 allgather -> decode ->
mean, ported from `deepreduce_tpu/comm.py` for `communicator='allgather'`,
`fused=True` and `decode_strategy='loop'`; the bucketed exchange
(`bucket_bytes`, `comm_bucket.py`); the dense baseline; and the
in-collective communicators `qar` and `sparse_rs`.

The dense baseline (`communicator='allreduce'`, or no codec and the
`none` sparsifier) is the mean over workers through one `all_reduce` of
one flat float32 buffer: no codec runs and the residual state passes
through unchanged, as in the JAX package's `psum` branch.

The exchange is split into three parts so that each can be driven alone:

1. `encode_worker`: compensate with the residual, run every tensor's index
   stage, write each payload's leaves into one uint8[B] buffer at static
   offsets (tensors in sorted name order, each payload's leaves in the JAX
   pytree's order, so the bytes are comparable with the JAX package's fused
   buffer), and write the QSGD wire rows of every compressed tensor straight
   into the buffer with one grouped kernel launch; a value codec that
   reorders its values (PolyFit) is encoded leaf by leaf instead;
2. `gather`: `all_gather` over the group's `Collectives` into [W, B]
   (`dist.all_gather_into_tensor` for a process group), or the identity at
   world size 1 without a group;
3. `decode_aggregate`: decode every row in worker order into one running
   sum per tensor, keep this worker's own row for the residual, and take
   the mean as XLA computes `/ W`: times the float32 reciprocal of W
   (`numerics.mean_of_sum`). Where a tensor's codec runs on the host
   (`codecs.host`), each gathered row is copied to the host once and
   every host codec reads its leaves and in-band lengths there: one host
   sync per row, besides the copies each host codec's encode makes.

Tests drive 1 and 3 for W virtual workers in one process.

The codecs and their byte layout in the buffer are a `FusedBuffer` over
named units: the tensors themselves, or with `bucket_bytes` set the
buckets of `comm_bucket.BucketedExchanger`, each the concatenation of its
member tensors. The same encode (one grouped QSGD launch for every unit
it is given) and decode serve both; the bucketed exchange gathers each
bucket's contiguous slice of the buffer on its own.

The in-collective communicators reduce inside the collective instead
(`qar.py`: the int8 quantized allreduce; `sparse_rs.py`: the reduce-scatter
routes). Their branches compensate, flatten every tensor into one float32
vector in sorted name order (the JAX package's `ravel_pytree` order), run
the route over the group's `Collectives`, unflatten the mean and update the
residual with what this worker transmitted. They run in full at world size
1: the quantizers and selections are the function, not a transport detail.
Their Philox streams are `sparse.per_tensor_stream(seed, name, step,
worker)` under the route's fixed stream names (`qar.STREAM_PHASE1`,
`qar.STREAM_PHASE2`, `sparse_rs.STREAM_ADAPTIVE`,
`sparse_rs.STREAM_QUANTIZED`); `uniforms`, keyed by those names, replaces
them in the CPU parity tests.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from deepreduce_tpu_torch import costmodel, memory, qar, sparse_rs
from deepreduce_tpu_torch.collectives import Collectives, collectives_for
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats, combine
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.sparse import per_tensor_stream
from deepreduce_tpu_torch.wrappers import TensorCodec, encode_group

Tree = Dict[str, torch.Tensor]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PayloadLayout:
    """Static byte layout of one tensor's payload inside the fused buffer:
    each leaf's little-endian bytes, back to back (no checksum word)."""

    def __init__(self, specs: List[Tuple[Tuple[int, ...], torch.dtype]]):
        self.specs = [(tuple(s), dt) for s, dt in specs]
        self.leaf_bytes = [math.prod(s) * _itemsize(dt) for s, dt in self.specs]
        self.leaf_offsets = [sum(self.leaf_bytes[:i]) for i in range(len(self.leaf_bytes))]
        self.nbytes = int(sum(self.leaf_bytes))

    def pack(self, leaves) -> torch.Tensor:
        """payload leaves -> uint8[nbytes]."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=leaves[0].device)
        self.write_into(buf, leaves)
        return buf

    def write_into(self, dst: torch.Tensor, leaves, skip=()) -> None:
        """Copy the payload leaves into `dst` (uint8[nbytes]) at their
        offsets, leaving the leaves numbered in `skip` untouched."""
        for i, (leaf, off, nb) in enumerate(zip(leaves, self.leaf_offsets, self.leaf_bytes)):
            if nb and i not in skip:
                dst[off : off + nb].copy_(leaf.reshape(-1).contiguous().view(torch.uint8))

    def unpack(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """uint8[nbytes] -> payload leaves (inverse of pack)."""
        leaves = []
        for (shape, dt), off, nb in zip(self.specs, self.leaf_offsets, self.leaf_bytes):
            seg = buf[off : off + nb]
            if seg.storage_offset() % _itemsize(dt):
                seg = seg.clone()  # a dtype view needs an aligned start
            leaves.append(seg.view(dt).reshape(shape))
        return leaves


class FusedBuffer:
    """Named codec units (tensors, or the bucketed exchange's buckets) whose
    payloads sit back to back in one uint8 buffer, in the units' order."""

    def __init__(self, codecs: Dict[str, TensorCodec]):
        self.codecs = codecs
        self.units = list(codecs)
        self.layouts: Dict[str, PayloadLayout] = {}
        self.offsets: Dict[str, int] = {}
        nbytes = 0
        for u in self.units:
            self.layouts[u] = PayloadLayout(codecs[u].payload_specs())
            self.offsets[u] = nbytes
            nbytes += self.layouts[u].nbytes
        self.nbytes = nbytes

    def span(self, unit: str) -> slice:
        """The unit's bytes in the buffer."""
        lo = self.offsets[unit]
        return slice(lo, lo + self.layouts[unit].nbytes)

    def encode(
        self,
        tensors: Tree,
        buf: torch.Tensor,
        *,
        step: int,
        worker: int,
        uniforms: Optional[Tree] = None,
        units: Optional[List[str]] = None,
    ) -> Dict[str, WireStats]:
        """Write the payloads of `units` (default: all) of `tensors` (unit ->
        tensor) into their spans of `buf`; returns each unit's wire stats.
        `uniforms` (unit -> f32, CPU only) replaces the QSGD draws of the
        named units (the parity tests' hook)."""
        units = self.units if units is None else units
        group = []
        for u in units:
            r = self.codecs[u].rows_leaf
            rows_lo = self.offsets[u] + (0 if r is None else self.layouts[u].leaf_offsets[r])
            group.append((u, self.codecs[u], tensors[u], rows_lo))
        # every unit's index stage, then one grouped QSGD launch that writes
        # the rows straight into the buffer; the other leaves follow them
        payloads, _ = encode_group(group, buf, step=step, worker=worker, uniforms=uniforms)
        stats = {}
        for u in units:
            codec, layout, lo = self.codecs[u], self.layouts[u], self.offsets[u]
            skip = () if codec.rows_leaf is None else (codec.rows_leaf,)
            layout.write_into(buf[lo : lo + layout.nbytes], payloads[u].leaves(), skip=skip)
            stats[u] = codec.wire_stats(payloads[u])
        return stats

    @property
    def host_units(self) -> List[str]:
        """The units whose codec runs on the host."""
        return [u for u in self.units if self.codecs[u].host]

    def decode(
        self, unit: str, seg: torch.Tensor, *, step: int = 0, host_seg: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """One worker's bytes of `unit` -> its dense float32 tensor (`step`
        keys the bloom codec's random policies). `host_seg`: the same bytes
        on the host, which a host codec reads (copied here when None)."""
        codec, layout = self.codecs[unit], self.layouts[unit]
        payload = codec.payload_from_leaves(layout.unpack(seg))
        host_payload = None
        if codec.host:
            # one copy of the unit's bytes; the codec reads its leaves there
            host_seg = seg.cpu() if host_seg is None else host_seg
            host_payload = codec.payload_from_leaves(layout.unpack(host_seg))
        return codec.decode(payload, step=step, host_payload=host_payload).to(torch.float32)

    def decode_sum(
        self,
        unit: str,
        rows: torch.Tensor,
        own: Optional[int] = None,
        *,
        step: int = 0,
        host_rows: Optional[List[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(sum over the W rows of `unit`'s bytes [W, nbytes], the decode of
        row `own` or None). Rows are summed in worker order from zeros, as
        the JAX loop does. `host_rows`: the W rows' bytes on the host, for a
        host codec (each row copied here when None)."""
        total = torch.zeros(self.codecs[unit].shape, dtype=torch.float32, device=rows.device)
        own_dec = None
        for w in range(rows.shape[0]):
            dec = self.decode(unit, rows[w], step=step, host_seg=None if host_rows is None else host_rows[w])
            total = total + dec
            if w == own:
                own_dec = dec
        return total, own_dec


class GradientExchanger:
    """Per-tensor (or per-bucket) codecs plus the fused allgather exchange.

    `grads_like` maps parameter names to tensors (or shapes); names are
    processed in sorted order, as JAX flattens a dict. `group` is the
    process group of the data-parallel workers (a `torch.distributed`
    group or a `collectives.Collectives`); None means one worker."""

    def __init__(
        self,
        grads_like: Dict[str, object],
        cfg: DeepReduceConfig,
        *,
        device: DeviceLike = "cuda",
        group: Optional[Union[dist.ProcessGroup, Collectives]] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.coll = collectives_for(group)
        self.num_workers = self.coll.world_size
        self.rank = self.coll.rank
        self.names = sorted(grads_like)
        self.shapes = {n: tuple(getattr(grads_like[n], "shape", grads_like[n])) for n in self.names}
        self.d = sum(math.prod(s) for s in self.shapes.values())
        self.in_collective = cfg.communicator in ("qar", "sparse_rs")
        self.dense = not self.in_collective and (
            cfg.communicator == "allreduce" or (cfg.deepreduce is None and cfg.compressor == "none")
        )
        self.bucketed = None
        if cfg.bucket_bytes is not None:
            _check_bucketable(cfg)
            from deepreduce_tpu_torch.comm_bucket import BucketedExchanger

            self.bucketed = BucketedExchanger(self.shapes, cfg, device=self.device)
            self.fused = self.bucketed.fused
        else:
            # the in-collective routes compress the flat gradient themselves
            self.fused = FusedBuffer({} if self.in_collective else {
                n: TensorCodec(self.shapes[n], cfg, name=n, device=self.device) for n in self.names
            })
        # the codec units (tensor names, or bucket labels) and their layout
        self.codecs = self.fused.codecs
        self.layouts = self.fused.layouts
        self.offsets = self.fused.offsets
        self.fused_nbytes = self.fused.nbytes

    @property
    def num_buckets(self) -> int:
        """Bucket count of the bucketed exchange; 0 when unbucketed."""
        return 0 if self.bucketed is None else len(self.bucketed.specs)

    @property
    def bucket_specs(self):
        """The static `BucketSpec` partition (empty when unbucketed)."""
        return () if self.bucketed is None else self.bucketed.specs

    def init_state(self, grads_like: Tree) -> Optional[Tree]:
        if self.cfg.memory == "residual":
            return memory.init(grads_like)
        return None

    def payload_bytes(self) -> int:
        """Static per-worker wire bytes: the fused buffer's size (the sum of
        the bucket layouts when bucketed), the float32 gradients on the
        dense baseline, or what the in-collective route injects (the JAX
        package's `qar.wire_bits_per_worker` and `costmodel.rs_payload_bytes`)."""
        cfg = self.cfg
        if cfg.communicator == "qar":
            return int(qar.wire_bits_per_worker(self.d, self.num_workers, cfg.bucket_size) // 8)
        if cfg.communicator == "sparse_rs":
            return int(costmodel.rs_payload_bytes(
                cfg.rs_mode, self.d, self.num_workers, cfg.compress_ratio, headroom=cfg.rs_headroom,
                out_headroom=cfg.rs_out_headroom, block=cfg.rs_block_size, bins=cfg.rs_oktopk_bins,
                cap_headroom=cfg.rs_oktopk_cap_headroom,
            ))
        if self.dense:
            return 4 * self.d
        return self.fused_nbytes

    # -- 1. encode + pack ------------------------------------------------ #

    def compensate(self, grads: Tree, residuals: Optional[Tree]) -> Tree:
        if residuals is None:
            return grads
        return memory.compensate(grads, residuals, beta=self.cfg.beta, gamma=self.cfg.gamma)

    def units_of(self, tensors: Tree) -> Tree:
        """Tensor name -> tensor as unit -> tensor: the bucket super-tensors
        when bucketed, else the tensors themselves."""
        return tensors if self.bucketed is None else self.bucketed.concat_all(tensors)

    def encode_worker(
        self,
        grads: Tree,
        residuals: Optional[Tree],
        *,
        step: int,
        worker: int,
        uniforms: Optional[Tree] = None,
    ) -> Tuple[torch.Tensor, Tree, WireStats]:
        """(uint8[B] fused buffer, compensated grads, combined wire stats)
        of one worker. `uniforms` (unit -> f32, CPU only) replaces the QSGD
        draws of the named units (the parity tests' hook)."""
        compensated = self.compensate(grads, residuals)
        buf = torch.empty(self.fused_nbytes, dtype=torch.uint8, device=self.device)
        stats = self.fused.encode(self.units_of(compensated), buf, step=step, worker=worker, uniforms=uniforms)
        return buf, compensated, combine(stats)

    # -- 2. gather ------------------------------------------------------- #

    def gather(self, buf: torch.Tensor) -> torch.Tensor:
        """uint8[B] -> uint8[W, B], rows in rank order."""
        return self.coll.all_gather(buf)

    # -- 3. decode + aggregate ------------------------------------------- #

    def decode_row(self, row: torch.Tensor, *, step: int = 0) -> Tree:
        """One worker's uint8[B] buffer -> dense float32 tensors by name."""
        return self.to_tensors({u: self.fused.decode(u, row[self.fused.span(u)], step=step) for u in self.fused.units})

    def to_tensors(self, by_unit: Tree) -> Tree:
        """Unit -> dense float32 as tensor name -> tensor (the inverse of
        `units_of`)."""
        return by_unit if self.bucketed is None else self.bucketed.split_all(by_unit)

    def decode_aggregate(
        self, gathered: torch.Tensor, *, own: Optional[int] = None, step: int = 0
    ) -> Tuple[Tree, Optional[Tree]]:
        """(mean over the W rows, the decode of row `own` or None), by
        tensor name."""
        totals, owns = {}, {}
        # a host codec reads its leaves from one host copy of each row
        rows = [gathered[w].cpu() for w in range(gathered.shape[0])] if self.fused.host_units else None
        for u in self.fused.units:
            span = self.fused.span(u)
            host_rows = None if rows is None or not self.codecs[u].host else [r[span] for r in rows]
            totals[u], owns[u] = self.fused.decode_sum(u, gathered[:, span], own, step=step, host_rows=host_rows)
        return self.mean_and_own(totals, owns if own is not None else None, gathered.shape[0])

    def mean_and_own(self, totals: Tree, owns: Optional[Tree], num_workers: int) -> Tuple[Tree, Optional[Tree]]:
        """Unit sums and own decodes -> (the mean, the own decode) by tensor
        name; the mean multiplies by the float32 reciprocal of W, as XLA
        compiles the JAX package's `total / W`."""
        mean = self.to_tensors({u: mean_of_sum(t, num_workers) for u, t in totals.items()})
        return mean, None if owns is None else self.to_tensors(owns)

    def finish(
        self, grads: Tree, compensated: Tree, mean: Tree, own: Optional[Tree]
    ) -> Tuple[Tree, Optional[Tree]]:
        """(the aggregate in the gradients' dtypes, the new residuals or
        None): compensated minus this worker's own decode."""
        agg = {n: mean[n].to(grads[n].dtype) for n in self.names}
        if own is None:
            return agg, None
        return agg, memory.update(compensated, {n: own[n].to(grads[n].dtype) for n in self.names})

    # ------------------------------------------------------------------ #

    def exchange(
        self,
        grads: Tree,
        residuals: Optional[Tree],
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """(aggregated dense grads, new residuals, this worker's wire stats).
        `collect`, when a dict, receives the sparse_rs route's observables
        (see `sparse_rs.exchange`) or the bucketed exchange's per-bucket
        saturation flags (`bucket_saturated`)."""
        if self.in_collective:
            return self.exchange_in_collective(grads, residuals, step=step, uniforms=uniforms, collect=collect)
        if self.dense:
            return self.exchange_dense(grads), residuals, self.dense_wire_stats()
        own = self.rank if residuals is not None else None
        if self.bucketed is not None:
            compensated = self.compensate(grads, residuals)
            totals, owns, stats = self.bucketed.run(
                self.units_of(compensated), self.coll, step=step, worker=self.rank, own=own, uniforms=uniforms
            )
            if collect is not None:
                collect["bucket_saturated"] = self.bucketed.saturation_vector(stats)
            mean, own_dec = self.mean_and_own(totals, owns, self.num_workers)
            stats = combine(stats)
        else:
            buf, compensated, stats = self.encode_worker(grads, residuals, step=step, worker=self.rank,
                                                         uniforms=uniforms)
            mean, own_dec = self.decode_aggregate(self.gather(buf), own=own, step=step)
        agg, new_residuals = self.finish(grads, compensated, mean, own_dec)
        return agg, new_residuals, stats

    # -- the dense baseline ---------------------------------------------- #

    def exchange_dense(self, grads: Tree) -> Tree:
        """The mean over workers of the uncompressed gradients: one
        `all_reduce` of one flat float32 buffer, the identity at world size
        1 without a group."""
        if self.group is None:
            return dict(grads)
        flat = mean_of_sum(self.coll.all_reduce_sum(self._flatten(grads)), self.num_workers)
        return self._unflatten(flat, grads)

    # -- the in-collective communicators --------------------------------- #

    def _flatten(self, tree: Tree) -> torch.Tensor:
        """The tensors as one float32 vector, in sorted name order."""
        return torch.cat([tree[n].reshape(-1).to(torch.float32) for n in self.names])

    def _unflatten(self, flat: torch.Tensor, like: Tree) -> Tree:
        out, lo = {}, 0
        for n in self.names:
            g = like[n]
            out[n] = flat[lo : lo + g.numel()].view(g.shape).to(g.dtype)
            lo += g.numel()
        return out

    def stream(self, name: str, step: int) -> Tuple[int, int]:
        """This worker's Philox (seed, offset) of the stream `name` at `step`."""
        return per_tensor_stream(self.cfg.seed, name, step, self.rank)

    def exchange_in_collective(
        self,
        grads: Tree,
        residuals: Optional[Tree],
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """compensate -> flatten -> `route_flat` -> unflatten; the residual
        keeps what this worker did not transmit (qar keeps none)."""
        compensated = self.compensate(grads, residuals)
        mean, own, stats = self.route_flat(self._flatten(compensated), step=step, uniforms=uniforms, collect=collect)
        new_residuals = None
        if residuals is not None:
            new_residuals = memory.update(compensated, self._unflatten(own, grads))
        return self._unflatten(mean, grads), new_residuals, stats

    def route_flat(
        self,
        flat: torch.Tensor,
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], WireStats]:
        """(mean f32[d], own-transmitted f32[d] or None for qar, wire stats)
        of this worker's flat gradient through the configured route."""
        cfg = self.cfg
        if cfg.communicator == "qar":
            # the whole gradient through the int8 two-phase exchange
            n = qar.pad_len(self.d, self.num_workers, cfg.bucket_size)
            padded = torch.zeros(n, dtype=torch.float32, device=flat.device)
            padded[: self.d] = flat
            names = (qar.STREAM_PHASE1, qar.STREAM_PHASE2)
            mean = qar.quantized_allreduce(
                padded, self.coll, streams=[self.stream(s, step) for s in names], quantum_num=cfg.quantum_num,
                bucket_size=cfg.bucket_size, uniforms=None if uniforms is None else [uniforms[s] for s in names],
            )[: self.d]
            # one payload (levels + norms) against the dense float32
            # gradient: the JAX package's rel_volume convention for qar
            stats = WireStats.constant(0.0, n * 8 + (n // cfg.bucket_size) * 32, self.d * 32, flat.device)
            return mean, None, stats
        name = {"adaptive": sparse_rs.STREAM_ADAPTIVE, "quantized": sparse_rs.STREAM_QUANTIZED}.get(cfg.rs_mode)
        return sparse_rs.exchange(
            flat, self.coll, ratio=cfg.compress_ratio, rs_mode=cfg.rs_mode, headroom=cfg.rs_headroom,
            out_headroom=cfg.rs_out_headroom, block_size=cfg.rs_block_size,
            density_threshold=cfg.rs_density_threshold, oktopk_bins=cfg.rs_oktopk_bins,
            oktopk_cap_headroom=cfg.rs_oktopk_cap_headroom,
            stream=None if name is None else self.stream(name, step),
            uniforms=None if name is None or uniforms is None else uniforms[name],
            collect=collect,
        )

    def dense_wire_stats(self) -> WireStats:
        """No index stream; the value stream is the whole float32 tensor."""
        return WireStats.constant(0.0, 32 * self.d, 32 * self.d, self.device)


def _check_bucketable(cfg: DeepReduceConfig) -> None:
    """The exchanger-build fences of `bucket_bytes`, under the JAX package's
    reason codes (`deepreduce_tpu/comm.py`)."""
    if not (cfg.fused and cfg.communicator == "allgather"):
        raise ConfigError(
            "build-buckets-need-fused-allgather",
            "bucket_bytes partitions the fused allgather exchange and would be silently ignored here "
            f"(communicator={cfg.communicator!r}): use communicator='allgather', or bucket_bytes=None",
        )
    if cfg.layer_pattern is not None:
        raise ConfigError(
            "build-buckets-vs-layer-pattern",
            "layer_pattern excludes leaves by name from compression, but a bucket's one codec spans many "
            "leaves, so the pattern would be silently ignored: use layer_pattern=None with bucket_bytes, "
            "or per-tensor codecs with layer_pattern",
        )
    if cfg.deepreduce is None and cfg.compressor == "none":
        raise ConfigError(
            "build-buckets-need-compression",
            "bucket_bytes only affects the compressed allgather path; the dense baseline "
            "(deepreduce=None, compressor='none') would silently ignore it: set bucket_bytes=None",
        )
