"""Gradient exchange: compress -> one fused uint8 allgather -> decode ->
mean, ported from `deepreduce_tpu/comm.py` for `communicator='allgather'`
with the 'loop', 'vmap' and 'ring' decodes (`comm_ring.py`) and unfused
(`fused=False`: one all_gather per tensor); the bucketed exchange
(`bucket_bytes`, `comm_bucket.py`); the dense baseline; the in-collective
communicators `qar` and `sparse_rs` (whose `rs_mode='auto'` is resolved
here, once, by `costmodel.select_rs_mode`); and the resilience seams: a checksum
word after every payload (`PayloadLayout.seal` / `verify`), the chaos
injector at the wire boundary and the participation mask (`exchange`'s
`mask`). Without them configured the exchange runs exactly the ops it
runs without the subsystem.

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

from deepreduce_tpu_torch import costmodel, memory, qar, sparse_rs, u32
from deepreduce_tpu_torch.collectives import Collectives, collectives_for
from deepreduce_tpu_torch.comm_ring import ring_decode_exchange
from deepreduce_tpu_torch.config import ConfigError, DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats, combine, ring_wire_bytes
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.resilience.chaos import ChaosInjector
from deepreduce_tpu_torch.sparse import per_tensor_stream
from deepreduce_tpu_torch.telemetry.spans import span
from deepreduce_tpu_torch.wrappers import TensorCodec, encode_group

Tree = Dict[str, torch.Tensor]

CHECKSUM_WEIGHT = 2654435761  # the position weight's multiplier (Knuth's)
CHECKSUM_SALT = 0xA5A5A5A5  # makes an all-zero payload fail its zeroed word


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _checksum_weights(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 16-bit halves (int64 [n] each) of byte i's weight
    `(i * 2654435761 + 1) mod 2**32`."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    w = (u32.mul_lo(i, CHECKSUM_WEIGHT) + 1) & u32.MASK32
    return w & 0xFFFF, w >> 16


def checksum_word(body: torch.Tensor, weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The payload checksum of uint8 [..., n] bodies: int64 [...] words
    `(sum_i byte_i * (i * 2654435761 + 1)) mod 2**32 XOR 0xA5A5A5A5`, the
    JAX package's uint32 word (`PayloadLayout._checksum_word`). The weight
    is split into 16-bit halves so that each half-sum stays exact in int64
    up to 2**39 bytes; `weights` are the cached halves."""
    wl, wh = _checksum_weights(body.shape[-1], body.device) if weights is None else weights
    b = body.to(torch.int64)
    lo, hi = (b * wl).sum(-1), (b * wh).sum(-1)
    return ((lo + ((hi & 0xFFFF) << 16)) & u32.MASK32) ^ CHECKSUM_SALT


class PayloadLayout:
    """Static byte layout of one tensor's payload inside the fused buffer:
    each leaf's little-endian bytes, back to back, then with `checksum` a
    little-endian uint32 checksum word of those bytes (`checksum_word`)."""

    def __init__(self, specs: List[Tuple[Tuple[int, ...], torch.dtype]], *, checksum: bool = False):
        self.specs = [(tuple(s), dt) for s, dt in specs]
        self.leaf_bytes = [math.prod(s) * _itemsize(dt) for s, dt in self.specs]
        self.leaf_offsets = [sum(self.leaf_bytes[:i]) for i in range(len(self.leaf_bytes))]
        self.checksum = bool(checksum)
        self.payload_nbytes = int(sum(self.leaf_bytes))
        self.nbytes = self.payload_nbytes + (4 if self.checksum else 0)
        self._weights: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def weights(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The checksum's weight halves on `device`, made once."""
        device = torch.device(device)
        if device not in self._weights:
            self._weights[device] = _checksum_weights(self.payload_nbytes, device)
        return self._weights[device]

    def pack(self, leaves) -> torch.Tensor:
        """payload leaves -> uint8[nbytes]."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=leaves[0].device)
        self.write_into(buf, leaves)
        self.seal(buf)
        return buf

    def write_into(self, dst: torch.Tensor, leaves, skip=()) -> None:
        """Copy the payload leaves into `dst` (uint8[nbytes]) at their
        offsets, leaving the leaves numbered in `skip` untouched."""
        for i, (leaf, off, nb) in enumerate(zip(leaves, self.leaf_offsets, self.leaf_bytes)):
            if nb and i not in skip:
                dst[off : off + nb].copy_(leaf.reshape(-1).contiguous().view(torch.uint8))

    def seal(self, dst: torch.Tensor) -> None:
        """Write the checksum word of the payload bytes of `dst`
        (uint8[nbytes]) after them; nothing without `checksum`."""
        if self.checksum:
            word = checksum_word(dst[: self.payload_nbytes], self.weights(dst.device))
            dst[self.payload_nbytes :].copy_(u32.to_bits(word.reshape(1)).view(torch.uint8))

    def verify(self, rows: torch.Tensor) -> torch.Tensor:
        """f32 [...] gates of uint8 [..., nbytes] buffers: 1.0 where the
        stored word matches the payload bytes (or without `checksum`), else
        0.0. A caller selects the decode with the gate (`torch.where`),
        never multiplies by it: corrupt bytes can decode to Inf or NaN."""
        if not self.checksum:
            return torch.ones(rows.shape[:-1], dtype=torch.float32, device=rows.device)
        pn = self.payload_nbytes
        tail = rows[..., pn : pn + 4].to(torch.int64)
        stored = tail[..., 0] | (tail[..., 1] << 8) | (tail[..., 2] << 16) | (tail[..., 3] << 24)
        return (stored == checksum_word(rows[..., :pn], self.weights(rows.device))).to(torch.float32)

    def pack_rows(self, leaves) -> torch.Tensor:
        """B clients' payload leaves (each [B, ...]) -> uint8[B, nbytes],
        row c `pack` of client c's leaves: one concatenation, then the
        checksum words of all rows at once."""
        B = leaves[0].shape[0]
        parts = [leaf.reshape(B, -1).contiguous().view(torch.uint8) for leaf, nb in zip(leaves, self.leaf_bytes) if nb]
        if self.checksum:
            body = torch.cat(parts, dim=1)
            word = checksum_word(body, self.weights(body.device))
            parts = [body, u32.to_bits(word.reshape(B, 1)).view(torch.uint8)]
        return torch.cat(parts, dim=1)

    def unpack_rows(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """uint8[B, nbytes] -> payload leaves, each [B, ...] (inverse of
        `pack_rows`)."""
        B = rows.shape[0]
        return [
            rows[:, off : off + nb].contiguous().view(dt).reshape((B,) + shape)
            for (shape, dt), off, nb in zip(self.specs, self.leaf_offsets, self.leaf_bytes)
        ]

    def unpack(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """uint8[nbytes] -> payload leaves (inverse of pack; the checksum
        word is not read)."""
        leaves = []
        for (shape, dt), off, nb in zip(self.specs, self.leaf_offsets, self.leaf_bytes):
            seg = buf[off : off + nb]
            if seg.storage_offset() % _itemsize(dt):
                seg = seg.clone()  # a dtype view needs an aligned start
            leaves.append(seg.view(dt).reshape(shape))
        return leaves


def _sum_rows(parts) -> torch.Tensor:
    """parts[0] + parts[1] + ..., left to right from zero: the JAX
    package's in-order sum of a group's rows."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


class FusedBuffer:
    """Named codec units (tensors, or the bucketed exchange's buckets) whose
    payloads sit back to back in one uint8 buffer, in the units' order;
    with `checksum` each payload is followed by its checksum word."""

    def __init__(self, codecs: Dict[str, TensorCodec], *, checksum: bool = False):
        self.codecs = codecs
        self.units = list(codecs)
        self.checksum = bool(checksum)
        self.layouts: Dict[str, PayloadLayout] = {}
        self.offsets: Dict[str, int] = {}
        nbytes = 0
        for u in self.units:
            self.layouts[u] = PayloadLayout(codecs[u].payload_specs(), checksum=checksum)
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
        payloads_out: Optional[dict] = None,
        route: str = "fused",
    ) -> Dict[str, WireStats]:
        """Write the payloads of `units` (default: all) of `tensors` (unit ->
        tensor) into their spans of `buf`, each sealed with its checksum
        word; returns each unit's wire stats. `uniforms` (unit -> f32, CPU
        only) replaces the QSGD draws of the named units (the parity tests'
        hook); `payloads_out`, when a dict, receives the payloads by unit
        (for `fp_totals`); `route` labels the telemetry spans."""
        units = self.units if units is None else units
        group = []
        for u in units:
            r = self.codecs[u].rows_leaf
            rows_lo = self.offsets[u] + (0 if r is None else self.layouts[u].leaf_offsets[r])
            group.append((u, self.codecs[u], tensors[u], rows_lo))
        # every unit's index stage, then one grouped QSGD launch that writes
        # the rows straight into the buffer; the other leaves follow them
        with span("exchange/encode", route=route):
            payloads, _ = encode_group(group, buf, step=step, worker=worker, uniforms=uniforms)
        stats = {}
        with span("exchange/pack", route=route):
            for u in units:
                codec, layout, lo = self.codecs[u], self.layouts[u], self.offsets[u]
                skip = () if codec.rows_leaf is None else (codec.rows_leaf,)
                layout.write_into(buf[lo : lo + layout.nbytes], payloads[u].leaves(), skip=skip)
                layout.seal(buf[lo : lo + layout.nbytes])
                stats[u] = codec.wire_stats(payloads[u])
        if payloads_out is not None:
            payloads_out.update(payloads)
        return stats

    def fp_totals(self, payloads: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The measured bloom false positives over the units' payloads and
        their not-selected universe (0-d float32, summed in unit order from
        zero, as the JAX package sums them; zeros without a bloom index)."""
        fp_c = fp_u = torch.zeros((), dtype=torch.float32, device=device)
        for u, codec in self.codecs.items():
            stats = codec.fp_stats(payloads[u])
            if stats is None:
                continue
            fp_c = fp_c + stats[0]
            fp_u = fp_u + stats[1]
        return fp_c, fp_u

    @property
    def host_units(self) -> List[str]:
        """The units whose codec runs on the host."""
        return [u for u in self.units if self.codecs[u].host]

    def verify(self, rows: torch.Tensor) -> torch.Tensor:
        """f32 [R, U] checksum gates of whole-buffer rows uint8 [R, B], one
        batched reduction over the R rows per unit."""
        return torch.stack([self.layouts[u].verify(rows[:, self.span(u)]) for u in self.units], dim=1)

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

    def decode_rows(
        self, unit: str, rows: torch.Tensor, *, step: int = 0, host_rows: Optional[List[torch.Tensor]] = None
    ) -> torch.Tensor:
        """The decodes of a group of rows of `unit`'s bytes [g, nbytes] ->
        f32 [g, *shape]: in one call where the codec's decode batches
        (`TensorCodec.decode_batches`), else row by row, stacked."""
        codec, layout = self.codecs[unit], self.layouts[unit]
        if codec.decode_batches:
            (shape, dt), = layout.specs
            raw = rows[:, : layout.payload_nbytes].contiguous()
            return raw.view(dt).reshape((rows.shape[0],) + codec.shape).to(torch.float32)
        return torch.stack([
            self.decode(unit, rows[w], step=step, host_seg=None if host_rows is None else host_rows[w])
            for w in range(rows.shape[0])
        ])

    def decode_sum(
        self,
        unit: str,
        rows: torch.Tensor,
        own: Optional[int] = None,
        *,
        step: int = 0,
        host_rows: Optional[List[torch.Tensor]] = None,
        weights: Optional[torch.Tensor] = None,
        gates: Optional[torch.Tensor] = None,
        batch: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(sum over the W rows of `unit`'s bytes [W, nbytes], the decode of
        row `own` or None). `gates` (f32[W], the checksum's) select each
        row's decode or an exact zero; `weights` (f32[W], the participation
        mask) then scale it, before both the sum and the own pick. A row
        that fails its checksum is decoded from zero bytes, not from its
        own: the decoders index with the payload's indices, and an index
        out of range, which XLA drops, is a fault on the card; the gate
        then selects zero, as in the JAX package.

        Without `batch` (the 'loop' strategy) the rows are summed in worker
        order from zeros. With `batch` (the 'vmap' strategy) they are
        decoded in groups of `batch`, each group summed in order from zeros
        and then added to the accumulator, the JAX package's structure.
        `host_rows`: the W rows' bytes on the host, for a host codec (each
        row copied here when None)."""
        W = rows.shape[0]
        if gates is not None:
            rows = torch.where(gates[:, None] > 0.5, rows, 0)
        total = torch.zeros(self.codecs[unit].shape, dtype=torch.float32, device=rows.device)
        own_dec = None
        G = 1 if batch is None else max(1, min(int(batch), W))
        for g0 in range(0, W, G):
            g1 = min(g0 + G, W)
            hosts = None if host_rows is None else host_rows[g0:g1]
            if batch is None:
                decs = [self.decode(unit, rows[g0], step=step, host_seg=None if hosts is None else hosts[0])]
            else:
                decs = list(self.decode_rows(unit, rows[g0:g1], step=step, host_rows=hosts))
            for i, w in enumerate(range(g0, g1)):
                if gates is not None:
                    decs[i] = torch.where(gates[w] > 0.5, decs[i], 0.0)
                if weights is not None:
                    decs[i] = decs[i] * weights[w]
                if w == own:
                    own_dec = decs[i]
            total = total + (decs[0] if batch is None else _sum_rows(decs))
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
        profile: Optional[costmodel.MachineProfile] = None,
        bucket_points=None,
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
        # the sparse_rs route, resolved once: 'auto' takes the cost model's
        # argmin (`costmodel.select_rs_mode`) over the static W, priced with
        # `profile` (or the profile file `cfg.profile`) where one is given
        if profile is None and cfg.profile is not None:
            profile = costmodel.load_profile(cfg.profile)
        self.profile = profile
        self._rs_mode = cfg.rs_mode
        if cfg.communicator == "sparse_rs" and cfg.rs_mode == "auto":
            if group is None:
                raise ConfigError(
                    "build-rs-auto-needs-workers",
                    "rs_mode='auto' resolves against the W-aware cost model at construction and needs the static "
                    "group size: construct GradientExchanger(..., group=...) (a one-rank group for one worker)",
                )
            self._rs_mode = costmodel.select_rs_mode(
                self.d, self.num_workers, cfg.compress_ratio, headroom=cfg.rs_headroom,
                out_headroom=cfg.rs_out_headroom, block=cfg.rs_block_size, rows=cfg.rs_sketch_rows,
                cols=cfg.rs_sketch_cols, bins=cfg.rs_oktopk_bins, cap_headroom=cfg.rs_oktopk_cap_headroom,
                profile=profile,
                # under resilience only the routes a deputy can re-own
                modes=("sparse", "quantized", "oktopk") if cfg.resilience else None,
            )
        self.in_collective = cfg.communicator in ("qar", "sparse_rs")
        self.dense = not self.in_collective and (
            cfg.communicator == "allreduce" or (cfg.deepreduce is None and cfg.compressor == "none")
        )
        # the resilience seams: None / False unless configured, so that the
        # resilience-off exchange runs exactly the ops it ran without them
        self.chaos = ChaosInjector.from_config(cfg)
        self.checksum = bool(cfg.payload_checksum)
        fused_allgather = cfg.fused and cfg.communicator == "allgather"
        # the bucket fences and the codecs first, then the decode strategy's
        # fence: the JAX package's order, so that a config both refuse gets
        # one reason code
        self.bucketed = None
        if cfg.bucket_bytes is not None:
            from deepreduce_tpu_torch.comm_bucket import BucketedExchanger

            _check_bucketable(cfg)
            self.bucketed = BucketedExchanger(self.shapes, cfg, device=self.device, points=bucket_points)
            self.fused = self.bucketed.fused
        else:
            if bucket_points is not None:
                raise ConfigError(
                    "build-bucket-points-need-buckets",
                    "bucket_points is the adaptive controller's per-bucket (ratio, fpr) vector for the bucketed "
                    "exchange and would be silently ignored without bucket_bytes — set bucket_bytes, or "
                    "bucket_points=None",
                )
            # the in-collective routes compress the flat gradient themselves
            self.fused = FusedBuffer({} if self.in_collective else {
                n: TensorCodec(self.shapes[n], cfg, name=n, device=self.device) for n in self.names
            }, checksum=self.checksum and fused_allgather)
        if cfg.decode_strategy != "loop" and not fused_allgather:
            raise ConfigError(
                "build-decode-strategy-needs-fused-allgather",
                f"decode_strategy={cfg.decode_strategy!r} restructures the fused allgather decode and would be "
                f"silently ignored here (communicator={cfg.communicator!r}, fused={cfg.fused}): use fused=True "
                "with communicator='allgather', or decode_strategy='loop'",
            )
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
        """Static per-worker wire bytes: the fused buffer's size (checksum
        words included; the sum of the bucket layouts when bucketed, of the
        per-tensor payloads when unfused), (W - 1) times it for the ring,
        the float32 gradients on the dense baseline, or what the
        in-collective route injects (the JAX package's
        `qar.wire_bits_per_worker` and `costmodel.rs_payload_bytes`)."""
        cfg = self.cfg
        if cfg.communicator == "qar":
            return int(qar.wire_bits_per_worker(self.d, self.num_workers, cfg.bucket_size) // 8)
        if cfg.communicator == "sparse_rs":
            return int(costmodel.rs_payload_bytes(
                self._rs_mode, self.d, self.num_workers, cfg.compress_ratio, headroom=cfg.rs_headroom,
                out_headroom=cfg.rs_out_headroom, block=cfg.rs_block_size, rows=cfg.rs_sketch_rows,
                cols=cfg.rs_sketch_cols, bins=cfg.rs_oktopk_bins, cap_headroom=cfg.rs_oktopk_cap_headroom,
                masked=cfg.resilience,
            ))
        if self.dense:
            return 4 * self.d
        if cfg.decode_strategy == "ring":
            return ring_wire_bytes(self.fused_nbytes, self.num_workers)
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
        payloads_out: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, Tree, WireStats]:
        """(uint8[B] fused buffer, compensated grads, combined wire stats)
        of one worker, each payload sealed with its checksum word when the
        checksum is on. `uniforms` (unit -> f32, CPU only) replaces the
        QSGD draws of the named units (the parity tests' hook);
        `payloads_out` receives the payloads by unit."""
        compensated = self.compensate(grads, residuals)
        buf = torch.empty(self.fused_nbytes, dtype=torch.uint8, device=self.device)
        stats = self.fused.encode(self.units_of(compensated), buf, step=step, worker=worker, uniforms=uniforms,
                                  payloads_out=payloads_out)
        return buf, compensated, combine(stats)

    def perturb(self, buf: torch.Tensor, *, step: int, salt: int = 0, draws: Optional[dict] = None) -> torch.Tensor:
        """The wire boundary: this worker's packed buffer as the chaos
        injector delivers it (itself without chaos)."""
        if self.chaos is None:
            return buf
        with span("resilience/chaos"):
            return self.chaos.perturb(buf, step=step, worker=self.rank, salt=salt, draws=draws)

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

    def decode_totals(
        self,
        gathered: torch.Tensor,
        *,
        own: Optional[int] = None,
        step: int = 0,
        weights: Optional[torch.Tensor] = None,
    ) -> Tuple[Tree, Tree, Optional[torch.Tensor]]:
        """(unit -> sum over the W rows, unit -> decode of row `own`, the
        checksum failures over the rows or None) of the gathered [W, B]
        buffer, in the configured strategy ('loop' or 'vmap'). With the
        checksum, every row of every unit is verified in one batched
        reduction a unit; a row that fails decodes to zeros, and a row
        weighted 0 counts no failure."""
        totals, owns = {}, {}
        gates = self.fused.verify(gathered) if self.checksum else None
        batch = self.cfg.decode_batch if self.cfg.decode_strategy == "vmap" else None
        # a host codec reads its leaves from one host copy of each row
        rows = [gathered[w].cpu() for w in range(gathered.shape[0])] if self.fused.host_units else None
        for i, u in enumerate(self.fused.units):
            span = self.fused.span(u)
            host_rows = None if rows is None or not self.codecs[u].host else [r[span] for r in rows]
            totals[u], owns[u] = self.fused.decode_sum(
                u, gathered[:, span], own, step=step, host_rows=host_rows, weights=weights,
                gates=None if gates is None else gates[:, i], batch=batch,
            )
        fails = None
        if gates is not None:
            per_row = (1.0 - gates).sum(1)
            fails = (per_row if weights is None else per_row * weights).sum()
        return totals, owns, fails

    def decode_aggregate(
        self, gathered: torch.Tensor, *, own: Optional[int] = None, step: int = 0
    ) -> Tuple[Tree, Optional[Tree]]:
        """(mean over the W rows, the decode of row `own` or None), by
        tensor name."""
        totals, owns, _ = self.decode_totals(gathered, own=own, step=step)
        return self.mean_and_own(totals, owns if own is not None else None, gathered.shape[0])

    def decode_fused_row(self, row: torch.Tensor, *, step: int = 0) -> Tuple[torch.Tensor, ...]:
        """One worker's uint8[B] buffer -> the f32 decodes of every unit in
        order, then with the checksum the row's failure count: the ring's
        decode (a failed unit decodes to zeros)."""
        gates = self.fused.verify(row[None])[0] if self.checksum else None
        out = []
        for i, u in enumerate(self.fused.units):
            seg = row[self.fused.span(u)]
            if gates is None:
                out.append(self.fused.decode(u, seg, step=step))
            else:  # a failed payload decodes from zero bytes (`FusedBuffer.decode_sum`)
                dec = self.fused.decode(u, torch.where(gates[i] > 0.5, seg, 0), step=step)
                out.append(torch.where(gates[i] > 0.5, dec, 0.0))
        if gates is not None:
            out.append((1.0 - gates).sum())
        return tuple(out)

    def mean_and_own(
        self, totals: Tree, owns: Optional[Tree], num_workers: int, denom: Optional[torch.Tensor] = None
    ) -> Tuple[Tree, Optional[Tree]]:
        """Unit sums and own decodes -> (the mean, the own decode) by tensor
        name; the mean multiplies by the float32 reciprocal of W, as XLA
        compiles the JAX package's `total / W`, or under a participation
        mask divides by the live count `denom` (a 0-d f32 tensor on the
        device: an IEEE divide, as JAX divides by a traced count)."""
        mean = {u: mean_of_sum(t, num_workers) if denom is None else t / denom for u, t in totals.items()}
        return self.to_tensors(mean), None if owns is None else self.to_tensors(owns)

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
        mask: Optional[torch.Tensor] = None,
        chaos_draws: Optional[Dict[int, dict]] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """(aggregated dense grads, new residuals, this worker's wire stats).

        `collect`, when a dict, receives the telemetry observables as device
        tensors: this worker's measured bloom false positives and their
        universe (`fp_count`, `fp_universe`; zeros where no payload has a
        bloom index), the sparse_rs route's observables (see
        `sparse_rs.exchange`), the bucketed exchange's per-bucket saturation
        flags (`bucket_saturated`) and, with the checksum, the failures over
        the gathered rows (`checksum_failures`). The false positives cost a
        query of every bloom filter over its universe: pass `collect` only
        with telemetry on. `mask` (bool[W] on the device, the same on every worker) is
        the participation mask: a False worker's decode is weighted 0 in
        the sum and in its own decode (so its residual keeps its whole
        compensated gradient) and the mean divides by the live count.
        `chaos_draws` (salt -> draws, CPU only) replaces the chaos
        injector's draws (the parity tests' hook; the salt is the bucket
        index, 0 unbucketed)."""
        cfg = self.cfg
        if mask is not None and cfg.communicator == "qar":
            raise ValueError(
                "participation masks renormalize the decode-side mean of the allgather and allreduce paths "
                "and re-own reduce-scatter shards on the sparse_rs routes; communicator='qar' sums every "
                "worker's int8 levels in one reduce-scatter with no per-worker decode row to zero: use "
                "communicator='allgather', 'allreduce' or 'sparse_rs'"
            )
        weights = denom = None
        if mask is not None:
            weights = mask.to(torch.float32)
            denom = torch.clamp(weights.sum(), min=1.0)
        if collect is not None:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            collect.setdefault("fp_count", zero)
            collect.setdefault("fp_universe", zero)
            if self.checksum:
                collect.setdefault("checksum_failures", zero)
        if self.in_collective:
            return self.exchange_in_collective(grads, residuals, step=step, uniforms=uniforms, collect=collect,
                                               mask=mask)
        if self.dense:
            return self.exchange_dense(grads, weights, denom), residuals, self.dense_wire_stats()
        own = self.rank if residuals is not None else None
        draws = chaos_draws or {}
        payloads = {} if collect is not None else None
        if self.bucketed is not None:
            compensated = self.compensate(grads, residuals)
            totals, owns, stats, fails = self.bucketed.run(
                self.units_of(compensated), self.coll, step=step, worker=self.rank, own=own, uniforms=uniforms,
                weights=weights, perturb=lambda buf, b: self.perturb(buf, step=step, salt=b, draws=draws.get(b)),
                payloads_out=payloads,
            )
            if collect is not None:
                collect["bucket_saturated"] = self.bucketed.saturation_vector(stats)
            stats = combine(stats)
        else:
            buf, compensated, stats = self.encode_worker(grads, residuals, step=step, worker=self.rank,
                                                         uniforms=uniforms, payloads_out=payloads)
            if not cfg.fused:
                totals, owns, fails = self._exchange_per_tensor(buf, own, step=step, weights=weights)
            else:
                buf = self.perturb(buf, step=step, draws=draws.get(0))
                if cfg.decode_strategy == "ring":
                    totals, owns, fails = self._exchange_ring(buf, own is not None, step=step, weights=weights)
                else:
                    with span("exchange/allgather", route="fused"):
                        gathered = self.gather(buf)
                    with span("exchange/decode", route="fused"):
                        totals, owns, fails = self.decode_totals(gathered, own=own, step=step, weights=weights)
        if collect is not None:
            collect["fp_count"], collect["fp_universe"] = self.fused.fp_totals(payloads, self.device)
            if fails is not None:
                collect["checksum_failures"] = fails
        mean, own_dec = self.mean_and_own(totals, owns if own is not None else None, self.num_workers, denom)
        agg, new_residuals = self.finish(grads, compensated, mean, own_dec)
        return agg, new_residuals, stats

    def _exchange_ring(
        self, buf: torch.Tensor, need_own: bool, *, step: int, weights: Optional[torch.Tensor]
    ) -> Tuple[Tree, Tree, Optional[torch.Tensor]]:
        """The ring decode (`comm_ring.py`) of the fused buffer: (unit ->
        sum, unit -> own decode, the checksum failures or None)."""
        with span("exchange/ring"):
            total, own = ring_decode_exchange(buf, lambda row: self.decode_fused_row(row, step=step), self.coll,
                                              need_own=need_own, row_weights=weights)
        units = self.fused.units
        fails = total[len(units)] if self.checksum else None
        return dict(zip(units, total)), dict(zip(units, own or ())), fails

    def _exchange_per_tensor(
        self, buf: torch.Tensor, own: Optional[int], *, step: int, weights: Optional[torch.Tensor]
    ) -> Tuple[Tree, Tree, None]:
        """The unfused exchange (`fused=False`, the reference's shape): one
        all_gather per tensor of its payload's bytes, its rows decoded in
        worker order; this worker's own decode from its own payload,
        outside the loop."""
        totals, owns = {}, {}
        for u in self.fused.units:
            span = self.fused.span(u)
            totals[u], _ = self.fused.decode_sum(u, self.coll.all_gather(buf[span]), step=step, weights=weights)
            if own is not None:
                dec = self.fused.decode(u, buf[span], step=step)
                owns[u] = dec if weights is None else dec * weights[self.rank]
        return totals, owns, None

    # -- the dense baseline ---------------------------------------------- #

    def exchange_dense(
        self, grads: Tree, weights: Optional[torch.Tensor] = None, denom: Optional[torch.Tensor] = None
    ) -> Tree:
        """The mean over workers of the uncompressed gradients: one
        `all_reduce` of one flat float32 buffer, the identity at world size
        1 without a group. Under a participation mask (`weights`, `denom`)
        each worker's gradient is weighted before the sum, which divides by
        the live count."""
        if weights is not None:
            flat = self.coll.all_reduce_sum(self._flatten(grads) * weights[self.rank]) / denom
            return self._unflatten(flat, grads)
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
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """compensate -> flatten -> `route_flat` -> unflatten; the residual
        keeps what this worker did not transmit (qar keeps none)."""
        qar_route = self.cfg.communicator == "qar"
        route = "qar" if qar_route else self._rs_mode
        with span("exchange/encode", route=route):
            compensated = self.compensate(grads, residuals)
            flat = self._flatten(compensated)
        with span("exchange/qar" if qar_route else "exchange/sparse_rs"):
            mean, own, stats = self.route_flat(flat, step=step, uniforms=uniforms, collect=collect, mask=mask)
        with span("exchange/decode", route=route):
            new_residuals = None
            if residuals is not None:
                new_residuals = memory.update(compensated, self._unflatten(own, grads))
            agg = self._unflatten(mean, grads)
        return agg, new_residuals, stats

    def route_flat(
        self,
        flat: torch.Tensor,
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], WireStats]:
        """(mean f32[d], own-transmitted f32[d] or None for qar, wire stats)
        of this worker's flat gradient through the configured route; `mask`
        selects the sparse_rs route's participation-mask variant."""
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
        name = {"adaptive": sparse_rs.STREAM_ADAPTIVE, "quantized": sparse_rs.STREAM_QUANTIZED}.get(self._rs_mode)
        return sparse_rs.exchange(
            flat, self.coll, ratio=cfg.compress_ratio, approx_topk=cfg.approx_topk, rs_mode=self._rs_mode,
            headroom=cfg.rs_headroom, out_headroom=cfg.rs_out_headroom, block_size=cfg.rs_block_size,
            density_threshold=cfg.rs_density_threshold, sketch_rows=cfg.rs_sketch_rows,
            sketch_cols=cfg.rs_sketch_cols, sketch_seed=cfg.seed, oktopk_bins=cfg.rs_oktopk_bins,
            oktopk_cap_headroom=cfg.rs_oktopk_cap_headroom,
            stream=None if name is None else self.stream(name, step),
            uniforms=None if name is None or uniforms is None else uniforms[name],
            collect=collect, mask=mask,
        )

    def dense_wire_stats(self) -> WireStats:
        """No index stream; the value stream is the whole float32 tensor."""
        return WireStats.constant(0.0, 32 * self.d, 32 * self.d, self.device)


def _check_bucketable(cfg: DeepReduceConfig) -> None:
    """The exchanger-build fences of `bucket_bytes`, under the JAX package's
    reason codes and in its order (`deepreduce_tpu/comm.py`)."""
    if not (cfg.fused and cfg.communicator == "allgather"):
        raise ConfigError(
            "build-buckets-need-fused-allgather",
            "bucket_bytes partitions the fused allgather exchange and would be silently ignored here "
            f"(communicator={cfg.communicator!r}, fused={cfg.fused}): use fused=True with "
            "communicator='allgather', or bucket_bytes=None",
        )
    if cfg.decode_strategy == "ring":
        raise ConfigError(
            "build-buckets-vs-ring",
            "decode_strategy='ring' already pipelines the transfer against the decode over its hops; with "
            "bucket_bytes the two pipelines would nest and the bucketing would be silently ignored: use "
            "decode_strategy='loop' or 'vmap' with bucket_bytes, or the ring without it",
        )
    if cfg.deepreduce is None and cfg.compressor == "none":
        raise ConfigError(
            "build-buckets-need-compression",
            "bucket_bytes only affects the compressed allgather path; the dense baseline "
            "(deepreduce=None, compressor='none') would silently ignore it: set bucket_bytes=None",
        )
    if cfg.layer_pattern is not None:
        raise ConfigError(
            "build-buckets-vs-layer-pattern",
            "layer_pattern excludes leaves by name from compression, but a bucket's one codec spans many "
            "leaves, so the pattern would be silently ignored: use layer_pattern=None with bucket_bytes, "
            "or per-tensor codecs with layer_pattern",
        )
