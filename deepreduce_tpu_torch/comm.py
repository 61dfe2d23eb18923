"""Gradient exchange: compress -> one fused uint8 allgather -> decode ->
mean, ported from `deepreduce_tpu/comm.py` for `communicator='allgather'`,
`fused=True` and `decode_strategy='loop'`; and the dense baseline.

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
2. `gather`: `dist.all_gather_into_tensor` over the process group into
   [W, B], or the identity at world size 1 without a group;
3. `decode_aggregate`: decode every row in worker order into one running
   sum per tensor, keep this worker's own row for the residual, divide by W.

Tests drive 1 and 3 for W virtual workers in one process.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from deepreduce_tpu_torch import memory
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats, combine
from deepreduce_tpu_torch.ops import qsgd_encode_rows
from deepreduce_tpu_torch.wrappers import TensorCodec

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


class GradientExchanger:
    """Per-tensor codecs plus the fused allgather exchange.

    `grads_like` maps parameter names to tensors (or shapes); names are
    processed in sorted order, as JAX flattens a dict. `group` is the
    process group of the data-parallel workers; None means one worker."""

    def __init__(
        self,
        grads_like: Dict[str, object],
        cfg: DeepReduceConfig,
        *,
        device: DeviceLike = "cuda",
        group: Optional[dist.ProcessGroup] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.num_workers = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.names = sorted(grads_like)
        shapes = {n: tuple(getattr(grads_like[n], "shape", grads_like[n])) for n in self.names}
        self.dense = cfg.communicator == "allreduce" or (cfg.deepreduce is None and cfg.compressor == "none")
        self.codecs = {
            n: TensorCodec(shapes[n], cfg, name=n, device=self.device) for n in self.names
        }
        self.layouts: Dict[str, PayloadLayout] = {}
        self.offsets: Dict[str, int] = {}
        nbytes = 0
        for n in self.names:
            self.layouts[n] = PayloadLayout(self.codecs[n].payload_specs())
            self.offsets[n] = nbytes
            nbytes += self.layouts[n].nbytes
        self.fused_nbytes = nbytes

    def init_state(self, grads_like: Tree) -> Optional[Tree]:
        if self.cfg.memory == "residual":
            return memory.init(grads_like)
        return None

    def payload_bytes(self) -> int:
        """Static per-worker wire bytes: the fused buffer's size, or the
        float32 gradients on the dense baseline."""
        if self.dense:
            return sum(4 * c.d for c in self.codecs.values())
        return self.fused_nbytes

    # -- 1. encode + pack ------------------------------------------------ #

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
        of one worker. `uniforms` (name -> f32, CPU only) replaces the QSGD
        draws of the named tensors (the parity tests' hook)."""
        cfg = self.cfg
        compensated = grads
        if residuals is not None:
            compensated = memory.compensate(grads, residuals, beta=cfg.beta, gamma=cfg.gamma)
        buf = torch.empty(self.fused_nbytes, dtype=torch.uint8, device=self.device)
        segments, stats = [], {}
        # (a) every tensor's index stage (and a reordering value codec's
        # value stage); its leaves go straight into the buffer
        for n in self.names:
            codec, layout, lo = self.codecs[n], self.layouts[n], self.offsets[n]
            payload = codec.encode_index(compensated[n])
            skip = ()
            r = codec.rows_leaf
            if codec.val_codec is not None and r is None:
                payload = codec.encode_values(payload)
            elif r is not None:
                rows_lo = lo + layout.leaf_offsets[r]
                u = None if uniforms is None else uniforms.get(n)
                segments.append(codec.value_segment(payload, rows_lo, step=step, worker=worker, uniforms=u))
                rows = buf[rows_lo : rows_lo + layout.leaf_bytes[r]].view(torch.int8)
                payload = codec.both_payload(payload, rows)
                skip = (r,)
            layout.write_into(buf[lo : lo + layout.nbytes], payload.leaves(), skip=skip)
            stats[n] = codec.wire_stats(payload)
        # (b) the QSGD value stage of every compressed tensor: one grouped launch
        if segments:
            qsgd_encode_rows(
                segments, buf, quantum_num=cfg.quantum_num, bucket_size=cfg.bucket_size, device=self.device
            )
        return buf, compensated, combine(stats)

    # -- 2. gather ------------------------------------------------------- #

    def gather(self, buf: torch.Tensor) -> torch.Tensor:
        """uint8[B] -> uint8[W, B], rows in rank order."""
        if self.group is None:
            return buf[None]
        out = torch.empty(self.num_workers * buf.numel(), dtype=torch.uint8, device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out.view(self.num_workers, -1)

    # -- 3. decode + aggregate ------------------------------------------- #

    def decode_row(self, row: torch.Tensor) -> Tree:
        """One worker's uint8[B] buffer -> dense float32 tensors."""
        out = {}
        for n in self.names:
            layout = self.layouts[n]
            lo = self.offsets[n]
            leaves = layout.unpack(row[lo : lo + layout.nbytes])
            payload = self.codecs[n].payload_from_leaves(leaves)
            out[n] = self.codecs[n].decode(payload).to(torch.float32)
        return out

    def decode_aggregate(
        self, gathered: torch.Tensor, *, own: Optional[int] = None
    ) -> Tuple[Tree, Optional[Tree]]:
        """(mean over the W rows, the decode of row `own` or None). Rows
        are summed in worker order from zeros, as the JAX loop does."""
        total = {n: torch.zeros(self.codecs[n].shape, dtype=torch.float32, device=gathered.device) for n in self.names}
        own_dec = None
        for w in range(gathered.shape[0]):
            dec = self.decode_row(gathered[w])
            for n in self.names:
                total[n] += dec[n]
            if w == own:
                own_dec = dec
        num_workers = gathered.shape[0]
        return {n: t / num_workers for n, t in total.items()}, own_dec

    # ------------------------------------------------------------------ #

    def exchange(
        self,
        grads: Tree,
        residuals: Optional[Tree],
        *,
        step: int,
        uniforms: Optional[Tree] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """(aggregated dense grads, new residuals, this worker's wire stats)."""
        if self.dense:
            return self.exchange_dense(grads), residuals, self.dense_wire_stats()
        buf, compensated, stats = self.encode_worker(
            grads, residuals, step=step, worker=self.rank, uniforms=uniforms
        )
        gathered = self.gather(buf)
        agg, own = self.decode_aggregate(gathered, own=self.rank if residuals is not None else None)
        agg = {n: agg[n].to(grads[n].dtype) for n in self.names}
        new_residuals = None
        if residuals is not None:
            own = {n: own[n].to(grads[n].dtype) for n in self.names}
            new_residuals = memory.update(compensated, own)
        return agg, new_residuals, stats

    # -- the dense baseline ---------------------------------------------- #

    def exchange_dense(self, grads: Tree) -> Tree:
        """The mean over workers of the uncompressed gradients: one
        `all_reduce` of one flat float32 buffer, the identity at world size
        1 without a group."""
        if self.group is None:
            return dict(grads)
        flat = torch.cat([grads[n].reshape(-1).to(torch.float32) for n in self.names])
        dist.all_reduce(flat, group=self.group)
        flat /= self.num_workers
        out, lo = {}, 0
        for n in self.names:
            g = grads[n]
            out[n] = flat[lo : lo + g.numel()].view(g.shape).to(g.dtype)
            lo += g.numel()
        return out

    def dense_wire_stats(self) -> WireStats:
        """No index stream; the value stream is the whole float32 tensor."""
        bits = torch.full((), float(32 * sum(c.d for c in self.codecs.values())), device=self.device)
        zero = torch.zeros((), device=self.device)
        return WireStats(index_bits=zero, value_bits=bits, dense_bits=bits, saturated=zero)
