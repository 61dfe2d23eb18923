"""The bucketed exchange: one codec and one all_gather per bucket, ported
from `deepreduce_tpu/comm_bucket.py` (the loop decode only).

`partition_buckets` splits the tensors, from (name, size) alone, into
buckets of at most `bucket_bytes` dense float32 bytes: a tensor too big for
a bucket stays solo and keeps its name (so its codec and its Philox stream
are the per-tensor path's), the rest are packed first-fit-decreasing
(`order='trace'`) or as contiguous reverse-order runs (`order='reverse'`,
the backward pass's completion order) and each fused bucket is the
concatenation of its members. `BucketedExchanger` runs one `TensorCodec`
per bucket, whose slot budget is the sum of its members' budgets
(`sparse.bucket_num_slots`), so bucketing never changes the wire budget.

On the card every bucket's payload lies in one uint8 buffer, buckets in
spec order, each bucket's bytes as the JAX package's `PayloadLayout.pack`
gives them (a `comm.FusedBuffer` over the buckets): the encode of every
bucket writes its QSGD rows with one grouped kernel launch, and each
bucket's all_gather takes its contiguous slice of that buffer. Three
schedules, bitwise equal to each other:

- pipelined (`bucket_pipeline=True`): bucket b+1's gather is started before
  bucket b's decode, so the next transfer overlaps the current decode;
- barrier (`bucket_pipeline=False`): every bucket's gather, then every
  decode;
- streamed (`stream_exchange=True`, `comm_stream.py`): each bucket is
  encoded and its gather started from the backward pass, the moment its last
  member's gradient exists (`run_streaming_bucket`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepreduce_tpu_torch.collectives import Collectives, Gathered
from deepreduce_tpu_torch.comm import FusedBuffer
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats
from deepreduce_tpu_torch.sparse import bucket_num_slots
from deepreduce_tpu_torch.wrappers import TensorCodec

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One bucket: the tensors it fuses (in concat order), their flat sizes
    and offsets in the bucket's float32 super-tensor. A `solo` bucket holds
    one tensor and is labelled by its name."""

    label: str
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    solo: bool


def partition_buckets(
    names: Sequence[str],
    sizes: Sequence[int],
    bucket_bytes: int,
    *,
    order: str = "trace",
) -> List[BucketSpec]:
    """The deterministic size-balanced partition of the JAX package, from
    (name, size) pairs alone, so every worker derives the same buckets.

    Tensors over `bucket_bytes` become solo buckets. `order='trace'` packs
    the rest first-fit-decreasing (ties by original order) and orders the
    buckets by their earliest member; `order='reverse'` packs them next-fit
    over descending index, so each fused bucket is a contiguous run of the
    backward pass, and orders the buckets by descending earliest member
    (bucket 0 closes first). Within a fused bucket the tensors are
    concatenated in original order; a one-member bin is demoted to solo."""
    if order not in ("trace", "reverse"):
        raise ValueError(f"order must be 'trace' or 'reverse', got {order!r}")
    if len(names) != len(sizes):
        raise ValueError("names and sizes must align")
    if len(set(names)) != len(names):
        raise ValueError("duplicate leaf names")
    cap = max(1, int(bucket_bytes) // 4)  # f32 elements per fused bucket
    index = {n: i for i, n in enumerate(names)}

    def _solo(i: int) -> BucketSpec:
        return BucketSpec(label=names[i], names=(names[i],), sizes=(int(sizes[i]),), offsets=(0,),
                          total=int(sizes[i]), solo=True)

    small: List[int] = []
    specs: List[BucketSpec] = []
    for i, size in enumerate(sizes):
        if int(size) <= 0:
            raise ValueError(f"leaf {names[i]!r} has non-positive size {size}")
        if int(size) > cap:
            specs.append(_solo(i))
        else:
            small.append(i)

    bins: List[List[int]] = []
    loads: List[int] = []
    if order == "reverse":
        # next-fit over descending index: strict contiguity
        for i in sorted(small, reverse=True):
            size = int(sizes[i])
            if bins and loads[-1] + size <= cap:
                bins[-1].append(i)
                loads[-1] += size
            else:
                bins.append([i])
                loads.append(size)
    else:
        # first-fit-decreasing, original order breaking ties
        for i in sorted(small, key=lambda i: (-int(sizes[i]), i)):
            size = int(sizes[i])
            for b, load in enumerate(loads):
                if load + size <= cap:
                    bins[b].append(i)
                    loads[b] += size
                    break
            else:
                bins.append([i])
                loads.append(size)

    fused_count = 0
    for members in bins:
        if len(members) == 1:
            specs.append(_solo(members[0]))
            continue
        members = sorted(members)
        label = f"bucket{fused_count}"
        fused_count += 1
        while label in index:  # collision with a literal leaf name
            label += "_"
        offsets, off = [], 0
        for i in members:
            offsets.append(off)
            off += int(sizes[i])
        specs.append(BucketSpec(label=label, names=tuple(names[i] for i in members),
                                sizes=tuple(int(sizes[i]) for i in members), offsets=tuple(offsets),
                                total=off, solo=False))

    first = lambda s: min(index[n] for n in s.names)
    specs.sort(key=(lambda s: -first(s)) if order == "reverse" else first)
    return specs


class BucketedExchanger:
    """Per-bucket encode -> all_gather -> decode, built by
    `GradientExchanger` when `cfg.bucket_bytes` is set. `shapes` maps the
    tensor names, in the exchanger's (sorted) order, to their shapes."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], cfg: DeepReduceConfig, *, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shapes = dict(shapes)
        names = list(shapes)
        self.specs: Tuple[BucketSpec, ...] = tuple(partition_buckets(
            names, [math.prod(shapes[n]) for n in names], cfg.bucket_bytes, order=cfg.bucket_order
        ))
        self.fused = FusedBuffer({
            s.label: TensorCodec((s.total,), cfg, name=s.label, slots=bucket_num_slots(s.sizes, cfg.compress_ratio),
                                 device=self.device)
            for s in self.specs
        })
        self.bucket_of = {n: b for b, s in enumerate(self.specs) for n in s.names}

    def concat_bucket(self, tensors: Tree, spec: BucketSpec) -> torch.Tensor:
        """The bucket's members flattened and concatenated into its float32
        super-tensor."""
        parts = [tensors[n].reshape(-1).to(torch.float32) for n in spec.names]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def split_bucket(self, spec: BucketSpec, dense: torch.Tensor) -> Tree:
        """Static-offset slices of a bucket's dense tensor back to its
        members' shapes (the inverse of `concat_bucket`)."""
        return {n: dense[off : off + size].view(self.shapes[n])
                for n, size, off in zip(spec.names, spec.sizes, spec.offsets)}

    def concat_all(self, tensors: Tree) -> Tree:
        return {s.label: self.concat_bucket(tensors, s) for s in self.specs}

    def split_all(self, by_bucket: Tree) -> Tree:
        out = {}
        for s in self.specs:
            out.update(self.split_bucket(s, by_bucket[s.label]))
        return out

    def run(
        self,
        buckets: Tree,
        coll: Collectives,
        *,
        step: int,
        worker: int,
        own: Optional[int] = None,
        uniforms: Optional[Tree] = None,
    ) -> Tuple[Tree, Optional[Tree], Dict[str, WireStats]]:
        """The whole bucketed exchange of this worker's bucket super-tensors
        (label -> f32): one encode of every bucket into one buffer, then one
        gather and one decode per bucket in the configured schedule. Returns
        (label -> sum over workers, label -> decode of row `own` or None,
        label -> wire stats), in spec order."""
        buf = torch.empty(self.fused.nbytes, dtype=torch.uint8, device=self.device)
        stats = self.fused.encode(buckets, buf, step=step, worker=worker, uniforms=uniforms)
        spans = [buf[self.fused.span(s.label)] for s in self.specs]
        totals: Tree = {}
        owns: Tree = {}

        def decode(b: int, handle: Gathered) -> None:
            label = self.specs[b].label
            totals[label], owns[label] = self.fused.decode_sum(label, handle.wait(), own, step=step)

        count = len(self.specs)
        if self.cfg.bucket_pipeline and count:
            nxt = coll.all_gather_async(spans[0])
            for b in range(count):
                cur = nxt
                if b + 1 < count:
                    nxt = coll.all_gather_async(spans[b + 1])  # started before bucket b's decode
                decode(b, cur)
        else:
            handles = [coll.all_gather_async(x) for x in spans]
            for b in range(count):
                decode(b, handles[b])
        return totals, owns if own is not None else None, stats

    def run_streaming_bucket(
        self,
        b: int,
        tensors: Tree,
        buf: torch.Tensor,
        coll: Collectives,
        *,
        step: int,
        worker: int,
        uniforms: Optional[Tree] = None,
    ) -> Tuple[Gathered, WireStats]:
        """Bucket b of the streamed schedule: concatenate its (compensated)
        members, encode it into its span of `buf` (one grouped QSGD launch
        for this bucket) and start its gather. Returns the gather in flight
        and the bucket's wire stats; `decode_sum` reads the gather later."""
        spec = self.specs[b]
        dense = self.concat_bucket(tensors, spec)
        stats = self.fused.encode({spec.label: dense}, buf, step=step, worker=worker, uniforms=uniforms,
                                  units=[spec.label])
        return coll.all_gather_async(buf[self.fused.span(spec.label)]), stats[spec.label]

    def saturation_vector(self, stats_per: Dict[str, WireStats]) -> torch.Tensor:
        """f32[C] per-bucket saturation flags in spec order."""
        return torch.stack([stats_per[s.label].saturated.reshape(()).to(torch.float32) for s in self.specs])
