"""The bucketed exchange streamed out of the backward pass
(`cfg.stream_exchange`), ported from `deepreduce_tpu/comm_stream.py`, over
a flat exchange or the hierarchical one.

The JAX package wraps the loss in one identity `custom_vjp` per bucket and
runs the bucket's exchange in its backward rule. Here every parameter gets
a `register_post_accumulate_grad_hook`, which fires once, after the last
accumulation of its gradient (the LSTM's weights are used once per time
step and still fire once). When the last member of a bucket has fired, the
hook hands the bucket to the step's dispatcher thread, which compensates
it, encodes it into its span of one uint8 buffer (one grouped QSGD launch)
and starts its all_gather (`BucketedExchanger.run_streaming_bucket`),
while the backward pass goes on for the layers before it. The hooks
themselves never wait: on the card they run on autograd's one device
thread, which the backward passes of in-process workers share, so a hook
that waited in a collective for another worker's hook would wait forever.

- **Order.** Every rank must start its collectives in the same order, so
  buckets are dispatched strictly in spec order: a bucket that closes
  before its predecessor waits until the predecessor has gone (the role of
  the JAX package's token chain).
- **Streams.** On CUDA the dispatcher runs the buckets' work on one side
  stream. It waits on an event the hook records on the backward pass's
  stream before it reads a gradient;
  `record_stream` marks the tensors each stream reads that the other
  allocated; the main stream waits on the side stream before the decode,
  so the optimizer runs after it. Neither makes a host sync.
- **After backward.** A bucket whose members got no gradient is sent with
  zeros, as the JAX package's zero cotangents would be. Then every gather is
  waited on and decoded in spec order; the mean and the residuals
  (compensated minus this worker's own decode) are those of the barrier
  schedule, bitwise: the same partition, codecs, streams, bytes, decode
  order and mean.
- **Over a `HierarchicalExchanger`** (the dense slice mean and the
  config-pinned bucketed allgather across slices, the only stack the
  `stream-vs-hier` fence lets stream): each bucket's hook first takes the
  bucket's slice mean (one `all_reduce` over the `ici` group of the
  bucket's concatenated gradients, times the float32 reciprocal of the
  slice size), then compensates, encodes and starts its gather over the
  `dcn` group. The slice mean is elementwise, so a bucket's is the
  barrier exchange's whole-gradient mean at its members, and the streamed
  step is bitwise the barrier hierarchical step; `ici_bits` is the
  barrier's too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from deepreduce_tpu_torch.metrics import WireStats, combine
from deepreduce_tpu_torch.numerics import mean_of_sum
from deepreduce_tpu_torch.parallel.hierarchical import HierarchicalExchanger
from deepreduce_tpu_torch.telemetry.spans import span

Tree = Dict[str, torch.Tensor]


class StreamingExchange:
    """Streams a `GradientExchanger`'s bucketed exchange, or a
    `HierarchicalExchanger`'s over one, out of the backward pass;
    `value_and_grad_exchange` replaces `loss.backward()` followed by
    `exchanger.exchange`."""

    def __init__(self, exchanger):
        self.hier = None
        if isinstance(exchanger, HierarchicalExchanger):
            if exchanger.ici_leg != "dense":
                raise ValueError(
                    "StreamingExchange over a HierarchicalExchanger requires the dense ICI leg: the qar leg's "
                    f"two-phase quantized allreduce cannot split per bucket hook (got hier_ici={exchanger.ici_leg!r})"
                )
            self.hier, exchanger = exchanger, exchanger.exchanger
        if exchanger.bucketed is None:
            raise ValueError(
                "StreamingExchange needs the bucketed exchange: construct the GradientExchanger with "
                "cfg.bucket_bytes set"
            )
        self.exchanger = exchanger
        self.bucketed = exchanger.bucketed
        dev = exchanger.device
        self.side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def value_and_grad_exchange(
        self,
        loss_fn: Callable,
        params: Dict[str, nn.Parameter],
        batch,
        residuals: Optional[Tree],
        *,
        step: int,
        uniforms: Optional[Tree] = None,
        collect: Optional[Tree] = None,
    ) -> Tuple[torch.Tensor, Tree, Tree, Optional[Tree], WireStats]:
        """One streamed forward, backward and exchange of this worker's
        `batch`. Returns (loss, this worker's raw gradients, the aggregate,
        the new residuals or None, this worker's wire stats). `uniforms`
        (bucket label -> f32, CPU only) replaces the QSGD draws; `collect`,
        when a dict, receives the measured bloom false positives
        (`fp_count`, `fp_universe`) and the per-bucket saturation flags
        (`bucket_saturated`), as `GradientExchanger.exchange` gives them."""
        ex = self.exchanger
        if sorted(params) != ex.names:
            raise ValueError("params must hold exactly the tensors the exchanger was built for")
        run = _Dispatch(self, residuals, step=step, uniforms=uniforms, payloads=collect is not None)
        hooks = []
        try:
            try:
                for n, p in params.items():
                    p.grad = None
                    hooks.append(p.register_post_accumulate_grad_hook(run.hook(n)))
                loss = loss_fn(batch)
                loss.backward()
            finally:
                for h in hooks:
                    h.remove()
            run.flush()
        finally:
            run.join()
        main = run.main
        if main is not None:
            main.wait_stream(self.side)
        totals, owns, stats = {}, {}, {}
        own = ex.rank if residuals is not None else None
        batch = ex.cfg.decode_batch if ex.cfg.decode_strategy == "vmap" else None
        for b, spec in enumerate(self.bucketed.specs):
            handle, stats[spec.label] = run.inflight[b]
            rows = handle.wait()
            if main is not None:
                rows.record_stream(main)
            with span(f"exchange/bucket/{spec.label}"), span("exchange/decode", route="bucketed"):
                totals[spec.label], owns[spec.label] = self.bucketed.fused.decode_sum(spec.label, rows, own,
                                                                                      step=step, batch=batch)
        if collect is not None:
            collect["fp_count"], collect["fp_universe"] = self.bucketed.fused.fp_totals(run.payloads, ex.device)
            collect["bucket_saturated"] = self.bucketed.saturation_vector(stats)
        mean, own_dec = ex.mean_and_own(totals, owns if own is not None else None, ex.num_workers)
        agg, new_residuals = ex.finish(run.grads, run.compensated, mean, own_dec)
        wire = combine(stats)
        if self.hier is not None:
            ici = torch.full((), self.hier.ici_bits(), dtype=torch.float32, device=ex.device)
            wire = dataclasses.replace(wire, ici_bits=wire.ici_bits + ici)
        return loss, run.grads, agg, new_residuals, wire


class _Dispatch:
    """One step's hooks: each bucket's members still to fire, the
    gradients seen, and the buckets sent so far (strictly in spec order)."""

    def __init__(self, stream: StreamingExchange, residuals: Optional[Tree], *, step: int,
                 uniforms: Optional[Tree], payloads: bool = False):
        self.stream = stream
        # each bucket's payload by label, for the false-positive count
        self.payloads: Optional[dict] = {} if payloads else None
        self.residuals = residuals
        self.step = step
        self.uniforms = uniforms
        bucketed = stream.bucketed
        self.pending: List[set] = [set(s.names) for s in bucketed.specs]
        self.grads: Tree = {}
        self.compensated: Tree = {}
        self.inflight: List[Optional[Tuple[object, WireStats]]] = [None] * len(bucketed.specs)
        self.next = 0
        # one thread runs the buckets in the order the hooks hand them over
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.futures = []
        ex = stream.exchanger
        self.buf = torch.empty(bucketed.fused.nbytes, dtype=torch.uint8, device=ex.device)
        # the stream the decode and the optimizer run on
        self.main = torch.cuda.current_stream(ex.device) if stream.side is not None else None

    def hook(self, name: str) -> Callable[[nn.Parameter], None]:
        def on_grad(p: nn.Parameter) -> None:
            self.grads[name] = p.grad
            self.pending[self.stream.bucketed.bucket_of[name]].discard(name)
            self.drain()

        return on_grad

    def drain(self) -> None:
        """Hand every closed bucket whose predecessors have gone to the
        dispatcher, with an event on the stream that wrote its gradients."""
        while self.next < len(self.pending) and not self.pending[self.next]:
            ready = None
            if self.stream.side is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.buf.device))
            self.futures.append(self.pool.submit(self.dispatch, self.next, ready))
            self.next += 1

    def join(self) -> None:
        """Wait until every handed-over bucket is dispatched; raise the
        first failure."""
        try:
            for f in self.futures:
                f.result()
        finally:
            self.pool.shutdown(wait=True)

    def flush(self) -> None:
        """After backward: a member that got no gradient counts as zeros."""
        shapes = self.stream.exchanger.shapes
        for b in range(self.next, len(self.pending)):
            for n in self.pending[b]:
                self.grads[n] = torch.zeros(shapes[n], dtype=torch.float32, device=self.buf.device)
            self.pending[b].clear()
        self.drain()

    def dispatch(self, b: int, ready: Optional[torch.cuda.Event]) -> None:
        stream, side = self.stream, self.stream.side
        ex, spec = stream.exchanger, stream.bucketed.specs[b]
        grads = {n: self.grads[n] for n in spec.names}
        if side is not None:
            # the side stream reads what the backward pass's stream wrote
            side.wait_event(ready)
            reads = list(grads.values()) + [self.buf]
            if self.residuals is not None:
                reads += [self.residuals[n] for n in spec.names]
            for t in reads:
                t.record_stream(side)
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext(), \
                span(f"exchange/bucket/{spec.label}"):
            hier = stream.hier
            if hier is not None and hier.per_slice > 1:
                bucketed = stream.bucketed
                with span("exchange/ici"):
                    summed = hier.ici.all_reduce_sum(bucketed.concat_bucket(grads, spec))
                grads = bucketed.split_bucket(spec, mean_of_sum(summed, hier.per_slice))
            with span("exchange/dcn") if hier is not None else contextlib.nullcontext():
                comp = ex.compensate(grads, self.residuals)
                self.inflight[b] = stream.bucketed.run_streaming_bucket(
                    b, comp, self.buf, ex.coll, step=self.step, worker=ex.rank, uniforms=self.uniforms,
                    payloads_out=self.payloads,
                )
        if side is not None:
            # the main stream reads the compensated gradient after the wait
            for t in comp.values():
                t.record_stream(self.main)
        self.compensated.update(comp)
