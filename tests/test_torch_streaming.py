"""Port parity for the backprop-streamed bucketed exchange
(`stream_exchange`, `comm_stream.py`) against the JAX package's
`StreamingExchange` on the CPU mesh, and against the port's own barrier
and pipelined schedules.

The loss is `tests/test_streaming.py`'s: sum(p * batch) + 0.5 * sum(p**2),
whose gradient is batch + p, as a torch module. Parameters, batches and
residuals sit on the grid 2**-6, so gradients, compensation and the QSGD
bucket norms are exact in both packages; given JAX's uniforms every
aggregate and residual is bitwise equal. W in {1, 3, 4} through an
`InProcessGroup`, one JAX compile per W (module-scoped cache)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_bucketed import QSGD_CFG, SHAPES, STEP, _bucket_uniforms, _grid, _t

from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.comm_stream import StreamingExchange as JStreaming
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.comm_bucket import BucketedExchanger
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.models import WordLSTM

STREAM = dict(QSGD_CFG, bucket_bytes=4800, bucket_order="reverse", stream_exchange=True)


class CensusModel(torch.nn.Module):
    """One parameter per CENSUS name; loss(batch) = sum(p * batch) + 0.5 * sum(p**2)."""

    def __init__(self, params, unused=()):
        super().__init__()
        self.p = torch.nn.ParameterDict({n: torch.nn.Parameter(_t(v)) for n, v in params.items()})
        self.unused = set(unused)

    def loss(self, batch):
        return sum(torch.sum(p * batch[n]) + 0.5 * torch.sum(torch.square(p))
                   for n, p in self.p.items() if n not in self.unused)


def _jax_loss(params, batch_stats, batch):
    loss = sum(jnp.sum(p * batch[n]) + 0.5 * jnp.sum(jnp.square(p)) for n, p in params.items())
    return loss, batch_stats


def _inputs(W, seed=17):
    rng = np.random.default_rng(seed + W)
    params = {n: _grid(rng, s) for n, s in SHAPES.items()}
    batches = [{n: _grid(rng, s) for n, s in SHAPES.items()} for _ in range(W)]
    res = [{n: _grid(rng, s) for n, s in SHAPES.items()} for _ in range(W)]
    return params, batches, res


@functools.lru_cache(maxsize=None)
def _jax_streamed(W):
    """JAX's streamed step on a W-device mesh: every worker's aggregate, raw
    gradients, residuals and wire bits, and the exchanger."""
    params, batches, res = _inputs(W)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jex = JExchanger(like, JConfig(**STREAM), num_workers=W)
    stream = JStreaming(jex)

    def spmd(p, b, r):
        (_, _), grads, agg, new_r, wire = stream.value_and_grad_exchange(
            _jax_loss, p, {}, {n: x[0] for n, x in b.items()}, {n: x[0] for n, x in r.items()},
            step=jnp.asarray(STEP), key=jax.random.PRNGKey(STREAM["seed"]))
        lead = lambda t: {n: x[None] for n, x in t.items()}
        return lead(agg), lead(grads), lead(new_r), wire.total_bits[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P(), P("data"), P("data")),
                   out_specs=(P("data"),) * 4, check_vma=False)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in SHAPES}
    out = jax.jit(fn)({n: jnp.asarray(v) for n, v in params.items()}, stack(batches), stack(res))
    return out, jex


def _port_steps(W, knobs, uniforms_w, *, unused=()):
    """Each worker's (aggregate, raw grads, residuals, wire) through the
    streamed step when `knobs` stream, else backward + `exchange`."""
    params, batches, res = _inputs(W)
    cfg = port.DeepReduceConfig(**knobs)

    def work(coll, b, r, u):
        model = CensusModel(params, unused)
        ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll if W > 1 else None)
        tb = {n: _t(x) for n, x in b.items()}
        tr = {n: _t(x) for n, x in r.items()}
        named = dict(model.p.items())
        if cfg.stream_exchange:
            _, grads, agg, new_r, wire = StreamingExchange(ex).value_and_grad_exchange(
                model.loss, named, tb, tr, step=STEP, uniforms=u)
        else:
            model.loss(tb).backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()}
            agg, new_r, wire = ex.exchange(grads, tr, step=STEP, uniforms=u)
        return agg, grads, new_r, wire

    return port.InProcessGroup(W).run(work, batches, res, uniforms_w)


@pytest.mark.parametrize("W", [1, 3, 4])
def test_streamed_step_bitwise_matches_jax_and_the_barrier_schedules(W):
    (jagg, jgrads, jres, jbits), jex = _jax_streamed(W)
    uniforms_w = _bucket_uniforms(jex, W, STREAM["seed"], jex._bucketed.codecs)
    runs = {
        "streamed": _port_steps(W, STREAM, uniforms_w),
        "barrier": _port_steps(W, dict(STREAM, stream_exchange=False, bucket_pipeline=False), uniforms_w),
        "pipelined": _port_steps(W, dict(STREAM, stream_exchange=False), uniforms_w),
    }
    for how, out in runs.items():
        for r, (agg, grads, new_r, wire) in enumerate(out):
            for n in SHAPES:
                for what, got, want in (("agg", agg, jagg), ("grad", grads, jgrads), ("residual", new_r, jres)):
                    np.testing.assert_array_equal(got[n].detach().numpy(), np.asarray(want[n][r]),
                                                  err_msg=f"{how} worker {r} {what} {n}")
            assert float(wire.total_bits) == float(jbits[r]), how


def test_buckets_dispatch_in_spec_order(monkeypatch):
    """Under the trace partition the buckets close out of spec order in the
    backward pass; the dispatch still goes 0, 1, 2, and the step equals the
    barrier schedule's bitwise. A parameter the loss does not use is sent
    as zeros after backward."""
    knobs = dict(STREAM, bucket_order="trace")
    order = []
    real = BucketedExchanger.run_streaming_bucket

    def spy(self, b, *args, **kw):
        order.append(b)
        return real(self, b, *args, **kw)

    monkeypatch.setattr(BucketedExchanger, "run_streaming_bucket", spy)
    for unused in ((), ("b3",)):
        order.clear()
        streamed = _port_steps(1, knobs, [None], unused=unused)
        assert order == [0, 1, 2]
        barrier = _port_steps(1, dict(knobs, stream_exchange=False, bucket_pipeline=False), [None], unused=unused)
        (a1, g1, r1, _), (a2, g2, r2, _) = streamed[0], barrier[0]
        for n in SHAPES:
            assert torch.equal(a1[n], a2[n]) and torch.equal(r1[n], r2[n]) and torch.equal(g1[n], g2[n]), n
        if unused:
            assert not g1["b3"].any()


def test_lstm_hooks_fire_once_and_the_streamed_trainer_equals_the_barrier_one():
    """The LSTM's weights are used at every time step; the post-accumulate
    hook still fires once per parameter per backward, and two streamed
    Trainer steps equal two barrier-scheduled ones bitwise."""
    model = WordLSTM(64, 8, 16, seed=1)
    fired = {}
    hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n: fired.__setitem__(n, fired.get(n, 0) + 1))
             for n, p in model.flax_params().items()]
    tokens = torch.randint(0, 64, (2, 4, 6), generator=torch.Generator().manual_seed(0))
    out = model(tokens[0, :, :-1])
    torch.nn.functional.cross_entropy(out.reshape(-1, 64), tokens[0, :, 1:].reshape(-1)).backward()
    for h in hooks:
        h.remove()
    assert fired == {n: 1 for n in model.flax_params()}
    flagship = dict(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom",
                    value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", min_compress_size=100, seed=3,
                    bucket_bytes=4000, bucket_order="reverse")
    states = {}
    for arm, extra in (("streamed", dict(stream_exchange=True)), ("barrier", dict(bucket_pipeline=False))):
        trainer = port.Trainer(WordLSTM(64, 8, 16, seed=1), port.DeepReduceConfig(**flagship, **extra), lr=0.1,
                               momentum=0.9, device="cpu")
        state = trainer.init_state()
        assert (trainer.streaming is not None) == (arm == "streamed")
        for i in range(2):
            state, loss, wire = trainer.step(state, (tokens[i, :, :-1], tokens[i, :, 1:]))
        states[arm] = (state, float(loss), float(wire.rel_volume()))
    (s1, l1, v1), (s2, l2, v2) = states["streamed"], states["barrier"]
    assert (l1, v1) == (l2, v2) and 0.0 < v1 < 1.0
    for n in s1.params:
        assert torch.equal(s1.params[n], s2.params[n]) and torch.equal(s1.residuals[n], s2.residuals[n]), n


def test_streaming_needs_buckets():
    ex = port.GradientExchanger(SHAPES, port.DeepReduceConfig(**QSGD_CFG), device="cpu")
    with pytest.raises(ValueError, match="bucket_bytes"):
        StreamingExchange(ex)
