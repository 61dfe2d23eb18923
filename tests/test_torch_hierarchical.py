"""Port parity for the two-tier exchange (`parallel/hierarchical.py`) against
the JAX package's `HierarchicalExchanger` under `shard_map` on the CPU's
(dcn, ici) meshes `make_hybrid_mesh(2, 2)` and `(2, 4)`, the port's workers
running as threads of a `collectives.InProcessGrid`.

Bitwise, given the JAX package's uniforms:
- dense slice mean + the fused DRQSGD-BF-P0 exchange across slices, on
  inputs of integers x 2**-6: the slice mean of 2 or 4 of them is exact, so
  the QSGD norms are too;
- the qar slice leg + the dense allreduce across slices, on the qar tests'
  anchored grid (every 512-bucket's squares sum to (4 * 127)**2);
- qar + quantized (bench.py's `qar+quantized`), on anchored inputs whose
  levels are exact (m = 4 j) and alike on the replicas of a slice: the qar
  leg then returns the input exactly, and the quantized route's block norms
  across slices are exact sums. On other inputs its full-mantissa output
  would meet the quantized route's norm, which the port sums in float64 and
  rounds once and XLA sums in float32.
The replicas of a slice agree bitwise; `ici_bits` equals the JAX package's
called without a key (with one, JAX adds its key-repair gather, which the
port does not need); the streamed step is bitwise the barrier one; one
Trainer step matches the JAX Trainer; four gloo ranks equal the in-process
grid."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as PS
from test_torch_bucketed import QSGD_CFG, _grid, _t
from test_torch_qar import _four_squares, anchored_grid
from test_torch_slice import FLAGSHIP, _jax_flat_params
from test_torch_streaming import CensusModel
from torch_ranks import run_hier_rank

from deepreduce_tpu.comm_stream import StreamingExchange as JStreaming
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.exchange import describe as jdescribe
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.parallel import HierarchicalExchanger as JHier
from deepreduce_tpu.parallel import make_hybrid_mesh
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import qar, sparse_rs
from deepreduce_tpu_torch.collectives import InProcessGrid
from deepreduce_tpu_torch.comm_stream import StreamingExchange
from deepreduce_tpu_torch.exchange import build_exchanger, describe
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.parallel import HierarchicalExchanger
from deepreduce_tpu_torch.weights import params_from_jax

SHAPES = {"emb": (60, 50), "w1": (30, 40), "b1": (40,), "w2": (700,)}  # d = 4,940
D = sum(math.prod(s) for s in SHAPES.values())
STEP = 2
BF_P0 = dict(FLAGSHIP, min_compress_size=100, seed=7, hier=True)
QAR_QUANTIZED = dict(communicator="sparse_rs", rs_mode="quantized", compressor="topk", compress_ratio=0.1,
                     memory="residual", seed=7, hier=True, hier_ici="qar")  # bench.py:1015-1019
QAR_DENSE = dict(communicator="allreduce", compressor="none", memory="none", seed=7, hier=True, hier_ici="qar")
SPEC = PS(("dcn", "ici"))


def _split(flat):
    out, lo = {}, 0
    for n in sorted(SHAPES):
        size = math.prod(SHAPES[n])
        out[n] = flat[lo : lo + size].reshape(SHAPES[n])
        lo += size
    return out


def _anchored4(rng, d=D, bucket=512):
    """f32[d] of m * 2**-6 with m = 4 j, where every bucket's j satisfy
    sum j**2 = 127**2: qar's scale is then 16 and every level exactly j."""
    j = np.zeros(d, np.int64)
    for lo in range(0, d, bucket):
        n = min(bucket, d - lo)
        x = rng.integers(-6, 7, size=n)
        x[rng.random(n) < 0.3] = 0
        x[-4:] = 0
        rest = 127 * 127 - int((x * x).sum())
        assert rest >= 0
        x[-4:] = np.array(_four_squares(rest)) * rng.choice([-1, 1], size=4)
        j[lo : lo + n] = rng.permutation(x)
    return (4 * j * 2.0**-6).astype(np.float32)


# -- both packages' runs ------------------------------------------------------------ #


@functools.lru_cache(maxsize=None)
def _jax_hier(key, S, P):
    """The JAX package's hierarchical exchange of `_inputs(key, S, P)` on
    the (S, P) mesh, called without a key: per worker (aggregate, new
    residuals, index bits, value bits, ici bits), and the exchanger."""
    knobs, grads_w, res_w = _inputs(key, S, P)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jhx = JHier(like, JConfig(**knobs), num_slices=S, per_slice=P)
    has_res = res_w is not None

    def spmd(g, r):
        lead = lambda t: {n: x[None] for n, x in t.items()}
        agg, new_r, wire = jhx.exchange({n: x[0] for n, x in g.items()},
                                        {n: x[0] for n, x in r.items()} if has_res else None,
                                        step=jnp.asarray(STEP, jnp.int32))
        return (lead(agg), lead(new_r) if has_res else {}, wire.index_bits[None], wire.value_bits[None],
                jnp.asarray(wire.ici_bits, jnp.float32)[None])

    fn = shard_map(spmd, mesh=make_hybrid_mesh(S, P), in_specs=(SPEC, SPEC), out_specs=(SPEC,) * 5,
                   check_vma=False)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in SHAPES}
    out = jax.jit(fn)(stack(grads_w), stack(res_w) if has_res else {})
    return [np.asarray(o) if not isinstance(o, dict) else {n: np.asarray(x) for n, x in o.items()} for o in out], jhx


@functools.lru_cache(maxsize=None)
def _inputs(key, S, P):
    """(knobs, per-worker gradients, per-worker residuals or None)."""
    W = S * P
    rng = np.random.default_rng({"dense_fused": 1, "qar_dense": 2, "qar_quantized": 3}[key] * 100 + 10 * S + P)
    if key == "dense_fused":
        grads = [{n: _grid(rng, s) for n, s in SHAPES.items()} for _ in range(W)]
        # the replicas of a slice carry one residual, as they do in training
        res = [{n: _grid(rng, s) for n, s in SHAPES.items()} for _ in range(S)]
        return BF_P0, grads, [res[r // P] for r in range(W)]
    if key == "qar_dense":
        return QAR_DENSE, [_split(anchored_grid(rng, D)) for _ in range(W)], None
    # qar_quantized: the replicas of a slice alike
    slices = [_split(_anchored4(rng)) for _ in range(S)]
    return QAR_QUANTIZED, [slices[r // P] for r in range(W)], [{n: np.zeros(s, np.float32) for n, s in
                                                                 SHAPES.items()} for _ in range(W)]


def _uniforms(key, jhx, S, P):
    """JAX's draws, per worker: (the exchange across slices', the qar slice
    leg's). Without a key the fused codecs draw from per_tensor_key(
    fold_in(PRNGKey(seed), slice), name, step), the quantized route from
    fold_in(fold_in(PRNGKey(seed), step), slice), and the qar slice leg
    from fold_in(PRNGKey(step), position) (and its fold_in 0x5EED)."""
    knobs = _inputs(key, S, P)[0]
    seed = knobs["seed"]
    out = []
    for r in range(S * P):
        s, p = divmod(r, P)
        u = None
        if knobs.get("deepreduce"):
            wkey = jax.random.fold_in(jax.random.PRNGKey(seed), s)
            u = {n: _t(jax.random.uniform(per_tensor_key(wkey, n, jnp.asarray(STEP, jnp.int32)),
                                          (c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size,)))
                 for n, c in jhx.exchanger.codecs.items() if c.val_codec is not None}
        elif knobs["communicator"] == "sparse_rs":
            n = sparse_rs.padded_shard(D, S, 256) * S
            rkey = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(STEP))
            u = {sparse_rs.STREAM_QUANTIZED: _t(jax.random.uniform(jax.random.fold_in(rkey, s), (n,)))}
        iu = None
        if knobs.get("hier_ici") == "qar":
            n = qar.pad_len(D, P, 512)
            k1 = jax.random.fold_in(jax.random.PRNGKey(STEP), p)
            k2 = jax.random.fold_in(k1, jnp.uint32(0x5EED))
            iu = {qar.STREAM_PHASE1: _t(jax.random.uniform(k1, (n,))),
                  qar.STREAM_PHASE2: _t(jax.random.uniform(k2, (n // P,)))}
        out.append((u, iu))
    return out


def _port_hier(key, S, P, uniforms_w):
    """Each worker's (aggregate, new residuals, wire, payload bytes, ICI
    bytes, the bytes it sent across slices, describe) through the port."""
    knobs, grads_w, res_w = _inputs(key, S, P)
    cfg = port.DeepReduceConfig(**knobs)

    def work(pair, g, r, u):
        ex = build_exchanger(SHAPES, cfg, device="cpu", group=pair)
        sent = []
        gather = ex.exchanger.gather
        ex.exchanger.gather = lambda buf: (sent.append(buf.clone()), gather(buf))[1]
        agg, new_r, wire = ex.exchange({n: _t(x) for n, x in g.items()},
                                       None if r is None else {n: _t(x) for n, x in r.items()}, step=STEP,
                                       uniforms=u[0], ici_uniforms=u[1])
        return agg, new_r, wire, ex.payload_bytes(), ex.ici_payload_bytes(), sent, describe(ex)

    return InProcessGrid(S, P).run(work, grads_w, res_w or [None] * (S * P), uniforms_w)


CASES = [("dense_fused", 2, 2), ("dense_fused", 2, 4), ("qar_dense", 2, 2), ("qar_quantized", 2, 2)]


@pytest.mark.parametrize("key,S,P", CASES, ids=[f"{k}_{s}x{p}" for k, s, p in CASES])
def test_hierarchical_exchange_bitwise_matches_jax(key, S, P):
    (jagg, jres, jidx, jval, jici), jhx = _jax_hier(key, S, P)
    out = _port_hier(key, S, P, _uniforms(key, jhx, S, P))
    like = {n: jnp.zeros(s) for n, s in SHAPES.items()}
    for r, (agg, new_r, wire, payload, ici_payload, sent, desc) in enumerate(out):
        for n in SHAPES:
            np.testing.assert_array_equal(agg[n].numpy(), jagg[n][r], err_msg=f"{key} worker {r} aggregate {n}")
            if new_r is not None:
                np.testing.assert_array_equal(new_r[n].numpy(), jres[n][r], err_msg=f"{key} worker {r} residual {n}")
        assert (float(wire.index_bits), float(wire.value_bits), float(wire.ici_bits)) == (
            float(jidx[r]), float(jval[r]), float(jici[r])), f"{key} worker {r} wire"
        assert payload == jhx.payload_bytes(like) and ici_payload == jhx.ici_payload_bytes(like)
        assert desc == jdescribe(jhx)
        # the replica contract: every replica of a slice sends and gets the same
        s0 = out[(r // P) * P]
        for n in SHAPES:
            assert torch.equal(agg[n], s0[0][n])
        assert all(torch.equal(a, b) for a, b in zip(sent, s0[5]))
    assert any(np.count_nonzero(jagg[n]) for n in SHAPES)
    if key != "dense_fused":
        assert float(out[0][2].ici_bits) == qar.wire_bits_per_worker(D, P, 512) > 0


def test_ici_bits_without_and_with_a_key():
    """The port's ici_bits is the JAX exchange's without a key; a JAX caller
    that passes a key adds its key-repair gather (2 words x 32 bits to each
    of the other replicas), which the port has no use for."""
    S, P = 2, 4
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jhx = JHier(like, JConfig(**dict(BF_P0, compressor="topk", deepreduce=None)), num_slices=S, per_slice=P)

    def spmd(g, with_key):
        key = jax.random.PRNGKey(3) if with_key else None
        _, _, wire = jhx.exchange({n: x[0] for n, x in g.items()}, None, step=jnp.asarray(0), key=key)
        return jnp.asarray(wire.ici_bits, jnp.float32)[None]

    g = {n: jnp.ones((S * P,) + s) for n, s in SHAPES.items()}
    bits = {k: float(jax.jit(shard_map(functools.partial(spmd, with_key=k), mesh=make_hybrid_mesh(S, P),
                                       in_specs=(SPEC,), out_specs=SPEC, check_vma=False))(g)[0])
            for k in (False, True)}
    tex = HierarchicalExchanger(SHAPES, port.DeepReduceConfig(**dict(BF_P0, compressor="topk", deepreduce=None)),
                                ici=port.InProcessGroup(P).member(0), dcn=port.InProcessGroup(S).member(0),
                                device="cpu")
    assert tex.ici_bits() == bits[False] == 2.0 * (P - 1) / P * 32.0 * D
    assert bits[True] - bits[False] == 2 * 32.0 * (P - 1)


def test_auto_plan_and_rewritten_config_equal_jax():
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    topk = dict(compressor="topk", compress_ratio=0.1, memory="residual", seed=7, hier=True)
    cases = [dict(topk, hier_ici="auto", hier_dcn="auto"), dict(topk, hier_dcn="auto"),
             dict(topk, hier_ici="auto", communicator="sparse_rs", rs_mode="quantized"),
             dict(topk, hier_ici="auto", hier_dcn="auto", bucket_bytes=4000),
             dict(BF_P0, hier_ici="auto")]
    for knobs in cases:
        for S, P in ((2, 2), (2, 4), (4, 2)):
            jhx = JHier(like, JConfig(**knobs), num_slices=S, per_slice=P)
            tex = HierarchicalExchanger(SHAPES, port.DeepReduceConfig(**knobs), ici=port.InProcessGroup(P).member(0),
                                        dcn=port.InProcessGroup(S).member(0), device="cpu")
            assert tex.plan == jhx.plan and tex.ici_leg == jhx.ici_leg, (knobs, S, P)
            for f in ("communicator", "rs_mode", "bucket_bytes", "hier_ici", "hier_dcn"):
                assert getattr(tex.inner_cfg, f) == getattr(jhx.inner_cfg, f), (knobs, f)
            assert describe(tex) == jdescribe(jhx)
            assert tex.payload_bytes() == jhx.payload_bytes(like)
    # the WordLSTM's pick at (2, 2), which chip_smoke's hier_auto arm checks
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    tex = HierarchicalExchanger(shapes, port.DeepReduceConfig(**cases[0]), ici=port.InProcessGroup(2).member(0),
                                dcn=port.InProcessGroup(2).member(0), device="cpu")
    assert (tex.plan["ici"], tex.plan["dcn"]) == ("qar", "fused")
    # hier_ici='auto' needs a DCN leg with a model row, in both packages
    with pytest.raises(ValueError, match="cost-modelable"):
        JHier(like, JConfig(**QAR_DENSE | dict(hier_ici="auto")), num_slices=2, per_slice=2)
    with pytest.raises(ValueError, match="cost-modelable"):
        HierarchicalExchanger(SHAPES, port.DeepReduceConfig(**QAR_DENSE | dict(hier_ici="auto")),
                              ici=port.InProcessGroup(2).member(0), dcn=port.InProcessGroup(2).member(0), device="cpu")


FENCES = {
    "rs-sketch-rows-range": dict(communicator="sparse_rs", rs_sketch_rows=0),
    "rs-sketch-cols-range": dict(communicator="sparse_rs", rs_sketch_cols=-1),
    "enum-hier_ici": dict(hier=True, hier_ici="ring"),
    "enum-hier_dcn": dict(hier=True, hier_dcn="best"),
    "ici-size-range": dict(hier=True, ici_size=0),
    "hier-knobs-disengaged": dict(hier_ici="qar"),
    "hier-vs-ring": dict(BF_P0, decode_strategy="ring"),
    "hier-vs-resilience": dict(BF_P0, resilience=True),
    "resilience-vs-owner-communicator": dict(communicator="sparse_rs", hier=True, resilience=True),
    "hier-dcn-auto-needs-topk": dict(BF_P0, hier_dcn="auto"),
    "stream-vs-hier": dict(BF_P0, hier_ici="qar", bucket_bytes=4000, stream_exchange=True),
    "profile-needs-auto-selector": dict(BF_P0, profile="profile.json"),
}


@pytest.mark.parametrize("code", list(FENCES))
def test_fences_raise_the_jax_reason_code(code):
    with pytest.raises(JConfigError) as je:
        JConfig(**FENCES[code])
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**FENCES[code])
    assert e.value.reason_code == je.value.reason_code == code


def test_streamed_hier_step_is_bitwise_the_barrier_one():
    """Stream-over-hier on a bucketed census at (2, 2): every worker's
    aggregate, residuals and wire (ici_bits included) equal the barrier
    schedule's; the plans print as the JAX package's."""
    S, P = 2, 2
    knobs = dict(QSGD_CFG, bucket_bytes=4800, bucket_order="reverse", hier=True)
    census = {"emb": (3000,), "w1": (900,), "w2": (700,), "b1": (300,), "b2": (150,), "b3": (50,)}
    rng = np.random.default_rng(9)
    params = {n: _grid(rng, s) for n, s in census.items()}
    batches = [{n: _t(_grid(rng, s)) for n, s in census.items()} for _ in range(S * P)]
    res = [{n: _t(_grid(rng, s)) for n, s in census.items()} for _ in range(S * P)]

    def run(stream):
        cfg = port.DeepReduceConfig(**knobs, stream_exchange=stream, bucket_pipeline=False)

        def work(pair, b, r):
            model = CensusModel(params)
            ex = build_exchanger(census, cfg, device="cpu", group=pair)
            named = dict(model.p.items())
            if stream:
                se = StreamingExchange(ex)
                _, _, agg, new_r, wire = se.value_and_grad_exchange(model.loss, named, b, r, step=STEP)
                return agg, new_r, wire, describe(se)
            model.loss(b).backward()
            agg, new_r, wire = ex.exchange({n: p.grad for n, p in named.items()}, r, step=STEP)
            return agg, new_r, wire, describe(ex)

        return InProcessGrid(S, P).run(work, batches, res)

    streamed, barrier = run(True), run(False)
    for r in range(S * P):
        (a1, r1, w1, d1), (a2, r2, w2, d2) = streamed[r], barrier[r]
        for n in census:
            assert torch.equal(a1[n], a2[n]) and torch.equal(r1[n], r2[n]), (r, n)
        assert float(w1.total_bits) == float(w2.total_bits) and float(w1.ici_bits) == float(w2.ici_bits) > 0
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in census.items()}
    jhx = JHier(like, JConfig(**knobs, stream_exchange=True), num_slices=S, per_slice=P)
    assert streamed[0][3] == jdescribe(JStreaming(jhx)) and barrier[0][3] == jdescribe(jhx)
    with pytest.raises(ValueError, match="dense ICI leg"):
        StreamingExchange(HierarchicalExchanger(census, port.DeepReduceConfig(**knobs, hier_ici="qar"),
                                                ici=port.InProcessGroup(2).member(0),
                                                dcn=port.InProcessGroup(2).member(0), device="cpu"))


def test_trainer_step_matches_the_jax_trainer():
    """One Trainer step with hier=True of a narrow WordLSTM over
    InProcessGrid(2, 2) against the JAX Trainer on the (2, 2) mesh, from the
    same weights: losses, parameters and wire (the JAX Trainer passes a key,
    so its ici_bits carries the key-repair gather's 64 bits more)."""
    vocab, embed, hidden, batch, seq, lr, mom = 64, 8, 16, 8, 5, 0.1, 0.9
    S, P = 2, 2
    knobs = dict(BF_P0, seed=3, ici_size=P)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    jtr = JTrainer(JWordLSTM(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden), JConfig(**knobs),
                   optax.sgd(lr, momentum=mom), make_hybrid_mesh(S, P))
    jstate = jtr.init_state(jax.random.PRNGKey(0), (x, y))
    flat0 = _jax_flat_params(jstate.params)
    key = jax.random.PRNGKey(100)
    uniforms = [{n: _t(jax.random.uniform(per_tensor_key(jax.random.fold_in(key, r // P), n, jnp.asarray(0, jnp.int32)),
                                          (c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size,)))
                 for n, c in jtr.exchanger.exchanger.codecs.items() if c.compressed} for r in range(S * P)]
    jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
    shard = batch // (S * P)

    def work(pair, u):
        model = WordLSTM(vocab, embed, hidden)
        model.load_flax_params(params_from_jax(flat0))
        tr = port.Trainer(model, port.DeepReduceConfig(**knobs), lr=lr, momentum=mom, device="cpu", group=pair)
        lo = (pair[1].rank * P + pair[0].rank) * shard
        state, loss, wire = tr.step(tr.init_state(), (_t(x[lo : lo + shard]).long(), _t(y[lo : lo + shard]).long()),
                                    uniforms=u)
        return state, loss, wire, describe(tr.exchanger)

    out = InProcessGrid(S, P).run(work, uniforms)
    jflat = _jax_flat_params(jstate.params)
    assert len(uniforms[0]) >= 4 and out[0][3] == jdescribe(jtr.exchanger)
    for r, (state, loss, wire, _) in enumerate(out):
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(wire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
        assert float(wire.ici_bits) + 2 * 32.0 * (P - 1) == float(jwire.ici_bits)
        for n, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=f"{r} {n}")
            assert torch.equal(p, out[0][0].params[n])


def test_four_gloo_ranks_equal_the_in_process_grid(tmp_path):
    """Four spawned processes split one gloo group into (ici, dcn) pairs with
    `dist.new_group` (cfg.ici_size = 2) and run the dense-fused exchange:
    each rank's aggregate and residuals equal the in-process grid's,
    bitwise."""
    S, P = 2, 2
    knobs, grads_w, res_w = _inputs("dense_fused", S, P)
    knobs = dict(knobs, ici_size=P)
    want = _port_hier("dense_fused", S, P, [(None, None)] * (S * P))
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(S * P)]
    inputs = [({n: _t(x) for n, x in g.items()}, {n: _t(x) for n, x in r.items()}) for g, r in zip(grads_w, res_w)]
    procs = [ctx.Process(target=run_hier_rank, args=(r, S * P, store, outs[r], knobs, SHAPES, inputs, STEP))
             for r in range(S * P)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks {alive} still running after 120 s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * (S * P)
    for r in range(S * P):
        agg, new_r = torch.load(outs[r])
        for n in SHAPES:
            assert torch.equal(agg[n], want[r][0][n]) and torch.equal(new_r[n], want[r][1][n]), (r, n)


def test_phase17_wire_constants_match_jax():
    """chip_smoke phase 17's bytes on the full-width WordLSTM, each the JAX
    package's: `payload_bytes` at W = 1 for the one-rank arms, and the DCN
    `payload_bytes` and `ici_payload_bytes` of its HierarchicalExchanger at
    (2, 2) for the grid arms."""
    import dataclasses

    import chip_smoke
    from test_torch_bucketed import _model_shapes

    from deepreduce_tpu.comm import GradientExchanger as JExchanger

    jn, _ = _model_shapes("wordlstm")
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in jn.items()}
    cfg = lambda knobs: JConfig(**dataclasses.asdict(chip_smoke._flagship_cfg(0, **knobs)))
    for arm, (knobs, _) in chip_smoke.PHASE17.items():
        if knobs.get("hier"):
            jex = JHier(like, cfg(knobs), num_slices=1, per_slice=1)
        else:
            jex = JExchanger(like, cfg(knobs), num_workers=1)
        assert jex.payload_bytes(like) == chip_smoke.PAYLOAD17[arm], arm
    for arm, (knobs, (dcn, ici), _) in chip_smoke.HIER17.items():
        jhx = JHier(like, cfg(knobs), num_slices=2, per_slice=2)
        assert (jhx.payload_bytes(like), jhx.ici_payload_bytes(like)) == (dcn, ici), arm
        if knobs.get("hier_dcn") == "auto":
            assert {k: jhx.plan[k] for k in chip_smoke.PLAN17} == chip_smoke.PLAN17


def test_auto_ici_prices_a_dcn_leg_the_inner_route_does_not_run_as_jax():
    """A JAX-side fault, mirrored: under hier_ici='auto' with
    rs_mode='auto', the planner names the cross-slice leg with the cost
    model's default oktopk knobs, while the inner exchanger resolves its
    route with the config's. At rs_oktopk_bins=64 the plan prices
    'quantized' and the exchange runs 'oktopk', in both packages."""
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    knobs = dict(communicator="sparse_rs", rs_mode="auto", compress_ratio=0.1, hier=True, hier_ici="auto",
                 rs_oktopk_bins=64)
    jhx = JHier(like, JConfig(**knobs), num_slices=2, per_slice=2)
    tex = HierarchicalExchanger(SHAPES, port.DeepReduceConfig(**knobs), ici=port.InProcessGroup(2).member(0),
                                dcn=port.InProcessGroup(2).member(0), device="cpu")
    assert sorted(tex.plan["table"]) == sorted(jhx.plan["table"]) == ["dense+quantized", "qar+quantized"]
    assert tex.exchanger._rs_mode == jhx.exchanger._rs_mode == "oktopk"
