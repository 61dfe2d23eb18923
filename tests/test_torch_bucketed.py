"""Port parity for the bucketed exchange (`bucket_bytes`, `comm_bucket.py`)
and the divide fix (`numerics.py`) against the JAX package on the CPU mesh.

Inputs sit on the grid 2**-6 (integers in [-30, 30]), so every sum of
squares is exact in float32 and the QSGD bucket norms agree bitwise with
the JAX package's float32 sums; given the uniforms JAX draws, every byte,
aggregate and residual is then bitwise equal. Workers run as threads of an
`InProcessGroup` (W in {1, 3, 4}); one JAX compile per W is shared by the
schedules through a module-scoped cache."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P

from deepreduce_tpu import exchange as jexchange
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.comm import _leaf_name
from deepreduce_tpu.comm_bucket import partition_buckets as jpartition
from deepreduce_tpu.comm_stream import StreamingExchange as JStreaming
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.models.resnet import ResNet20 as JResNet20
from deepreduce_tpu.sparse import bucket_num_slots as jbucket_num_slots
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import exchange
from deepreduce_tpu_torch.comm_bucket import partition_buckets
from deepreduce_tpu_torch.models import ResNet20, WordLSTM
from deepreduce_tpu_torch.numerics import reciprocal_f32
from deepreduce_tpu_torch.sparse import bucket_num_slots

CENSUS = {"emb": 3000, "w1": 900, "w2": 700, "b1": 300, "b2": 150, "b3": 50}
SHAPES = {n: (d,) for n, d in CENSUS.items()}
QSGD_CFG = dict(deepreduce="both", index="bloom", value="qsgd", policy="p0", compress_ratio=0.05, fpr=0.05,
                bloom_blocked="mod", min_compress_size=100, memory="residual", seed=7)
BLOOM_CFG = dict(deepreduce="index", index="bloom", compress_ratio=0.02, fpr=0.01, bloom_blocked="mod",
                 policy="p0", min_compress_size=100, memory="residual", seed=7)
FLAGSHIP = dict(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom",
                value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", approx_topk=False)
QUICKSTART = dict(compressor="topk", compress_ratio=0.01, memory="residual", deepreduce="both", index="bloom",
                  value="polyfit", fpr=0.001, policy="leftmost", approx_topk=False)
MIB4 = 4 * 1024 * 1024
STEP = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(rng, shape):
    """Integers in [-30, 30] times 2**-6, 30% zeros: exact sums of squares."""
    m = rng.integers(-30, 31, size=shape)
    m[rng.random(shape) < 0.3] = 0
    return (m * 2.0**-6).astype(np.float32)


def _jax_names(model, *args):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {_leaf_name(p): tuple(l.shape) for p, l in leaves}


@functools.lru_cache(maxsize=None)
def _model_shapes(model: str):
    """(the JAX flatten order of the names with their shapes, the port's)."""
    if model == "wordlstm":
        jn = _jax_names(JWordLSTM(), jnp.zeros((1, 2), jnp.int32))
        tm = WordLSTM(embed_dim=96, hidden_dim=670)
    else:
        jn = _jax_names(JResNet20(), jnp.zeros((1, 8, 8, 3), jnp.float32))
        tm = ResNet20()
    return jn, {n: tuple(p.shape) for n, p in tm.flax_params().items()}


# -- the partition ----------------------------------------------------------- #


@pytest.mark.parametrize("order", ["trace", "reverse"])
@pytest.mark.parametrize("census,bucket_bytes", [("census", 4800), ("census", 1024), ("census", 40_000),
                                                 ("wordlstm", MIB4), ("wordlstm", 1 << 20), ("resnet20", MIB4),
                                                 ("resnet20", 65_536)])
def test_partition_matches_jax(census, bucket_bytes, order):
    if census == "census":
        names, sizes = sorted(CENSUS), [CENSUS[n] for n in sorted(CENSUS)]
    else:
        jn, tshapes = _model_shapes(census)
        # the port sorts the names; the JAX exchanger takes the pytree's
        # flatten order: the FFD ties and the reverse runs depend on it
        assert sorted(tshapes) == list(jn) and all(tshapes[n] == s for n, s in jn.items())
        names, sizes = list(jn), [int(np.prod(s)) for s in jn.values()]
    got = partition_buckets(names, sizes, bucket_bytes, order=order)
    want = jpartition(names, sizes, bucket_bytes, order=order)
    assert [dataclass_tuple(s) for s in got] == [dataclass_tuple(s) for s in want]
    assert sorted(n for s in got for n in s.names) == sorted(names)
    if (census, bucket_bytes) == ("wordlstm", MIB4):
        assert len(got) == {"trace": 4, "reverse": 5}[order]
    if (census, bucket_bytes) == ("resnet20", MIB4):
        assert len(got) == 1 and len(got[0].names) == 61
    for s in got:
        assert bucket_num_slots(s.sizes, 0.01) == jbucket_num_slots(s.sizes, 0.01)


def dataclass_tuple(spec):
    return (spec.label, spec.names, spec.sizes, spec.offsets, spec.total, spec.solo)


def test_partition_rejects_what_jax_rejects():
    for args, kw in [((["a"], [1, 2], 8), {}), ((["a", "a"], [1, 2], 8), {}), ((["a"], [0], 8), {}),
                     ((["a"], [1], 8), {"order": "backward"})]:
        with pytest.raises(ValueError):
            partition_buckets(*args, **kw)
        with pytest.raises(ValueError):
            jpartition(*args, **kw)
    labels = [s.label for s in partition_buckets(["bucket0", "x", "y"], [10, 20, 30], 4000)]
    assert labels == [s.label for s in jpartition(["bucket0", "x", "y"], [10, 20, 30], 4000)]


@pytest.mark.parametrize("model,knobs", [("wordlstm", FLAGSHIP), ("resnet20", QUICKSTART),
                                         ("resnet20", dict(QUICKSTART, value="qsgd"))])
@pytest.mark.parametrize("order", ["trace", "reverse"])
def test_full_width_payload_bytes_match_jax(model, knobs, order):
    jn, shapes = _model_shapes(model)
    extra = dict(bucket_bytes=MIB4, bucket_order=order)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in jn.items()}
    jex = JExchanger(like, JConfig(**knobs, **extra))
    tex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs, **extra), device="cpu")
    assert tex.payload_bytes() == jex.payload_bytes(like)
    assert [s.label for s in tex.bucket_specs] == [s.label for s in jex.bucket_specs]
    for s in tex.bucket_specs:
        tc, jc = tex.codecs[s.label], jex._bucketed.codecs[s.label]
        assert (tc.k, tc.compressed) == (jc.k, jc.compressed)
        assert tex.layouts[s.label].nbytes == jex._bucketed.layouts[s.label].nbytes
    if model == "wordlstm":
        assert tex.payload_bytes() == {"trace": 1_183_968, "reverse": 1_183_992}[order]
    elif knobs["value"] == "polyfit":
        assert tex.payload_bytes() == 9_592


# -- the exchange at W workers ----------------------------------------------- #


def _inputs(W, seed=11, shapes=SHAPES):
    rng = np.random.default_rng(seed + W)
    grads = [{n: _grid(rng, s) for n, s in shapes.items()} for _ in range(W)]
    res = [{n: _grid(rng, s) for n, s in shapes.items()} for _ in range(W)]
    return grads, res


@functools.lru_cache(maxsize=None)
def _jax_bucketed(W, knobs_items):
    """JAX's bucketed exchange on a W-device mesh (one compile per W and
    config): every worker's aggregate, residuals and wire bits, and the
    exchanger."""
    knobs = dict(knobs_items)
    grads_w, res_w = _inputs(W)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jex = JExchanger(like, JConfig(**knobs), num_workers=W)

    def spmd(g, r):
        agg, new_r, wire = jex.exchange({n: x[0] for n, x in g.items()}, {n: x[0] for n, x in r.items()}, step=STEP)
        return ({n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()},
                wire.total_bits[None])

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in SHAPES}
    return jax.jit(fn)(stack(grads_w), stack(res_w)), jex


def _bucket_uniforms(jex, W, seed, codecs):
    """The draws JAX's bucket codecs make at STEP on each worker, keyed by
    bucket label."""
    out = []
    for w in range(W):
        wkey = jax.random.fold_in(jax.random.PRNGKey(seed), w)
        out.append({
            label: _t(jax.random.uniform(per_tensor_key(wkey, label, jnp.asarray(STEP, jnp.int32)),
                                         (c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size,)))
            for label, c in codecs.items() if c.val_codec is not None
        })
    return out


def _port_exchange(W, knobs, uniforms_w, grads_w, res_w):
    cfg = port.DeepReduceConfig(**knobs)

    def work(coll, g, r, u):
        ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll if W > 1 else None)
        collect = {}
        agg, new_r, wire = ex.exchange({n: _t(x) for n, x in g.items()}, {n: _t(x) for n, x in r.items()},
                                       step=STEP, uniforms=u, collect=collect)
        return agg, new_r, wire, collect

    return port.InProcessGroup(W).run(work, grads_w, res_w, uniforms_w)


@pytest.mark.parametrize("W,cfg", [(1, "qsgd"), (3, "qsgd"), (4, "qsgd"), (3, "bloom")])
def test_bucketed_exchange_bitwise_matches_jax(W, cfg):
    """Every worker's aggregate and residuals bitwise equal to JAX's
    bucketed exchange, in the pipelined and the barrier schedule; at W = 3
    with QSGD each bucket's bytes equal JAX's `PayloadLayout.pack` (once:
    JAX's eager encode is the slow part)."""
    knobs = dict(QSGD_CFG if cfg == "qsgd" else BLOOM_CFG, bucket_bytes=4800)
    (jagg, jres, jbits), jex = _jax_bucketed(W, tuple(sorted(knobs.items())))
    grads_w, res_w = _inputs(W)
    uniforms_w = _bucket_uniforms(jex, W, knobs["seed"], jex._bucketed.codecs)
    tex = port.GradientExchanger(SHAPES, port.DeepReduceConfig(**knobs), device="cpu")
    assert [s.label for s in tex.bucket_specs] == ["bucket0", "bucket1", "emb"]
    assert tex.payload_bytes() == jex.payload_bytes({n: jnp.zeros(s) for n, s in SHAPES.items()})
    for pipeline in (True, False):
        out = _port_exchange(W, dict(knobs, bucket_pipeline=pipeline), uniforms_w, grads_w, res_w)
        for r, (agg, new_r, wire, collect) in enumerate(out):
            for n in SHAPES:
                np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][r]), err_msg=f"{pipeline} {r} {n}")
                np.testing.assert_array_equal(new_r[n].numpy(), np.asarray(jres[n][r]), err_msg=f"{pipeline} {r} {n}")
            assert float(wire.total_bits) == float(jbits[r])
            assert collect["bucket_saturated"].shape == (3,)
    if (W, cfg) != (3, "qsgd"):
        return
    # one worker's buffer, bucket by bucket, against JAX's encode + pack
    w = W - 1
    buf, comp, _ = tex.encode_worker({n: _t(x) for n, x in grads_w[w].items()},
                                     {n: _t(x) for n, x in res_w[w].items()}, step=STEP, worker=w,
                                     uniforms=uniforms_w[w])
    wkey = jax.random.fold_in(jax.random.PRNGKey(knobs["seed"]), w)
    for spec in jex.bucket_specs:
        dense = jnp.concatenate([jnp.asarray(grads_w[w][n] + res_w[w][n]) for n in spec.names])
        key = per_tensor_key(wkey, spec.label, jnp.asarray(STEP, jnp.int32))
        jpay = jex._bucketed.codecs[spec.label].encode(dense, step=STEP, key=key)
        want = np.asarray(jex._bucketed.layouts[spec.label].pack(jpay))
        np.testing.assert_array_equal(buf[tex.fused.span(spec.label)].numpy(), want, err_msg=spec.label)


@pytest.mark.parametrize("codec", ["qsgd", "bloom"])
def test_solo_bucket_bitwise_equals_per_tensor_path(codec):
    """A tensor too big for any bucket is a solo bucket under its own name:
    its codec, Philox stream, bytes, aggregate and residual are the
    per-tensor path's, the QSGD draws included."""
    knobs = QSGD_CFG if codec == "qsgd" else BLOOM_CFG
    shapes = {"big": (64, 64)}
    rng = np.random.default_rng(3)
    g = {"big": _t(_grid(rng, (64, 64)) * 3)}
    r = {"big": _t(_grid(rng, (64, 64)))}
    per = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu")
    bkt = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs, bucket_bytes=1024), device="cpu")
    assert bkt.num_buckets == 1 and bkt.bucket_specs[0].solo and bkt.bucket_specs[0].label == "big"
    assert torch.equal(per.encode_worker(g, r, step=2, worker=0)[0], bkt.encode_worker(g, r, step=2, worker=0)[0])
    a1, r1, w1 = per.exchange(g, r, step=2)
    a2, r2, w2 = bkt.exchange(g, r, step=2)
    assert torch.equal(a1["big"], a2["big"]) and torch.equal(r1["big"], r2["big"])
    assert float(w1.total_bits) == float(w2.total_bits)


def test_bucket_slots_override_the_budget():
    cfg = port.DeepReduceConfig(**QSGD_CFG)
    codec = port.TensorCodec((1200,), cfg, name="bucket0", slots=bucket_num_slots((900, 300), 0.05), device="cpu")
    assert codec.k == 45 + 15 and codec.idx_codec.k == codec.k
    with pytest.raises(ValueError, match="exceeds"):
        port.TensorCodec((10,), cfg, slots=11, device="cpu")
    assert port.TensorCodec((10,), port.DeepReduceConfig(compressor="none"), slots=3, device="cpu").k == 10


# -- the divide fix: W = 3, where 1/3 is inexact ----------------------------- #


@functools.lru_cache(maxsize=None)
def _jax_w3(knobs_items):
    knobs = dict(knobs_items)
    W = 3
    rng = np.random.default_rng(5)
    # the codec's QSGD norms agree bitwise on the grid; the dense mean takes any input
    draw = _grid if knobs["deepreduce"] is not None else lambda r, s: r.normal(size=s).astype(np.float32)
    grads_w = [{n: draw(rng, s) for n, s in SHAPES.items()} for _ in range(W)]
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jex = JExchanger(like, JConfig(**knobs), num_workers=W)

    def spmd(g):
        agg, _, _ = jex.exchange({n: x[0] for n, x in g.items()}, None, step=STEP)
        return {n: x[None] for n, x in agg.items()}

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"),), out_specs=P("data"), check_vma=False)
    return jax.jit(fn)({n: jnp.stack([jnp.asarray(g[n]) for g in grads_w]) for n in SHAPES}), jex, grads_w


@pytest.mark.parametrize("arm", ["fused", "dense"])
def test_w3_means_multiply_by_the_reciprocal_like_xla(arm):
    """XLA computes `sum / 3` as `sum * fl(1/3)`. The port's means (the
    fused allgather's decode and the dense all_reduce) are bitwise equal to
    JAX's at W = 3, and the IEEE divide the port used before differs."""
    knobs = dict(QSGD_CFG, memory="none") if arm == "fused" else dict(
        compressor="none", deepreduce=None, communicator="allreduce", memory="none")
    jagg, jex, grads_w = _jax_w3(tuple(sorted(knobs.items())))
    cfg = port.DeepReduceConfig(**knobs)
    uniforms_w = None
    if arm == "fused":
        keys = [jex._keys(jax.random.fold_in(jax.random.PRNGKey(knobs["seed"]), w), jnp.asarray(STEP, jnp.int32))
                for w in range(3)]
        uniforms_w = [{n: _t(jax.random.uniform(k[n], (c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size,)))
                       for n, c in jex.codecs.items() if c.val_codec is not None} for k in keys]

    def work(coll, g, u):
        ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll)
        tg = {n: _t(x) for n, x in g.items()}
        agg = ex.exchange(tg, None, step=STEP, uniforms=u)[0]
        # the sum the mean divides, as the old code divided it
        if arm == "dense":
            old = {n: s / 3 for n, s in ex._unflatten(coll.all_reduce_sum(ex._flatten(tg)), tg).items()}
        else:
            buf = ex.encode_worker(tg, None, step=STEP, worker=coll.rank, uniforms=u)[0]
            rows = coll.all_gather(buf)
            old = {n: ex.fused.decode_sum(n, rows[:, ex.fused.span(n)])[0] / 3 for n in ex.names}
        return agg, old

    out = port.InProcessGroup(3).run(work, grads_w, uniforms_w or [None] * 3)
    differs = False
    for r, (agg, old) in enumerate(out):
        for n in SHAPES:
            np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][r]), err_msg=f"{r} {n}")
            differs |= not np.array_equal(old[n].numpy(), np.asarray(jagg[n][r]))
    assert differs, "the IEEE divide should differ from XLA's reciprocal multiply somewhere"
    assert reciprocal_f32(3) == float(np.float32(1) / np.float32(3))


def test_qsgd_decode_multiplies_by_the_reciprocal_like_xla():
    """The main path's QSGD decode over 500 buckets of random levels and
    norms: bitwise equal to the JAX package's compiled `decode`, where the
    IEEE divide `norms / q * levels` differs."""
    from deepreduce_tpu.codecs import qsgd as jqsgd
    from deepreduce_tpu_torch.codecs import qsgd as tqsgd

    rng = np.random.default_rng(9)
    b, bs, k = 500, 512, 500 * 512 - 100
    levels = rng.integers(-127, 128, size=(b, bs)).astype(np.int8)
    norms = (rng.random(b) * 10).astype(np.float32)
    data = np.concatenate([levels.view(np.uint8), norms.view(np.uint8).reshape(b, 4)], axis=1).reshape(-1)
    tmeta, jmeta = tqsgd.QSGDMeta(k=k), jqsgd.QSGDMeta(k=k)
    idx, nnz = np.arange(k, dtype=np.int32), np.int32(k)
    got = tqsgd.decode(tqsgd.QSGDPayload(_t(data.view(np.int8)), _t(idx), torch.tensor(nnz)), tmeta, (k,)).values
    want = jax.jit(lambda d: jqsgd.decode(jqsgd.QSGDPayload(d, jnp.asarray(idx), jnp.int32(k)), jmeta, (k,)).values)(
        jnp.asarray(data.view(np.int8)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    old = (_t(norms)[:, None] / 127 * _t(levels).float()).reshape(-1)[:k]
    assert not torch.equal(old, got)


# -- fences and plans -------------------------------------------------------- #

FENCES = [
    (dict(FLAGSHIP, bucket_bytes=2), "bucket-bytes-range"),
    (dict(FLAGSHIP, bucket_bytes=MIB4, bucket_order="backward"), "enum-bucket_order"),
    (dict(FLAGSHIP, bucket_order="reverse"), "bucket-order-needs-buckets"),
    (dict(FLAGSHIP, stream_exchange=True), "stream-needs-buckets"),
    (dict(FLAGSHIP, bucket_bytes=MIB4, communicator="allreduce"), "build-buckets-need-fused-allgather"),
    (dict(compressor="none", memory="none", bucket_bytes=MIB4, communicator="qar"), "build-buckets-need-fused-allgather"),
    (dict(compressor="none", deepreduce=None, memory="none", bucket_bytes=MIB4), "build-buckets-need-compression"),
    (dict(FLAGSHIP, bucket_bytes=MIB4, layer_pattern="kernel"), "build-buckets-vs-layer-pattern"),
]


@pytest.mark.parametrize("knobs,code", FENCES, ids=[c for _, c in FENCES])
def test_fences_give_jax_reason_codes(knobs, code):
    like = {"w": jnp.zeros((3000,))}
    with pytest.raises(JConfigError) as je:
        JExchanger(like, JConfig(**knobs), num_workers=2)
    assert je.value.reason_code == code
    with pytest.raises(port.ConfigError) as e:
        port.GradientExchanger({"w": (3000,)}, port.DeepReduceConfig(**knobs), device="cpu")
    assert e.value.knob == code


PLANS = {
    "fused": dict(FLAGSHIP),
    "bucketed": dict(FLAGSHIP, bucket_bytes=MIB4),
    "streamed": dict(FLAGSHIP, bucket_bytes=MIB4, bucket_order="reverse", stream_exchange=True),
    "dense": dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none"),
    "qar": dict(communicator="qar", compressor="none", memory="none"),
    **{f"rs_{m}": dict(communicator="sparse_rs", rs_mode=m) for m in ("sparse", "adaptive", "quantized", "oktopk")},
}


@pytest.mark.parametrize("arm", list(PLANS))
def test_describe_matches_jax(arm):
    like = {n: jnp.zeros(s) for n, s in SHAPES.items()}
    jex = JExchanger(like, JConfig(**PLANS[arm]), num_workers=4)
    tex = exchange.build_exchanger(SHAPES, port.DeepReduceConfig(**PLANS[arm]), device="cpu")
    jstack = jexchange.wrap_streaming(jex) or jex
    tstack = exchange.wrap_streaming(tex) or tex
    assert isinstance(jstack, JStreaming) == (arm == "streamed")
    assert exchange.describe(tstack) == jexchange.describe(jstack)
    assert [str(l) for l in exchange.leg_plan(tstack)] == [str(l) for l in jexchange.leg_plan(jstack)]
