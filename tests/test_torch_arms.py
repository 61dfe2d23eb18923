"""Port parity for the Table-4 arms beyond the flagship: the dense allreduce
baseline, Top-r, the delta-bitpacked integer index, sampled top-k, the
bloom threshold insert and the sparsifier-free direct bloom encode, and
bloom index-only, each against the JAX package on the CPU.

Deterministic stages are bitwise, on both branches of every former
`lax.cond`. QSGD is held bitwise by injecting the uniforms JAX draws, except
its bucket norms, which JAX sums in float32 (rtol 1e-6, as in
`test_torch_slice`). A two-rank gloo run checks the real collectives."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_slice import _assert_same_wire, _grad_tree, _jax_flat_params, _jax_uniforms, _t, jax_trainer_state

from deepreduce_tpu import sparse as jsparse
from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.codecs import integer as jinteger
from deepreduce_tpu.codecs import packing as jpacking
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.utils.compat import shard_map
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch import sparse as tsparse
from deepreduce_tpu_torch.codecs import bloom as tbloom
from deepreduce_tpu_torch.codecs import integer as tinteger
from deepreduce_tpu_torch.codecs import packing as tpacking
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.weights import params_from_jax

from torch_ranks import run_rank

FLAGSHIP = dict(
    compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
    index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod",
    approx_topk=False,
)
# bench.py's Table-4 arms, and the model-throughput table's index-only arm
ARMS = {
    "drqsgd_bloom": {},
    "dense": dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none"),
    "topr": dict(deepreduce=None),
    "drqsgd_delta": dict(index="integer"),
    "drqsgd_bloom_sampled": dict(compressor="topk_sampled"),
    "drqsgd_bloom_direct": dict(compressor="topk_sampled", bloom_threshold_insert=True),
    "bloom_index": dict(deepreduce="index", fpr=0.001),
}


def _knobs(arm, **kw):
    return {**FLAGSHIP, **ARMS[arm], **kw}


def _cfgs(arm, **kw):
    knobs = _knobs(arm, **kw)
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _u32(a):
    return np.asarray(a).astype(np.uint32).view(np.int32)


# -- packing and the integer codec ------------------------------------------ #


@pytest.mark.parametrize("width", [1, 5, 20, 31, 32])
def test_pack_unpack_words_match_jax(width):
    n = 77  # not a multiple of 32
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint64)  # high bits must be dropped
    vals[:2] = [0, 2**32 - 1]
    jp = jpacking.pack(jnp.asarray(vals.astype(np.uint32)), jnp.int32(width))
    tp = tpacking.pack(_t(vals.astype(np.int64)), torch.tensor(width, dtype=torch.int32))
    np.testing.assert_array_equal(tp.words.numpy(), _u32(jp.words))
    assert (int(tp.count), int(tp.width)) == (int(jp.count), int(jp.width))
    assert int(tpacking.wire_bits(tp)) == int(jpacking.wire_bits(jp))
    # at a narrower width than the budget's: trailing words stay zero
    jn = jpacking.pack(jnp.asarray(vals.astype(np.uint32)), jnp.int32(width), max_width=min(32, width + 3))
    tn = tpacking.pack(_t(vals.astype(np.int64)), torch.tensor(width, dtype=torch.int32), max_width=min(32, width + 3))
    np.testing.assert_array_equal(tn.words.numpy(), _u32(jn.words))
    # count < n: values past the count unpack to 0
    for count in (n, 40):
        jq = jpacking.PackedInts(words=jp.words, count=jnp.int32(count), width=jp.width)
        tq = tpacking.PackedInts(words=tp.words, count=torch.tensor(count, dtype=torch.int32), width=tp.width)
        np.testing.assert_array_equal(tpacking.unpack(tq, n).numpy(), np.asarray(jpacking.unpack(jq, n)).astype(np.int64))


def test_bits_needed_matches_jax():
    vals = [0, 1, 2, 3, 4, 7, 8, 255, 256, 2**20 - 1, 2**20, 2**31 - 1, 2**31, 2**32 - 1]
    for v in vals:
        got = int(tpacking.bits_needed(torch.tensor(v, dtype=torch.int64)))
        assert got == int(jpacking.bits_needed(jnp.uint32(v))) == max(1, v.bit_length()), v
    assert tpacking.budget_words(77, 5) == jpacking.budget_words(77, 5)


def _sparse_pair(d, k, nnz, seed):
    """(JAX SparseGrad, port SparseGrad): nnz distinct live indices in
    shuffled order, dead slots index 0, value 0."""
    rng = np.random.default_rng(seed)
    idx = np.zeros(k, np.int32)
    vals = np.zeros(k, np.float32)
    idx[:nnz] = rng.choice(d, size=nnz, replace=False)
    vals[:nnz] = rng.normal(size=nnz)
    j = jsparse.SparseGrad(values=jnp.asarray(vals), indices=jnp.asarray(idx), nnz=jnp.int32(nnz), shape=(d,))
    t = tsparse.SparseGrad(values=_t(vals), indices=_t(idx), nnz=torch.tensor(nnz, dtype=torch.int32), shape=(d,))
    return j, t


@pytest.mark.parametrize("d,k,nnz", [(5000, 500, 500), (5000, 500, 321), (70_001, 2000, 1999), (3, 2, 1)])
def test_integer_codec_matches_jax(d, k, nnz):
    jsp, tsp = _sparse_pair(d, k, nnz, seed=d + nnz)
    jm, tm = jinteger.IntegerMeta(k=k, d=d), tinteger.IntegerMeta(k=k, d=d)
    assert tm.max_width == jm.max_width
    jp, tp = jinteger.encode(jsp, jm), tinteger.encode(tsp, tm)
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(tp.deltas.words.numpy(), _u32(jp.deltas.words))
    assert [int(x) for x in (tp.deltas.count, tp.deltas.width, tp.nnz)] == [
        int(x) for x in (jp.deltas.count, jp.deltas.width, jp.nnz)
    ]
    assert tp.deltas.words.shape == (tm.n_words,)
    jd, td = jinteger.decode(jp, jm, (d,)), tinteger.decode(tp, tm, (d,))
    np.testing.assert_array_equal(td.indices.numpy(), np.asarray(jd.indices))
    np.testing.assert_array_equal(td.values.numpy(), np.asarray(jd.values))
    dense = tinteger.decode_dense(tp, tm, (d,))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jinteger.decode_dense(jp, jm, (d,))))
    np.testing.assert_array_equal(dense.numpy(), tsp.to_dense().numpy())
    override = np.arange(k // 2, dtype=np.float32) + 1  # a shorter value table
    np.testing.assert_array_equal(
        tinteger.decode_dense(tp, tm, (d,), values=_t(override)).numpy(),
        np.asarray(jinteger.decode_dense(jp, jm, (d,), values=jnp.asarray(override))),
    )
    assert float(tinteger.wire_bits(tp, tm)) == float(jinteger.wire_bits(jp, jm))


# -- sampled top-k ------------------------------------------------------------ #


def _tied(d, seed, nonzero_frac=1.0):
    """Gradient-like values with heavy magnitude ties (one decimal)."""
    rng = np.random.default_rng(seed)
    g = np.round(rng.normal(size=d), 1).astype(np.float32)
    g[rng.random(d) >= nonzero_frac] = 0.0
    return g


def _sample_blind(d, sample_size, seed):
    """Nonzeros only off the strided sample's positions: the sampled
    threshold is 0 although the tensor is not."""
    g = _tied(d, seed)
    g[:: d // sample_size] = 0.0
    return g


@pytest.mark.parametrize(
    "d,ratio,sample,undershoot,kind",
    [
        (20_000, 0.1, 256, 0.9, "sampled"),
        (20_000, 0.1, 256, 1.5, "sampled"),  # overfull capture: the prefix cuts it to k
        (20_001, 0.05, 300, 0.9, "sampled"),
        (20_000, 0.1, 256, 0.9, "blind"),  # zero threshold: the exact branch
        (20_000, 0.01, 256, 0.9, "sparse"),  # fewer nonzeros than the sample can see
        (500, 0.1, 256, 0.9, "static"),  # d <= 2 * sample_size
        (3000, 0.3, 256, 0.9, "static"),  # d <= 4k
    ],
)
def test_topk_sampled_matches_jax(d, ratio, sample, undershoot, kind):
    if kind == "blind":
        g = _sample_blind(d, sample, seed=d)
    elif kind == "sparse":
        g = _tied(d, seed=d, nonzero_frac=0.002)
    else:
        g = _tied(d, seed=d + sample)
    k = jsparse.num_slots(d, ratio)
    jt = jsparse.sampled_kth_magnitude(jnp.asarray(g), k, sample_size=sample, undershoot=undershoot)
    tt = tsparse.sampled_kth_magnitude(_t(g), k, sample_size=sample, undershoot=undershoot)
    assert float(tt) == float(jt)
    before = tsparse.host_branch.syncs
    j = jsparse.topk_sampled(jnp.asarray(g).reshape(-1, 1), ratio, sample_size=sample, undershoot=undershoot)
    t = tsparse.topk_sampled(_t(g).reshape(-1, 1), ratio, sample_size=sample, undershoot=undershoot)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert int(t.nnz) == int(j.nnz) and t.shape == j.shape == (d, 1)
    assert t.indices.dtype == torch.int32 and t.nnz.dtype == torch.int32
    exact = tsparse.topk(_t(g), ratio)
    if kind == "static":
        assert tsparse.host_branch.syncs == before  # decided without the device
    else:
        assert tsparse.host_branch.syncs == before + 1
        # the exact branch is taken exactly when the threshold is zero
        assert (float(tt) == 0.0) == (kind in ("blind", "sparse"))
    if kind != "sampled":
        np.testing.assert_array_equal(t.indices.numpy(), exact.indices.numpy())
        assert int(t.nnz) == k
    else:
        assert 0 < int(t.nnz) <= k


# -- the bloom threshold insert and the direct encode ----------------------- #


def _metas(k, d, fpr=0.02, threshold_insert=True):
    kw = dict(fpr=fpr, policy="p0", blocked="mod", threshold_insert=threshold_insert)
    return jbloom.BloomMeta.create(k, d, **kw), tbloom.BloomMeta.create(k, d, **kw)


def _same_bloom(tp, jp):
    np.testing.assert_array_equal(tp.words.numpy(), _u32(jp.words))
    assert int(tp.nsel) == int(jp.nsel)
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))


def test_threshold_meta_widens_budget_like_jax():
    for k, d in [(96038, 960384), (500, 5000), (1, 12)]:
        jm, tm = _metas(k, d)
        assert (tm.budget, tm.m_bits, tm.num_hash) == (jm.budget, jm.m_bits, jm.num_hash)
        assert tm.budget > _metas(k, d, threshold_insert=False)[1].budget or tm.budget == d
    with pytest.raises(ValueError, match="threshold_insert requires"):
        tbloom.BloomMeta.create(10, 100, blocked="hash", threshold_insert=True)


@pytest.mark.parametrize("d,thresh", [(5000, 0.7), (4099, 0.05), (5000, 10.0)])
def test_insert_from_dense_matches_jax(d, thresh):
    g = _tied(d, seed=d)
    jm, tm = _metas(d // 10, d)
    jw = jbloom.insert_from_dense(jnp.asarray(g), jnp.float32(thresh), jm)
    tw = tbloom.insert_from_dense(_t(g), torch.tensor(thresh, dtype=torch.float32), tm)
    np.testing.assert_array_equal(tw.numpy(), _u32(jw))
    # the filter holds every index of the threshold set
    member = tbloom.query_universe(tw, tm).numpy()
    assert member[np.abs(g) >= np.float32(thresh)].all()


@pytest.mark.parametrize("nonzero", [4000, 200])  # 200 < k: the sparsifier keeps zeros, thresh 0
def test_encode_threshold_insert_matches_jax(nonzero):
    d, ratio = 5000, 0.1
    g = np.zeros(d, np.float32)
    rng = np.random.default_rng(nonzero)
    g[rng.choice(d, size=nonzero, replace=False)] = _tied(nonzero, seed=1) + np.float32(0.05)
    jm, tm = _metas(int(d * ratio), d)
    jsp, tsp = jsparse.topk(jnp.asarray(g), ratio), tsparse.topk(_t(g), ratio)
    before = tsparse.host_branch.syncs
    jp = jbloom.encode(jsp, jnp.asarray(g), jm, threshold_insert=True)
    tp = tbloom.encode(tsp, _t(g), tm, threshold_insert=True)
    assert tsparse.host_branch.syncs == before + 1
    _same_bloom(tp, jp)
    # a zero threshold falls back to the scatter insert; a positive one
    # inserts a superset of the top-k (ties at the threshold join)
    scatter = u32.from_bits(tbloom.insert(tsp.indices, tsp.nnz, tm))
    words = u32.from_bits(tp.words)
    assert not bool((scatter & ~words).any())
    assert torch.equal(words, scatter) or nonzero >= int(d * ratio)


@pytest.mark.parametrize(
    "d,sample,kind",
    [(20_000, 256, "sampled"), (20_000, 256, "blind"), (500, 256, "static"), (960_384, 1 << 15, "embedding")],
)
def test_encode_dense_direct_matches_jax(d, sample, kind):
    if kind == "blind":
        g = _sample_blind(d, sample, seed=3)
    elif kind == "embedding":
        # the Embed_0 gradient's shape: the rows a batch touches, the rest zero
        rng = np.random.default_rng(4)
        g = np.zeros((10_004, 96), np.float32)
        rows = rng.choice(10_004, size=1280, replace=False)
        g[rows] = rng.normal(size=(1280, 96))
        g = g.reshape(-1)
    else:
        g = _tied(d, seed=d)
    jm, tm = _metas(d // 10, d)
    before = tsparse.host_branch.syncs
    jp = jbloom.encode_dense_direct(jnp.asarray(g), jm, sample_size=sample, undershoot=0.9)
    tp = tbloom.encode_dense_direct(_t(g), tm, sample_size=sample, undershoot=0.9)
    _same_bloom(tp, jp)
    assert tsparse.host_branch.syncs == before + (kind != "static")
    # decode places the true values the filter selects
    dec = tbloom.decode_dense(tp, tm, (d,)).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jbloom.decode_dense(jp, jm, (d,))))
    assert np.all((dec == 0) | (dec == g))


# -- TensorCodec per arm -------------------------------------------------------- #


def _assert_same_payload(tc, tpay, jpay):
    """Every leaf bitwise, except the QSGD norms (rtol 1e-6) and the levels
    of a bucket whose norm bytes differ."""
    jleaves = jax.tree_util.tree_leaves(jpay)
    tleaves = tpay.leaves()
    assert len(jleaves) == len(tleaves) == len(tc.payload_specs())
    for i, (jl, tl) in enumerate(zip(jleaves, tleaves)):
        jl = np.asarray(jl)
        assert tuple(tl.shape) == jl.shape, i
        if i != tc.rows_leaf:
            np.testing.assert_array_equal(tl.numpy().view(jl.dtype), jl, err_msg=f"leaf {i}")
            continue
        meta = tc.val_codec.meta
        ra = tl.numpy().reshape(meta.num_buckets, meta.bucket_size + 4)
        rb = jl.reshape(meta.num_buckets, meta.bucket_size + 4)
        na, nb = ra[:, meta.bucket_size :].copy().view(np.float32), rb[:, meta.bucket_size :].copy().view(np.float32)
        np.testing.assert_allclose(na, nb, rtol=1e-6)
        same = (na == nb).reshape(-1)
        np.testing.assert_array_equal(ra[same], rb[same])


CODEC_CASES = [
    ("dense", {}), ("topr", {}), ("drqsgd_bloom", {}), ("drqsgd_delta", {}), ("drqsgd_bloom_sampled", {}),
    ("drqsgd_bloom_direct", {}), ("bloom_index", {}), ("bloom_index", dict(index="integer")),
    ("drqsgd_bloom", dict(bloom_threshold_insert=True)),
]


@pytest.mark.parametrize("arm,extra", CODEC_CASES, ids=[a + ("+" + "+".join(e) if e else "") for a, e in CODEC_CASES])
def test_tensor_codec_per_arm_matches_jax(arm, extra):
    shape = (64, 50)  # d = 3200 > max(4k, 2 * 256): the sampled path runs
    rng = np.random.default_rng(0)
    g = _tied(3200, seed=9).reshape(shape)
    g[rng.random(shape) < 0.4] = 0.0
    jcfg, tcfg = _cfgs(arm, topk_sample_size=256, **extra)
    jc = JTensorCodec(shape, jcfg, name="w")
    tc = port.TensorCodec(shape, tcfg, name="w", device="cpu")
    assert (tc.compressed, tc.dense_fallback, tc.direct_bloom, tc.k) == (
        jc.compressed, jc.dense_fallback, jc.direct_bloom, jc.k,
    )
    assert (tc.val_codec is None) == (jc.val_codec is None)
    key = jax.random.PRNGKey(5)
    jpay = jc.encode(jnp.asarray(g), step=0, key=key)
    tpay = tc.encode(_t(g), uniforms=_jax_uniforms(jc, key) if tc.val_codec is not None else None)
    _assert_same_payload(tc, tpay, jpay)
    # the decode bitwise: the port's payload through JAX's compiled decode
    # (the QSGD norms it carries may sit one ulp from JAX's own, above)
    jleaves = jax.tree_util.tree_leaves(jpay)
    same_pay = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jpay), [jnp.asarray(t.numpy().view(np.asarray(j).dtype)) for t, j in
                                             zip(tpay.leaves(), jleaves)])
    np.testing.assert_array_equal(tc.decode(tpay).numpy(), np.asarray(jax.jit(jc.decode)(same_pay)))
    js, ts = jc.wire_stats(jpay), tc.wire_stats(tpay)
    assert float(ts.rel_volume()) == float(js.rel_volume())
    assert float(ts.saturated) == float(js.saturated)
    # round trip through the payload's wire leaves
    again = tc.payload_from_leaves(list(tpay.leaves()))
    assert torch.equal(tc.decode(again), tc.decode(tpay))


def test_threshold_insert_rejects_non_magnitude_selection():
    knobs = _knobs("drqsgd_bloom", compressor="none", bloom_threshold_insert=True)
    with pytest.raises(ValueError, match="bloom_threshold_insert"):
        JTensorCodec((3000,), JConfig(**knobs))
    with pytest.raises(ValueError, match="bloom_threshold_insert"):
        port.TensorCodec((3000,), port.DeepReduceConfig(**knobs), device="cpu")


def test_wordlstm_payload_bytes_per_arm():
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    expected = {
        "drqsgd_bloom": 1_189_616, "dense": 16_202_992, "topr": 3_240_652, "drqsgd_delta": 1_385_424,
        "drqsgd_bloom_sampled": 1_189_616, "drqsgd_bloom_direct": 1_211_288, "bloom_index": 3_717_936,
    }
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    for arm, nbytes in expected.items():
        jcfg, tcfg = _cfgs(arm)
        ex = port.GradientExchanger(shapes, tcfg, device="cpu")
        assert ex.payload_bytes() == JExchanger(like, jcfg).payload_bytes(like) == nbytes, arm
    assert sum(4 * int(np.prod(s)) for s in shapes.values()) == expected["dense"]


# -- the 4-worker exchange against the JAX mesh ------------------------------ #


@pytest.mark.parametrize("arm", ["drqsgd_delta", "drqsgd_bloom_direct", "bloom_index", "dense"])
def test_four_worker_exchange_matches_jax_mesh(arm):
    W, step, seed = 4, 3, 7
    shapes = {"b": (40,), "a/kernel": (48, 40), "c": (3000,), "d/bias": (12,)}
    rng = np.random.default_rng(11)
    res_w = [_grad_tree(rng, shapes) for _ in range(W)]
    grads_w = [_grad_tree(rng, shapes) for _ in range(W)]
    jcfg, tcfg = _cfgs(arm, seed=seed, min_compress_size=100, topk_sample_size=256)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, jcfg)
    tex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert tex.payload_bytes() == jex.payload_bytes(like)
    memory = tcfg.memory == "residual"
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in shapes}

    def spmd(g, r):
        g = {n: x[0] for n, x in g.items()}
        r = {n: x[0] for n, x in r.items()} if memory else None
        agg, new_r, wire = jex.exchange(g, r, step=step)
        new_r = new_r if memory else g
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}, wire.rel_volume()[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    jagg, jres, jrel = jax.jit(fn)(stack(grads_w), stack(res_w))

    if tex.dense:
        # one rank: the residual state passes through and the wire is dense
        g0 = {n: _t(grads_w[0][n]) for n in shapes}
        agg, res, wire = tex.exchange(g0, None, step=step)
        assert res is None and float(wire.rel_volume()) == 1.0 == float(jrel[0])
        assert all(agg[n] is g0[n] for n in shapes)
        # W ranks: the mean of one flat all_reduce (see the gloo test), here
        # summed in rank order
        for n in shapes:
            mean = sum(_t(grads_w[w][n]) for w in range(W)) / W
            np.testing.assert_allclose(mean.numpy(), np.asarray(jagg[n][0]), rtol=1e-6, atol=1e-7)
        return
    bufs, comps = [], []
    for w in range(W):
        wkey = jax.random.fold_in(jax.random.PRNGKey(seed), w)
        keys = jex._keys(wkey, jnp.asarray(step, jnp.int32))
        uniforms = {n: _jax_uniforms(jex.codecs[n], keys[n]) for n in shapes if jex.codecs[n].val_codec is not None}
        tg = {n: _t(grads_w[w][n]) for n in shapes}
        tr = {n: _t(res_w[w][n]) for n in shapes}
        buf, comp, stats = tex.encode_worker(tg, tr, step=step, worker=w, uniforms=uniforms)
        jcomp = {n: jnp.asarray(grads_w[w][n]) + jnp.asarray(res_w[w][n]) for n in shapes}
        jpay = {n: jex.codecs[n].encode(jcomp[n], step=step, key=keys[n]) for n in shapes}
        _assert_same_wire(tex, buf, _t(jex._pack_fused(jpay)))
        np.testing.assert_allclose(float(stats.rel_volume()), float(jrel[w]), rtol=1e-6)
        bufs.append(buf)
        comps.append(comp)
    gathered = torch.stack(bufs)
    for w in range(W):
        agg, own = tex.decode_aggregate(gathered, own=w)
        new_res = tmemory.update(comps[w], own)
        for n in shapes:
            np.testing.assert_allclose(agg[n].numpy(), np.asarray(jagg[n][w]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(new_res[n].numpy(), np.asarray(jres[n][w]), rtol=1e-6, atol=1e-6)


# -- a real two-rank exchange over gloo --------------------------------------- #


def test_two_rank_gloo_exchange_equals_virtual_workers(tmp_path):
    """Two processes exchange through `GradientExchanger.exchange` over a
    gloo group (the real `all_gather_into_tensor` / `all_reduce`, and for
    the in-collective communicators `all_to_all_single`, int8
    `reduce_scatter_tensor` and `all_reduce` MAX); each rank's aggregate and
    residual equal the single-process decode of the same two workers, or
    the in-process group's exchange of them, bitwise."""
    world, step = 2, 4
    shapes = {"a/kernel": (48, 40), "b": (40,), "c": (3000,)}
    arms = [("drqsgd_bloom", _knobs("drqsgd_bloom", seed=3, min_compress_size=100), step),
            # two buckets, {a/kernel, b} and c alone, gathered pipelined
            ("drqsgd_bloom_bucketed", _knobs("drqsgd_bloom", seed=3, min_compress_size=100, bucket_bytes=8000), step),
            ("dense", _knobs("dense"), step),
            ("qar", dict(communicator="qar", compressor="none", memory="none", seed=3), step),
            ("rs_quantized", dict(communicator="sparse_rs", rs_mode="quantized", compress_ratio=0.1, memory="residual",
                                  seed=3), step)]
    rng = np.random.default_rng(21)
    inputs = {
        arm: [({n: _t(x) for n, x in _grad_tree(rng, shapes).items()},
               {n: _t(x) for n, x in _grad_tree(rng, shapes).items()} if knobs["memory"] == "residual" else None)
              for _ in range(world)]
        for arm, knobs, _ in arms
    }
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=run_rank, args=(r, world, store, outs[r], arms, shapes, inputs)) for r in range(world)]
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
    assert [p.exitcode for p in procs] == [0] * world
    got = [torch.load(o) for o in outs]

    # the same workers, one process
    for arm, knobs, st in arms:
        cfg = port.DeepReduceConfig(**knobs)
        if cfg.communicator in ("qar", "sparse_rs"):
            def work(coll, grads, res, cfg=cfg, st=st):
                ex = port.GradientExchanger(shapes, cfg, device="cpu", group=coll)
                return ex.exchange(grads, res, step=st)[:2]

            want = port.InProcessGroup(world).run(work, *zip(*inputs[arm]))
            for r in range(world):
                (gagg, gres), (agg, res) = got[r][arm], want[r]
                assert (gres is None) == (res is None) == (cfg.memory == "none")
                for n in shapes:
                    assert torch.equal(gagg[n], agg[n]), (arm, r, n)
                    assert res is None or torch.equal(gres[n], res[n]), (arm, r, n)
            continue
        ex = port.GradientExchanger(shapes, cfg, device="cpu")
        assert ex.num_buckets == (2 if cfg.bucket_bytes else 0)
        if ex.dense:
            mean = {n: (inputs[arm][0][0][n] + inputs[arm][1][0][n]) / world for n in shapes}
            for r in range(world):
                agg, res = got[r][arm]
                assert res is None
                for n in shapes:
                    assert torch.equal(agg[n], mean[n]), (arm, r, n)
            continue
        bufs, comps = [], []
        for w in range(world):
            buf, comp, _ = ex.encode_worker(*inputs[arm][w], step=st, worker=w)
            bufs.append(buf)
            comps.append(comp)
        for r in range(world):
            agg, own = ex.decode_aggregate(torch.stack(bufs), own=r)
            new_res = tmemory.update(comps[r], own)
            gagg, gres = got[r][arm]
            for n in shapes:
                assert torch.equal(gagg[n], agg[n]), (arm, r, n)
                assert torch.equal(gres[n], new_res[n]), (arm, r, n)


# -- two training steps on a small WordLSTM --------------------------------- #


@pytest.mark.parametrize("arm", ["dense", "drqsgd_bloom_direct"])
def test_two_step_wordlstm_trainer_matches_jax(arm):
    vocab, embed, hidden, batch, seq, lr, mom, seed = 64, 8, 16, 4, 5, 0.1, 0.9, 3
    # sample 32: every compressed leaf (over 100 elements) takes the
    # sampled threshold
    jcfg, tcfg = _cfgs(arm, seed=seed, min_compress_size=100, topk_sample_size=32)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(2, batch, seq + 1)).astype(np.int32)
    batches = [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(2)]

    jtr = JTrainer(JWordLSTM(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden), jcfg,
                   optax.sgd(lr, momentum=mom), shared_mesh(1))
    jstate = jax_trainer_state(jtr, jax.random.PRNGKey(0), batches[0], shared_mesh(1))
    flat0 = _jax_flat_params(jstate.params)
    tmodel = WordLSTM(vocab, embed, hidden)
    tmodel.load_flax_params(params_from_jax(flat0))
    ttr = port.Trainer(tmodel, tcfg, lr=lr, momentum=mom, device="cpu")
    tstate = ttr.init_state()
    assert (tstate.residuals is None) == (arm == "dense")
    codecs = jtr.exchanger.codecs
    assert sum(c.direct_bloom for c in ttr.exchanger.codecs.values()) == sum(c.direct_bloom for c in codecs.values())
    syncs = tsparse.host_branch.syncs
    for i, (x, y) in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        wkey = jax.random.fold_in(key, 0)
        uniforms = {
            n: _jax_uniforms(c, per_tensor_key(wkey, n, jnp.asarray(i, jnp.int32)))
            for n, c in codecs.items() if c.val_codec is not None
        }
        jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
        tstate, tloss, twire = ttr.step(tstate, (_t(x).long(), _t(y).long()), uniforms=uniforms)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    if arm == "dense":
        assert float(twire.rel_volume()) == 1.0 and tsparse.host_branch.syncs == syncs
    else:
        assert tsparse.host_branch.syncs > syncs  # the sampled threshold really ran
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    assert tstate.step == 2


def test_config_accepts_every_arm():
    for arm in ARMS:
        assert port.from_params(_knobs(arm)) == port.DeepReduceConfig(**_knobs(arm))
    cfg = port.DeepReduceConfig(**_knobs("drqsgd_bloom", bloom_threshold_insert=True))
    assert cfg.codec_params()["bloom_threshold_insert"] is True
    assert (cfg.topk_sample_size, cfg.topk_undershoot) == (JConfig().topk_sample_size, JConfig().topk_undershoot)
    for knob, val in [("topk_sample_size", 0), ("topk_undershoot", 0.0), ("bloom_threshold_insert", 1)]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**_knobs("drqsgd_bloom", **{knob: val}))
        assert e.value.knob == knob
