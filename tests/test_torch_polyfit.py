"""Port parity for the README quick start's codecs: PolyFit, the classic
bloom layout and the 'both' mode with a reordering value codec, against
the JAX package on the CPU.

Bitwise: PolyFit's segment structure (`segment_sizes`, `num_pos`, the
sort order), its Legendre basis and jitter against the jitted JAX program
(the fused multiply-adds XLA:CPU contracts them to), the classic filter (hash positions, words, membership, nsel)
and the bit-packed mapping (words, count, width). Not bitwise, with the
tolerance stated where it is checked:
- the coefficients: the normal equations are summed in another order and
  solved by another LU than XLA's, so rtol 1e-4 and atol 1e-6 * max|v|;
- the decoded values, evaluated from those coefficients: atol 1e-5 *
  max|v| (the basis rows are bounded by 1, six terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_slice import _grad_tree, _t

from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.codecs import polyfit as jpoly
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu.utils.compat import shard_map
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch.codecs import bloom as tbloom
from deepreduce_tpu_torch.codecs import packing
from deepreduce_tpu_torch.codecs import polyfit as tpoly
from deepreduce_tpu_torch.sparse import SparseGrad, topk

# the README quick start (README.md, benchmarks/train.py's default config)
QUICKSTART = dict(
    compressor="topk", compress_ratio=0.01, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="polyfit", fpr=0.001, policy="leftmost",
)
COEFF_RTOL = 1e-4
COEFF_ATOL = 1e-6  # times max |v|
DECODE_ATOL = 1e-5  # times max |v|


def _cfgs(**kw):
    knobs = {**QUICKSTART, **kw}
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _u32(a):
    return np.asarray(a).astype(np.uint32).view(np.int32)


# -- PolyFit ------------------------------------------------------------------ #


def _boundary_num_pos(k):
    """num_pos values around every place a segment size changes: the
    MIN_SEGMENT gate (num_pos * r > 30) and each floor step of num_pos * r,
    for the positive and the negative side."""
    out = {0, 1, k - 1, k}
    for r in jpoly.RATIOS:
        for n in (int(31 / r), int(1 / r), int(2 / r), int(7 / r)):
            for side in (n, k - n):
                out.update(side + e for e in (-1, 0, 1))
    return sorted(n for n in out if 0 <= n <= k)


@pytest.mark.parametrize("k", [20, 155, 368, 5000, 96_038, 405_000])
def test_segment_sizes_bitwise(k):
    if k <= 5000:
        num_pos = list(range(k + 1))
    else:
        rng = np.random.default_rng(k)
        num_pos = sorted(set(_boundary_num_pos(k)) | set(rng.integers(0, k + 1, size=64).tolist()))
    ref = np.asarray(jax.vmap(lambda n: jpoly.segment_sizes(k, n))(jnp.asarray(num_pos, jnp.int32)))
    got = np.stack([tpoly.segment_sizes(k, torch.tensor(n, dtype=torch.int32)).numpy() for n in num_pos])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(axis=1) == k).all()
    # the gate and the floors really move segments in this sweep
    assert len({tuple(r) for r in got}) > (1 if k < 155 else 3)


def test_legendre_basis_within_one_ulp():
    """Bitwise against the jitted basis (what the JAX Trainer and exchanger
    run): XLA:CPU contracts the recurrence into fused multiply-adds, which
    `numerics.fma_f32` rounds once as well; the eager basis differs from the
    jitted one by up to thousands of ulp near the roots of P_m. The jitter
    is bitwise too."""
    t = np.random.default_rng(0).uniform(-1, 1, size=4096).astype(np.float32)
    t[:3] = [-1.0, 0.0, 1.0]
    for degree in (0, 1, 5):
        ref = np.asarray(jax.jit(jpoly._legendre_basis, static_argnums=1)(jnp.asarray(t), degree))
        got = tpoly._legendre_basis(_t(t), degree).numpy()
        assert got.shape == ref.shape == (4096, degree + 1)
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    a = np.random.default_rng(1).uniform(0, 1, size=(22, 6, 6)).astype(np.float32) ** 3 * np.float32(1e4)
    for p in (1, 3, 6):
        jit = jax.jit(lambda m: 1e-6 * jnp.trace(m, axis1=-2, axis2=-1)[:, None, None] / p + 1e-12)
        ref = np.asarray(jit(jnp.asarray(a[:, :p, :p])))
        got = tpoly.jitter(_t(a[:, :p, :p]), p).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _values(k, kind, seed):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=k) * rng.uniform(0.5, 2.0, size=k)).astype(np.float32)
    if kind == "positive":
        v = np.abs(v) + np.float32(0.01)
    elif kind == "dead":  # a bloom value table with dead slots (0.0) at its end
        v[k - k // 3 :] = 0.0
    elif kind == "ties":
        v = np.round(v, 1).astype(np.float32)
    return v


@pytest.mark.parametrize("k,kind", [(20, "mixed"), (368, "mixed"), (368, "dead"), (368, "positive"),
                                    (5000, "ties"), (5000, "mixed")])
def test_encode_decode_matches_jax(k, kind):
    v = _values(k, kind, seed=k)
    idx = np.random.default_rng(1).permutation(3 * k)[:k].astype(np.int32)
    jm, tm = jpoly.PolyFitMeta(k=k), tpoly.PolyFitMeta(k=k)
    jsp = JSparseGrad(values=jnp.asarray(v), indices=jnp.asarray(idx), nnz=jnp.int32(k), shape=(3 * k,))
    tsp = SparseGrad(values=_t(v), indices=_t(idx), nnz=torch.tensor(k, dtype=torch.int32), shape=(3 * k,))
    jp, tp = jpoly.encode(jsp, jm), tpoly.encode(tsp, tm)
    assert int(tp.num_pos) == int(jp.num_pos) and tp.num_pos.dtype == torch.int32
    np.testing.assert_array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    vmax = float(np.abs(v).max())
    assert tp.coeffs.shape == (tm.num_segments, tm.degree + 1)
    np.testing.assert_allclose(tp.coeffs.numpy(), np.asarray(jp.coeffs), rtol=COEFF_RTOL, atol=COEFF_ATOL * vmax)
    jd, td = jpoly.decode(jp, jm, (3 * k,)), tpoly.decode(tp, tm, (3 * k,))
    np.testing.assert_array_equal(td.indices.numpy(), np.asarray(jd.indices))
    np.testing.assert_allclose(td.values.numpy(), np.asarray(jd.values), rtol=0, atol=DECODE_ATOL * vmax)
    assert int(td.nnz) == k
    assert float(tpoly.wire_bits(tp, tm)) == float(jpoly.wire_bits(jp, jm))
    # the fit follows the sorted curve: far closer than the values' spread
    sorted_v = np.sort(v)[::-1]
    assert np.abs(td.values.numpy() - sorted_v).mean() < 0.1 * np.abs(sorted_v).mean()


def test_presorted_values_skip_the_sort():
    v = np.sort(_values(368, "mixed", seed=3))[::-1].copy()
    idx = np.arange(368, dtype=np.int32)
    jm, tm = jpoly.PolyFitMeta(k=368, sort=True), tpoly.PolyFitMeta(k=368, sort=True)
    jp = jpoly.encode(JSparseGrad(jnp.asarray(v), jnp.asarray(idx), jnp.int32(368), (368,)), jm)
    tp = tpoly.encode(SparseGrad(_t(v), _t(idx), torch.tensor(368, dtype=torch.int32), (368,)), tm)
    np.testing.assert_array_equal(tp.indices.numpy(), idx)
    np.testing.assert_allclose(tp.coeffs.numpy(), np.asarray(jp.coeffs), rtol=COEFF_RTOL,
                               atol=COEFF_ATOL * float(np.abs(v).max()))


# -- the classic bloom layout ---------------------------------------------------- #


def test_hash_seeds_and_positions_bitwise():
    for h in (1, 11, 12):
        np.testing.assert_array_equal(tbloom.hash_seeds(h).numpy(), np.asarray(jbloom.hash_seeds(h)).astype(np.int64))
    idx = np.random.default_rng(0).integers(0, 5_000_000, size=3000).astype(np.int32)
    idx[:2] = [0, 2**31 - 1]
    for m_bits in (320, 5312, 1 << 20):
        ref = np.asarray(jbloom.hash_positions(jnp.asarray(idx), jbloom.hash_seeds(11), m_bits))
        got = tbloom.hash_positions(_t(idx), tbloom.hash_seeds(11), m_bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


# the 19 compressed leaves of ResNet-20 at the quick start, and a universe
# above one query chunk (65,536)
CLASSIC_GEOMETRY = [(2304, 23), (4608, 46), (9216, 92), (2048, 20), (18432, 184), (36864, 368), (73728, 737)]


@pytest.mark.parametrize("d,k", CLASSIC_GEOMETRY)
def test_classic_meta_geometry_matches(d, k):
    j = jbloom.BloomMeta.create(k, d, fpr=0.001, policy="leftmost", blocked=False)
    t = tbloom.BloomMeta.create(k, d, fpr=0.001, policy="leftmost", blocked=False)
    assert (t.m_bits, t.num_hash, t.fpr, t.budget, t.blocked) == (j.m_bits, j.num_hash, j.fpr, j.budget, j.blocked)
    assert t == tbloom.BloomMeta.create(k, d, fpr=0.001)  # classic is the default layout


@pytest.mark.parametrize("d,k,nnz_cut", [(2048, 20, 0), (36864, 368, 0), (36864, 368, 50), (73728, 737, 3)])
def test_classic_insert_query_encode_bitwise(d, k, nnz_cut):
    rng = np.random.default_rng(d + nnz_cut)
    g = rng.normal(size=d).astype(np.float32)
    jm = jbloom.BloomMeta.create(k, d, fpr=0.001, blocked=False)
    tm = tbloom.BloomMeta.create(k, d, fpr=0.001)
    tsp = topk(_t(g), k / d, k=k)
    nnz = k - nnz_cut  # dead slots re-point at the first index
    idx = tsp.indices.numpy()
    jwords = np.asarray(jbloom.insert(jnp.asarray(idx), jnp.int32(nnz), jm))
    twords = tbloom.insert(tsp.indices, torch.tensor(nnz, dtype=torch.int32), tm)
    assert twords.shape == (tm.n_words,) and twords.dtype == torch.int32
    np.testing.assert_array_equal(twords.numpy(), _u32(jwords))
    jmask = np.asarray(jbloom.query_universe(jnp.asarray(jwords), jm))
    tmask = tbloom.query_universe(twords, tm).numpy()
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask[idx[:nnz]].all()  # no false negatives
    tcut = SparseGrad(tsp.values, tsp.indices, torch.tensor(nnz, dtype=torch.int32), (d,))
    jcut = JSparseGrad(jnp.asarray(tsp.values.numpy()), jnp.asarray(idx), jnp.int32(nnz), (d,))
    jp, tp = jbloom.encode(jcut, jnp.asarray(g), jm), tbloom.encode(tcut, _t(g), tm)
    np.testing.assert_array_equal(tp.words.numpy(), _u32(jp.words))
    assert int(tp.nsel) == int(jp.nsel)
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(tbloom.decode_dense(tp, tm, (d,)).numpy(), np.asarray(jbloom.decode_dense(jp, jm, (d,))))


def test_classic_layout_rejects_the_mod_only_encodes():
    tm = tbloom.BloomMeta.create(20, 2048, fpr=0.001)
    with pytest.raises(ValueError, match="mod"):
        tbloom.insert_from_dense(torch.zeros(2048), torch.tensor(0.5), tm)
    with pytest.raises(ValueError, match="mod"):
        tbloom.encode_dense_direct(torch.zeros(2048), tm)
    with pytest.raises(ValueError, match="threshold_insert requires"):
        tbloom.BloomMeta.create(20, 2048, blocked=False, threshold_insert=True)


# -- 'both' with PolyFit: the TensorCodec ----------------------------------------- #


def _coeffs_leaf(tc):
    return len(tc.idx_codec.payload_specs(0))


def _assert_same_payload(tc, tleaves, jleaves, vmax):
    """Every leaf of a quick-start payload bitwise, except PolyFit's
    coefficients (COEFF_RTOL, COEFF_ATOL * vmax)."""
    assert len(tleaves) == len(jleaves) == len(tc.payload_specs())
    for i, (tl, jl) in enumerate(zip(tleaves, jleaves)):
        jl = np.asarray(jl)
        assert tuple(tl.shape) == jl.shape, i
        if tc.compressed and i == _coeffs_leaf(tc):
            np.testing.assert_allclose(tl.numpy(), jl, rtol=COEFF_RTOL, atol=COEFF_ATOL * vmax, err_msg="coeffs")
        else:
            np.testing.assert_array_equal(tl.numpy().view(jl.dtype), jl, err_msg=f"leaf {i}")


@pytest.mark.parametrize("shape", [(1, 1, 32, 64), (3, 3, 16, 16), (3, 3, 64, 64), (3, 3, 128, 64), (64, 10)])
def test_tensor_codec_both_polyfit_matches_jax(shape):
    g = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jcfg, tcfg = _cfgs()
    jc = JTensorCodec(shape, jcfg, name="w")
    tc = port.TensorCodec(shape, tcfg, name="w", device="cpu")
    assert (tc.compressed, tc.dense_fallback, tc.k) == (jc.compressed, jc.dense_fallback, jc.k)
    jpay = jc.encode(jnp.asarray(g), step=0)
    tpay = tc.encode(_t(g))
    vmax = float(np.abs(g).max())
    _assert_same_payload(tc, tpay.leaves(), jax.tree_util.tree_leaves(jpay), vmax)
    if tc.compressed:
        assert tc.rows_leaf is None and tc.map_width == jc._map_width
        m = tpay.mapping
        assert (int(m.count), int(m.width)) == (tc.val_codec.k, tc.map_width)
        # the mapping is the order PolyFit sorted the value table in
        order = torch.argsort(-tc.encode_index(_t(g)).values, stable=True)
        np.testing.assert_array_equal(packing.unpack(m, tc.val_codec.k).numpy(), order.numpy())
    tdec, jdec = tc.decode(tpay).numpy(), np.asarray(jc.decode(jpay))
    np.testing.assert_allclose(tdec, jdec, rtol=0, atol=DECODE_ATOL * vmax)
    # the decode places values exactly where the JAX package does
    np.testing.assert_array_equal(tdec != 0, jdec != 0)
    js, ts = jc.wire_stats(jpay), tc.wire_stats(tpay)
    assert float(ts.rel_volume()) == float(js.rel_volume())
    assert float(ts.index_bits) == float(js.index_bits) and float(ts.value_bits) == float(js.value_bits)
    again = tc.payload_from_leaves(list(tpay.leaves()))
    assert torch.equal(tc.decode(again), tc.decode(tpay))


# -- the four-worker exchange ------------------------------------------------------ #


def test_four_worker_exchange_quickstart_matches_jax_mesh():
    W, step, seed = 4, 3, 7
    shapes = {"conv/kernel": (3, 3, 16, 16), "b": (16,), "c": (3000,), "d/kernel": (64, 10), "e": (2, 2, 32, 64)}
    rng = np.random.default_rng(13)
    res_w = [_grad_tree(rng, shapes) for _ in range(W)]
    grads_w = [_grad_tree(rng, shapes) for _ in range(W)]
    jcfg, tcfg = _cfgs(seed=seed)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, jcfg)
    tex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert tex.names == jex.names
    assert tex.payload_bytes() == jex.payload_bytes(like)
    assert sum(c.compressed for c in tex.codecs.values()) == 3
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in shapes}

    def spmd(g, r):
        g = {n: x[0] for n, x in g.items()}
        r = {n: x[0] for n, x in r.items()}
        agg, new_r, wire = jex.exchange(g, r, step=step)
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}, wire.rel_volume()[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    jagg, jres, jrel = jax.jit(fn)(stack(grads_w), stack(res_w))

    bufs, comps = [], []
    for w in range(W):
        tg = {n: _t(grads_w[w][n]) for n in shapes}
        tr = {n: _t(res_w[w][n]) for n in shapes}
        buf, comp, stats = tex.encode_worker(tg, tr, step=step, worker=w)
        jcomp = {n: jnp.asarray(grads_w[w][n]) + jnp.asarray(res_w[w][n]) for n in shapes}
        jbuf = _t(jex._pack_fused({n: jex.codecs[n].encode(jcomp[n], step=step) for n in shapes}))
        assert buf.shape == jbuf.shape
        for n in tex.names:
            lay, lo = tex.layouts[n], tex.offsets[n]
            vmax = float(np.abs(np.asarray(jcomp[n])).max())
            _assert_same_payload(tex.codecs[n], lay.unpack(buf[lo : lo + lay.nbytes]),
                                 [l.numpy() for l in lay.unpack(jbuf[lo : lo + lay.nbytes])], vmax)
        np.testing.assert_allclose(float(stats.rel_volume()), float(jrel[w]), rtol=1e-6)
        bufs.append(buf)
        comps.append(comp)
    gathered = torch.stack(bufs)
    for w in range(W):
        agg, own = tex.decode_aggregate(gathered, own=w)
        new_res = tmemory.update(comps[w], own)
        for n in shapes:
            vmax = max(float(np.abs(grads_w[u][n] + res_w[u][n]).max()) for u in range(W))
            np.testing.assert_allclose(agg[n].numpy(), np.asarray(jagg[n][w]), rtol=0, atol=DECODE_ATOL * vmax)
            np.testing.assert_allclose(new_res[n].numpy(), np.asarray(jres[n][w]), rtol=0, atol=DECODE_ATOL * vmax)


def test_config_accepts_the_quickstart():
    cfg = port.from_params(QUICKSTART)
    assert cfg == port.DeepReduceConfig(**QUICKSTART)
    assert (cfg.bloom_blocked, cfg.poly_degree, cfg.sort) == (JConfig().bloom_blocked, JConfig().poly_degree, JConfig().sort)
    assert cfg.codec_params()["poly_degree"] == 5
    for knob, val in [("index", "hash"), ("value", "polyfit_host"), ("sort", 1), ("poly_degree", -1)]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**{**QUICKSTART, knob: val})
        assert e.value.knob == knob
