"""Port parity for the on-device codec zoo against the JAX package on the
CPU: the run-length index, the Fit-DExp, PolySeg, PolyFit (value-only) and
count-sketch value codecs, the bloom P1 / approximate-P2 policies and
hash layout, the random-k and threshold sparsifiers, and the value-only
wrapper mode, per arm of the port's codec-zoo phase.

Bitwise: RLE (words, count, width, decode), the count sketch (table and
decode), the orders and signed indices of Fit-DExp and PolySeg, PolySeg's
breaks, every payload byte of the integer and QSGD arms given JAX's
uniforms (the QSGD norms to rtol 1e-6, as elsewhere), the wire stats and
the full-width payload bytes. Not bitwise, with the reason:
- Fit-DExp's decoded values, to DEXP_ATOL * max|v|: XLA scans the
  cumulative trapezoid sums in another order than `torch.cumsum` (neither
  is a left-to-right sum, checked against numpy), and the 4x4 LU, the
  exponentials and the 2-column least squares (a float64 pseudo-inverse
  here, a float32 SVD there) round differently; the integral method's
  exponents amplify those roundings;
- PolySeg's and PolyFit's coefficients (COEFF_RTOL / COEFF_ATOL, on
  segments of at least 64 values: a shorter segment's degree-5 system is
  decided by the jitter) and their decoded values (DECODE_ATOL * max|v|):
  the normal equations are summed and solved by another LU.
JAX functions are jitted once at module level and shared."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _t

from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.codecs import countsketch as jcs
from deepreduce_tpu.codecs import doubleexp as jdexp
from deepreduce_tpu.codecs import polyseg as jpseg
from deepreduce_tpu.codecs import rle as jrle
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu.sparse import randomk as jrandomk
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.codecs import bloom as tbloom
from deepreduce_tpu_torch.codecs import countsketch as tcs
from deepreduce_tpu_torch.codecs import doubleexp as tdexp
from deepreduce_tpu_torch.codecs import polyseg as tpseg
from deepreduce_tpu_torch.codecs import rle as trle
from deepreduce_tpu_torch.models import ResNet20, WordLSTM
from deepreduce_tpu_torch.ops import qsgd_encode_rows
from deepreduce_tpu_torch.sparse import SparseGrad

DEXP_ATOL = 5e-4  # times max |v|
COEFF_RTOL, COEFF_ATOL = 1e-4, 1e-6  # the atol times max |v|
DECODE_ATOL = 1e-5  # times max |v|

FLAGSHIP = dict(
    compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
    index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", approx_topk=False,
)
QUICKSTART = dict(
    compressor="topk", compress_ratio=0.01, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="polyfit", fpr=0.001, policy="leftmost",
)
# the codec-zoo arms: (model, base knobs, knobs over them, full-width payload
# bytes of the JAX package's GradientExchanger.payload_bytes)
ZOO = {
    "drqsgd_bloom_p1": ("wordlstm", FLAGSHIP, dict(policy="random"), 1_109_120),
    "drqsgd_bloom_p2a": ("wordlstm", FLAGSHIP, dict(policy="conflict_sets_approx"), 1_109_120),
    "drqsgd_bloom_hash": ("wordlstm", FLAGSHIP, dict(bloom_blocked="hash"), 1_189_572),
    "drqsgd_rle": ("wordlstm", FLAGSHIP, dict(index="rle"), 2_358_196),
    "topr_polyfit": ("wordlstm", FLAGSHIP, dict(deepreduce="value", value="polyfit"), 1_627_804),
    "topr_dexp": ("wordlstm", FLAGSHIP, dict(deepreduce="value", value="doubleexp"), 1_621_660),
    "topr_countsketch": ("wordlstm", FLAGSHIP, dict(deepreduce="value", value="countsketch"), 4_859_888),
    "randomk_qsgd": ("wordlstm", FLAGSHIP, dict(compressor="randomk", deepreduce="value", value="qsgd"), 2_031_688),
    "threshold_bloom_qsgd": ("wordlstm", FLAGSHIP, dict(compressor="threshold", threshold_val=0.0, compress_ratio=0.2,
                                                        memory="none", fpr=0.6, quantum_num=63), 3_020_240),
    "resnet20_polyseg": ("resnet20", QUICKSTART, dict(deepreduce="value", value="polyseg"), 20_076),
}
RANDOM_POLICY_ARMS = ("drqsgd_bloom_p1", "drqsgd_bloom_p2a")

_rle_encode = jax.jit(jrle.encode, static_argnums=1)
_rle_decode = jax.jit(jrle.decode, static_argnums=(1, 2))
_dexp_encode = jax.jit(jdexp.encode, static_argnums=1)
_dexp_decode = jax.jit(jdexp.decode, static_argnums=(1, 2))
_pseg_encode = jax.jit(jpseg.encode, static_argnums=1)
_pseg_decode = jax.jit(jpseg.decode, static_argnums=(1, 2))
_cs_encode = jax.jit(jcs.encode, static_argnums=1)
_cs_decode = jax.jit(jcs.decode, static_argnums=(1, 2))


def _knobs(arm, **kw):
    _, base, knobs, _ = ZOO[arm]
    return {**base, **knobs, **kw}


def _cfgs(arm, **kw):
    knobs = _knobs(arm, **kw)
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _pair(vals, idx, nnz, d):
    jsp = JSparseGrad(jnp.asarray(vals), jnp.asarray(idx), jnp.int32(nnz), (d,))
    tsp = SparseGrad(_t(vals), _t(idx), torch.tensor(nnz, dtype=torch.int32), (d,))
    return jsp, tsp


def _leaves_equal(tpay, jpay):
    jl = jax.tree_util.tree_leaves(jpay)
    tl = tpay.leaves()
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=f"leaf {i}")


# -- the codecs ----------------------------------------------------------------- #


@pytest.mark.parametrize("d,k,nnz", [(2048, 200, 200), (5000, 500, 321), (65536, 6553, 6553), (1000, 10, 0), (96, 96, 96)])
def test_rle_bitwise(d, k, nnz):
    rng = np.random.default_rng(d + nnz)
    runs = (rng.integers(0, d - 5, size=k // 8)[:, None] + np.arange(5)).ravel()
    idx = np.unique(np.concatenate([rng.integers(0, d, size=k // 2), runs]))[:k] if d > k else np.arange(d)
    idx = rng.permutation(np.concatenate([idx, np.zeros(k - len(idx), np.int64)])).astype(np.int32)
    vals = rng.normal(size=k).astype(np.float32)
    live = rng.permutation(k)[:nnz]  # the live slots first, as the sparsifiers emit them
    idx = np.concatenate([idx[live], np.zeros(k - nnz, np.int32)]).astype(np.int32)
    vals = np.concatenate([vals[live], np.zeros(k - nnz, np.float32)])
    jm, tm = jrle.RLEMeta(k, d), trle.RLEMeta(k, d)
    jsp, tsp = _pair(vals, idx, nnz, d)
    jp, tp = _rle_encode(jsp, jm), trle.encode(tsp, tm)
    _leaves_equal(tp, jp)
    assert tp.runs.words.shape == (tm.n_words,)
    jd, td = _rle_decode(jp, jm, (d,)), trle.decode(tp, tm, (d,))
    np.testing.assert_array_equal(td.indices.numpy(), np.asarray(jd.indices))
    np.testing.assert_array_equal(td.values.numpy(), np.asarray(jd.values))
    assert float(trle.wire_bits(tp, tm)) == float(jrle.wire_bits(jp, jm))
    # lossless: the live set comes back, ascending
    np.testing.assert_array_equal(td.indices.numpy()[:nnz], np.sort(idx[:nnz]))


def _curve(k, kind, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=k)
    if kind == "heavy":
        v = v * rng.uniform(0, 1, size=k) ** 3
    elif kind == "ties":
        v = np.round(v, 1)
    elif kind == "uniform":
        v = rng.uniform(-1, 1, size=k)
    return v.astype(np.float32)


@pytest.mark.parametrize("k,kind", [(2048, "normal"), (9001, "ties"), (16384, "heavy"), (20000, "uniform")])
def test_doubleexp_matches_jitted_jax(k, kind):
    """The order and the signed indices bitwise; the decoded values within
    DEXP_ATOL * max|v| (XLA's cumsum order, its LU, exp and SVD least
    squares round differently, and the integral method amplifies that); the
    port's evaluation of JAX's own coefficients within 1e-6 (exp alone)."""
    v = _curve(k, kind, seed=k)
    idx = np.random.default_rng(1).permutation(4 * k)[:k].astype(np.int32)
    jm, tm = jdexp.DoubleExpMeta(k), tdexp.DoubleExpMeta(k)
    jsp, tsp = _pair(v, idx, k, 4 * k)
    jp, tp = _dexp_encode(jsp, jm), tdexp.encode(tsp, tm)
    np.testing.assert_array_equal(tp.signed_indices.numpy(), np.asarray(jp.signed_indices))
    assert int(tp.nnz) == k and tp.coeffs.shape == (4,)
    jgrid = jax.jit(lambda: jnp.arange(1, k + 1, dtype=jnp.float32) / jnp.float32(k))()
    np.testing.assert_array_equal(tdexp.grid(k, "cpu").numpy(), np.asarray(jgrid))
    vmax = float(np.abs(v).max())
    jd, td = _dexp_decode(jp, jm, (4 * k,)), tdexp.decode(tp, tm, (4 * k,))
    np.testing.assert_array_equal(td.indices.numpy(), np.asarray(jd.indices))
    np.testing.assert_allclose(td.values.numpy(), np.asarray(jd.values), rtol=0, atol=DEXP_ATOL * vmax)
    # the JAX coefficients through the port's evaluation: the exponentials alone
    same = tdexp.decode(tdexp.DoubleExpPayload(_t(jp.coeffs), tp.signed_indices, tp.nnz), tm, (4 * k,))
    np.testing.assert_allclose(same.values.numpy(), np.asarray(jd.values), rtol=0, atol=1e-6 * vmax)
    assert float(tdexp.wire_bits(tp, tm)) == float(jdexp.wire_bits(jp, jm)) == 128.0


@pytest.mark.parametrize("k", [20, 368, 5000, 36864])
def test_polyseg_matches_jitted_jax(k):
    """The breaks (the chord argmaxes), the order and the signed indices
    bitwise; the coefficients of segments of 64+ values and the decode within
    tolerance (the normal equations are summed and solved in another
    order)."""
    rng = np.random.default_rng(k)
    v = (rng.normal(size=k) * rng.uniform(0.1, 2, size=k) ** 2).astype(np.float32)
    idx = rng.permutation(4 * k)[:k].astype(np.int32)
    jm, tm = jpseg.PolySegMeta(k=k), tpseg.PolySegMeta(k=k)
    jsp, tsp = _pair(v, idx, k, 4 * k)
    jp, tp = _pseg_encode(jsp, jm), tpseg.encode(tsp, tm)
    np.testing.assert_array_equal(tp.breaks.numpy(), np.asarray(jp.breaks))
    np.testing.assert_array_equal(tp.signed_indices.numpy(), np.asarray(jp.signed_indices))
    vmax = float(np.abs(v).max())
    sizes = np.diff(tp.breaks.numpy())
    solid = sizes >= 64
    np.testing.assert_allclose(tp.coeffs.numpy()[solid], np.asarray(jp.coeffs)[solid], rtol=COEFF_RTOL,
                               atol=COEFF_ATOL * vmax)
    jd, td = _pseg_decode(jp, jm, (4 * k,)), tpseg.decode(tp, tm, (4 * k,))
    np.testing.assert_array_equal(td.indices.numpy(), np.asarray(jd.indices))
    np.testing.assert_allclose(td.values.numpy(), np.asarray(jd.values), rtol=0, atol=DECODE_ATOL * vmax)
    assert float(tpseg.wire_bits(tp, tm)) == float(jpseg.wire_bits(jp, jm))
    assert tm.segments == jm.segments == tpseg.default_num_segments(k)


@pytest.mark.parametrize("k,rows,cols,nnz", [(2048, 5, 819, 2048), (6553, 4, 3277, 6000), (500, 1, 256, 500)])
def test_countsketch_bitwise(k, rows, cols, nnz):
    rng = np.random.default_rng(k)
    v = rng.normal(size=k).astype(np.float32)
    idx = rng.permutation(8 * k)[:k].astype(np.int32)
    v[nnz:], idx[nnz:] = 0.0, 0
    jm, tm = jcs.CountSketchMeta(k, rows, cols, seed=3), tcs.CountSketchMeta(k, rows, cols, seed=3)
    jsp, tsp = _pair(v, idx, nnz, 8 * k)
    jp, tp = _cs_encode(jsp, jm), tcs.encode(tsp, tm)
    _leaves_equal(tp, jp)
    jd, td = _cs_decode(jp, jm, (8 * k,)), tcs.decode(tp, tm, (8 * k,))
    np.testing.assert_array_equal(td.values.numpy().view(np.int32), np.asarray(jd.values).view(np.int32))
    assert float(tcs.wire_bits(tp, tm)) == float(jcs.wire_bits(jp, jm)) == rows * cols * 32
    # an even row count averages the two middle rows
    stacked = torch.tensor([[1.0, 5.0], [4.0, 2.0], [2.0, 3.0], [3.0, 9.0]])
    np.testing.assert_array_equal(tcs._median_rows(stacked).numpy(), [2.5, 4.0])


# -- TensorCodec per arm ---------------------------------------------------------- #


def _leaf_cases(arm):
    """(name, shape) of the arm's test leaves: one the codec compresses and,
    for PolySeg, one its conv pattern excludes."""
    if arm == "resnet20_polyseg":
        return [("BasicBlockV2_3/Conv_0/kernel", (3, 3, 16, 32)), ("Dense_0/kernel", (64, 10))]
    return [("LSTM_0/kernel", (128, 100))]  # d = 12,800 > 9000: Fit-DExp compresses it


def _gradient(shape, arm, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    if arm == "threshold_bloom_qsgd":
        g[rng.random(shape) < 0.9] = 0.0  # natural sparsity under the 0.2 budget
    return g


def _jax_uniforms(n, key):
    return _t(jax.random.uniform(key, (n,)))


def _port_encode(tc, g, key):
    """The port's payload with JAX's draws: random-k's priorities and the
    QSGD uniforms under `key` (one key for both, as the JAX wrapper)."""
    if tc.cfg.compressor != "randomk" or not tc.compressed:
        qu = None
        if tc.rows_leaf is not None:
            qu = _jax_uniforms(tc.val_codec.meta.padded_len, key)
        return tc.encode(_t(g), uniforms=qu)
    sp = tc.sparsify(_t(g), uniforms=_jax_uniforms(tc.d, key))
    data = torch.empty(tc.val_codec.meta.payload_len, dtype=torch.int8)
    seg = tc.value_segment(sp, 0, step=0, worker=0, uniforms=_jax_uniforms(tc.val_codec.meta.padded_len, key))
    qsgd_encode_rows([seg], data, quantum_num=tc.cfg.quantum_num, bucket_size=tc.cfg.bucket_size, device="cpu")
    return tc.rows_payload(sp, data)


def _assert_payload(tc, tpay, jpay, arm, vmax):
    jleaves = jax.tree_util.tree_leaves(jpay)
    tleaves = tpay.leaves()
    assert len(jleaves) == len(tleaves) == len(tc.payload_specs())
    for i, (tl, jl) in enumerate(zip(tleaves, jleaves)):
        jl = np.asarray(jl)
        assert tuple(tl.shape) == jl.shape and tl.shape == tc.payload_specs()[i][0], (arm, i)
        if arm in RANDOM_POLICY_ARMS and i in (0, tc.rows_leaf):
            continue  # the values at the policy's own (Philox) selection
        if i == tc.rows_leaf:
            meta = tc.val_codec.meta
            ra = tl.numpy().reshape(meta.num_buckets, meta.bucket_size + 4)
            rb = jl.reshape(meta.num_buckets, meta.bucket_size + 4)
            na, nb = ra[:, meta.bucket_size :].copy().view(np.float32), rb[:, meta.bucket_size :].copy().view(np.float32)
            np.testing.assert_allclose(na, nb, rtol=1e-6)
            same = (na == nb).reshape(-1)
            np.testing.assert_array_equal(ra[same], rb[same])
        elif tc.compressed and tl.dtype == torch.float32 and arm in ("topr_polyfit", "topr_dexp", "resnet20_polyseg"):
            continue  # coefficients: decode compared below
        else:
            np.testing.assert_array_equal(tl.numpy().view(jl.dtype), jl, err_msg=f"{arm} leaf {i}")


@pytest.mark.parametrize("arm", list(ZOO))
def test_tensor_codec_per_arm_matches_jax(arm):
    jcfg, tcfg = _cfgs(arm)
    for c, (name, shape) in enumerate(_leaf_cases(arm)):
        g = _gradient(shape, arm, seed=c)
        jc = JTensorCodec(shape, jcfg, name=name)
        tc = port.TensorCodec(shape, tcfg, name=name, device="cpu")
        assert (tc.compressed, tc.dense_fallback, tc.k, tc.pattern_excluded) == (
            jc.compressed, jc.dense_fallback, jc.k, jc.pattern_excluded)
        assert tc.min_compress_size == jc.min_compress_size and tc.layer_pattern == jc.layer_pattern
        key = jax.random.PRNGKey(5)
        jpay = jax.jit(lambda t: jc.encode(t, step=0, key=key))(jnp.asarray(g))
        tpay = _port_encode(tc, g, key)
        vmax = float(np.abs(g).max())
        _assert_payload(tc, tpay, jpay, arm, vmax)
        tdec = tc.decode(tpay).numpy()
        jdec = np.asarray(jax.jit(jc.decode)(jpay))
        js, ts = jc.wire_stats(jpay), tc.wire_stats(tpay)
        assert float(ts.index_bits) == float(js.index_bits) and float(ts.value_bits) == float(js.value_bits), arm
        assert float(ts.rel_volume()) == float(js.rel_volume()) and float(ts.saturated) == float(js.saturated)
        if arm in RANDOM_POLICY_ARMS:
            # another selection (Philox draws), from the same filter: the
            # decode places values only at filter positives
            words = tpay.index_payload.words
            mask = tbloom.query_universe(words, tc.idx_codec.meta).numpy()
            assert np.all(mask[tdec.reshape(-1) != 0])
            assert int(tpay.nsel) == int(jpay.nsel) == tc.k
        elif arm == "topr_dexp":
            np.testing.assert_allclose(tdec, jdec, rtol=0, atol=DEXP_ATOL * vmax)
        elif arm in ("topr_polyfit", "resnet20_polyseg"):
            np.testing.assert_allclose(tdec, jdec, rtol=0, atol=DECODE_ATOL * vmax)
        elif tc.rows_leaf is None:
            np.testing.assert_array_equal(tdec, jdec)
        else:
            # the JAX package's compiled decode of the port's own payload (its
            # QSGD norms may sit one ulp from JAX's own, above)
            same_pay = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(jpay),
                [jnp.asarray(t.numpy().view(np.asarray(j).dtype)) for t, j in zip(tpay.leaves(), jax.tree_util.tree_leaves(jpay))])
            np.testing.assert_array_equal(tdec, np.asarray(jax.jit(jc.decode)(same_pay)))
        again = tc.payload_from_leaves(list(tpay.leaves()))
        assert torch.equal(tc.decode(again), tc.decode(tpay))
        if hasattr(tc.idx_codec, "fp_stats"):
            fp, universe = tc.fp_stats(tpay)
            jfp, juni = jc.fp_stats(jpay)
            assert (float(fp), float(universe)) == (float(jfp), float(juni))


# -- W workers through the InProcessGroup ------------------------------------------- #


def _zoo_shapes(arm):
    if arm == "resnet20_polyseg":
        return {"Conv_0/kernel": (3, 3, 16, 16), "Conv_1/kernel": (3, 3, 16, 32), "Dense_0/kernel": (64, 10), "b": (10,)}
    return {"Embed_0/embedding": (200, 48), "LSTM_0/kernel": (96, 100), "b": (40,)}


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("arm", list(ZOO))
def test_exchange_over_w_workers(arm, W):
    """Every worker's aggregate bitwise equal to the mean of every worker's
    own decode, in worker order; with the random policies every worker
    decodes every other worker's payload to the selection its encoder made."""
    shapes = _zoo_shapes(arm)
    cfg = port.DeepReduceConfig(**_knobs(arm, seed=4))
    step = 2
    grads_w = [{n: _t(_gradient(s, arm, seed=10 * w + i)) for i, (n, s) in enumerate(shapes.items())}
                for w in range(W)]
    res_w = [None if cfg.memory == "none" else {n: torch.zeros(s) for n, s in shapes.items()} for _ in range(W)]
    bufs = [None] * W
    lock = threading.Lock()

    def work(coll, grads, res):
        ex = port.GradientExchanger(shapes, cfg, device="cpu", group=coll)
        buf, _, _ = ex.encode_worker(grads, res, step=step, worker=coll.rank)
        with lock:
            bufs[coll.rank] = buf
        agg, new_res, _ = ex.exchange(grads, res, step=step)
        return agg, new_res

    out = port.InProcessGroup(W).run(work, grads_w, res_w)
    ex = port.GradientExchanger(shapes, cfg, device="cpu")
    assert sum(c.compressed for c in ex.codecs.values()) >= 1
    rows = torch.stack(bufs)
    agg, _ = ex.decode_aggregate(rows, own=0, step=step)
    for r in range(W):
        for n in shapes:
            assert torch.equal(out[r][0][n], agg[n]), (arm, W, r, n)
            assert torch.isfinite(out[r][0][n]).all()
    if arm in RANDOM_POLICY_ARMS:
        for w in range(W):
            for n, codec in ex.codecs.items():
                if not codec.compressed:
                    continue
                lay, lo = ex.layouts[n], ex.offsets[n]
                pay = codec.payload_from_leaves(lay.unpack(rows[w][lo : lo + lay.nbytes]))
                meta = codec.idx_codec.meta
                sel, nsel = tbloom.select(tbloom.query_universe(pay.index_payload.words, meta), meta, step=step,
                                          seed=cfg.seed)
                chosen = np.zeros(meta.d, bool)
                chosen[sel.numpy()[: int(nsel)]] = True
                # the encoder's own selection: it read the values there
                enc = codec.encode_index(grads_w[w][n] + (0 if res_w[w] is None else res_w[w][n]), step=step, worker=w)
                flat = grads_w[w][n].reshape(-1).numpy()
                np.testing.assert_array_equal(enc.values.numpy()[: int(nsel)], flat[sel.numpy()[: int(nsel)]])
                dec = codec.decode(pay, step=step).reshape(-1).numpy()
                assert np.all(chosen[dec != 0]), (arm, w, n)


# -- the full-width wire ------------------------------------------------------------- #


def test_full_width_payload_bytes_per_arm():
    shapes = {
        "wordlstm": {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()},
        "resnet20": {n: tuple(p.shape) for n, p in ResNet20().flax_params().items()},
    }
    for arm, (model, _, _, nbytes) in ZOO.items():
        jcfg, tcfg = _cfgs(arm)
        like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes[model].items()}
        ex = port.GradientExchanger(shapes[model], tcfg, device="cpu")
        jex = JExchanger(like, jcfg)
        assert ex.payload_bytes() == jex.payload_bytes(like) == nbytes, arm
        assert sum(c.compressed for c in ex.codecs.values()) == (19 if model == "resnet20" else 12), arm
        # PolySeg's conv pattern ships the 40 other ResNet-20 leaves dense
        dense_leaves = [n for n, c in ex.codecs.items() if c.dense_fallback]
        assert dense_leaves == [n for n in ex.names if jex.codecs[n].dense_fallback], arm
        assert len(dense_leaves) == (40 if arm == "resnet20_polyseg" else 0), arm


def test_randomk_matches_jax_given_its_priorities():
    d, ratio = 4096, 0.1
    g = np.random.default_rng(0).normal(size=d).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jsp = jrandomk(jnp.asarray(g), ratio, key)
    tsp = port.TensorCodec((d,), port.DeepReduceConfig(compressor="randomk", compress_ratio=ratio), device="cpu")
    got = tsp.sparsify(_t(g), uniforms=_jax_uniforms(d, key))
    _leaves_equal(got, jsp)


def test_bloom_meta_across_layouts_matches_jax():
    for k, d, fpr in [(96038, 960384, 0.02), (400, 4000, None), (53, 536, 0.6)]:
        for blocked in (False, "hash", "mod"):
            for policy in ("random", "conflict_sets_approx"):
                j = jbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked=blocked)
                t = tbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked=blocked)
                assert (t.m_bits, t.num_hash, t.fpr, t.budget, t.blocked) == (j.m_bits, j.num_hash, j.fpr, j.budget, j.blocked)

