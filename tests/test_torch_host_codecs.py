"""Port parity for the host half of the codec family against the JAX package
on the CPU: the C++ host library (`deepreduce_tpu_torch.native`, a copy of
`deepreduce_tpu/native/deepreduce_native.cc`), the Huffman index, the
Deflate and searched-knot PolyFit value codecs, the library's bloom index
under its four policies (the exact P2 `conflict_sets` among them) and its
integer family fbp / varint / pfor, the reference's 3 x 21-bit and bitmap
packers, `micro_benchmark`, the config, and the host arms of the port's
chip phase through `TensorCodec`, the exchange and `Trainer.step`.

Every comparison is bitwise: both packages run the same numpy, zlib and C++
on the same inputs, and the selection feeding them is bitwise already.
Where QSGD values ride on a host index, JAX's uniforms are injected. The
JAX functions are jitted (the codecs reach the library through its FFI
route or `pure_callback`)."""

import dataclasses
import math
import multiprocessing as mp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_slice import _jax_flat_params, _t

from deepreduce_tpu import native as jnative
from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.codecs import packing as jpacking
from deepreduce_tpu.codecs.registry import get_codec as jget_codec
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.config import from_params as jfrom_params
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.utils.compat import shard_map
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import native
from deepreduce_tpu_torch.codecs import bloom as tbloom
from deepreduce_tpu_torch.codecs import packing as tpacking
from deepreduce_tpu_torch.checkpoint import config_fingerprint
from deepreduce_tpu_torch.codecs.registry import get_codec
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.sparse import SparseGrad
from deepreduce_tpu_torch.weights import params_from_jax

from torch_ranks import run_trainer_rank

REPO = pathlib.Path(__file__).resolve().parent.parent
FLAGSHIP = dict(
    compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
    index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", approx_topk=False,
)
# the host arms of the chip phase: knobs over the flagship's, and the JAX
# package's GradientExchanger.payload_bytes on the full-width WordLSTM
HOST_ARMS = {
    "drqsgd_huffman": (dict(index="huffman"), 3_651_208),
    "drqsgd_varint": (dict(index="integer_native", code="varint"), 3_677_136),
    "drqsgd_pfor": (dict(index="integer_native", code="pfor"), 3_677_136),
    "bloom_native_p2": (dict(deepreduce="index", index="bloom_native", policy="conflict_sets"), 3_652_916),
    "topr_gzip": (dict(deepreduce="value", value="gzip"), 3_241_983),
    "topr_polyfit_host": (dict(deepreduce="value", value="polyfit_host"), 1_625_548),
}
# host codecs under 'both' beyond the phase's arms: the host PolyFit's order
# is the bit-packed mapping; Deflate over the Huffman index's value table
BOTH_ARMS = {
    "bloom_polyfit_host": dict(value="polyfit_host"),
    "huffman_gzip": dict(index="huffman", value="gzip"),
}
NATIVE_POLICIES = ("leftmost", "random", "p0", "conflict_sets")


def _knobs(arm, **kw):
    return {**FLAGSHIP, **(HOST_ARMS[arm][0] if arm in HOST_ARMS else BOTH_ARMS[arm]), **kw}


def _cfgs(arm, **kw):
    knobs = _knobs(arm, **kw)
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _topk_input(d, k, seed, nnz=None):
    """A dense f32[d] gradient and its top-k selection (ascending indices),
    with `nnz` live slots (the rest zero)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=d).astype(np.float32)
    idx = np.sort(np.argsort(-np.abs(g), kind="stable")[:k]).astype(np.int32)
    vals = g[idx].copy()
    nnz = k if nnz is None else nnz
    vals[nnz:] = 0.0
    idx[nnz:] = 0
    return g, vals, idx, nnz


def _pairs(g, vals, idx, nnz, d):
    jsp = JSparseGrad(jnp.asarray(vals), jnp.asarray(idx), jnp.int32(nnz), (d,))
    tsp = SparseGrad(_t(vals), _t(idx), torch.tensor(nnz, dtype=torch.int32), (d,))
    return jsp, tsp


def _assert_leaves(tleaves, jleaves, what):
    assert len(tleaves) == len(jleaves), what
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (what, i)
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=f"{what} leaf {i}")


# -- the C++ host library ------------------------------------------------------ #


def test_native_source_is_the_jax_packages_byte_for_byte():
    ours = REPO / "deepreduce_tpu_torch" / "native" / "csrc" / "deepreduce_native.cc"
    theirs = REPO / "deepreduce_tpu" / "native" / "deepreduce_native.cc"
    assert ours.read_bytes() == theirs.read_bytes()
    assert native.POLICY_IDS == jnative.POLICY_IDS and native.INT_CODEC_NAMES == jnative.INT_CODEC_NAMES


def test_fmix32_and_classic_bitmap_match_jax_and_the_device_filter():
    xs = np.array([0, 1, 2, 42, 0xDEADBEEF, 2**32 - 1], np.uint32)
    assert [native.fmix32(int(x)) for x in xs] == [jnative.fmix32(int(x)) for x in xs]
    np.testing.assert_array_equal(np.array([native.fmix32(int(x)) for x in xs], np.uint32),
                                  tbloom.fmix32(torch.from_numpy(xs.astype(np.int64))).numpy().astype(np.uint32))
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(10000, 128, replace=False)).astype(np.int32)
    meta = tbloom.BloomMeta.create(128, 10000, fpr=0.01)
    jmeta = jbloom.BloomMeta.create(128, 10000, fpr=0.01)
    assert (meta.m_bits, meta.num_hash) == (jmeta.m_bits, jmeta.num_hash)
    words = tbloom.insert(_t(idx), torch.tensor(128, dtype=torch.int32), meta)
    ours = native.bloom_insert(idx, meta.m_bits, meta.num_hash)
    np.testing.assert_array_equal(ours, jnative.bloom_insert(idx, meta.m_bits, meta.num_hash))
    np.testing.assert_array_equal(ours, words.numpy().view(np.uint8))
    mask = native.bloom_query_universe(ours, meta.num_hash, 10000)
    np.testing.assert_array_equal(mask, jnative.bloom_query_universe(ours, meta.num_hash, 10000))
    np.testing.assert_array_equal(mask, tbloom.query_universe(words, meta).numpy().astype(np.uint8))


@pytest.mark.parametrize("policy", NATIVE_POLICIES)
def test_select_compress_and_decompress_match_jax(policy):
    d, k = 5000, 64
    g, _, idx, _ = _topk_input(d, k, seed=2)
    meta = tbloom.BloomMeta.create(k, d, fpr=0.05)
    bits = native.bloom_insert(idx, meta.m_bits, meta.num_hash)
    mask = native.bloom_query_universe(bits, meta.num_hash, d)
    assert int(mask.sum()) > k  # false positives: the policy has a choice
    budget = tbloom.policy_budget(policy, k, d, meta.fpr)
    for step in (0, 7):
        kw = dict(m_bits=meta.m_bits, num_hash=meta.num_hash, step=step, cap=budget)
        sel = native.select(policy, mask, k, **kw)
        np.testing.assert_array_equal(sel, jnative.select(policy, mask, k, **kw))
        wire = native.bloom_compress(g, idx, meta.m_bits, meta.num_hash, policy, step, budget)
        np.testing.assert_array_equal(wire, jnative.bloom_compress(g, idx, meta.m_bits, meta.num_hash, policy, step,
                                                                   budget))
        vals, sidx = native.bloom_decompress(wire, d, k, policy, step, budget)
        jvals, jsidx = jnative.bloom_decompress(wire, d, k, policy, step, budget)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(sidx, jsidx)
        np.testing.assert_array_equal(sidx, sel)
        np.testing.assert_array_equal(vals, g[sel])


@pytest.mark.parametrize("code", ["fbp", "varint", "pfor"])
def test_integer_family_words_match_jax(code):
    rng = np.random.default_rng(3)
    for n in (0, 1, 127, 128, 1000):
        vals = np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.uint32)
        if n > 10:
            vals[5] = vals[4]  # a repeat: a zero delta
            vals[-1] = (1 << 31) + 7  # an exception for pfor
        enc, dec = native.int_codec_from_name(code)
        jenc, _ = jnative.int_codec_from_name(code)
        words = enc(vals)
        np.testing.assert_array_equal(words, jenc(vals))
        np.testing.assert_array_equal(dec(words, n), vals)
        assert len(words) <= native.int_cap_words(n) == jnative.int_cap_words(n)
        direct = {"fbp": (native.fbp_encode, jnative.fbp_encode), "varint": (native.varint_encode, jnative.varint_encode),
                  "pfor": (native.pfor_encode, jnative.pfor_encode)}[code]
        np.testing.assert_array_equal(direct[0](vals), direct[1](vals))
    with pytest.raises(KeyError):
        native.int_codec_from_name("simple16")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1001])
def test_pack3x21_and_bitmaps_match_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 21, n).astype(np.uint32)
    words = tpacking.pack3x21(torch.from_numpy(vals.astype(np.int64)))
    jwords = np.asarray(jpacking.pack3x21(jnp.asarray(vals)))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    np.testing.assert_array_equal(tpacking.unpack3x21(words, n).numpy(),
                                  np.asarray(jpacking.unpack3x21(jnp.asarray(jwords), n)))
    np.testing.assert_array_equal(tpacking.unpack3x21(words, n).numpy(), vals)
    assert int(tpacking.packed_count3x21(words)) == int(jpacking.packed_count3x21(jnp.asarray(jwords))) == n
    bits = rng.integers(0, 2, n).astype(np.uint8)
    bw = tpacking.pack_bitmap(torch.from_numpy(bits))
    jbw = np.asarray(jpacking.pack_bitmap(jnp.asarray(bits)))
    np.testing.assert_array_equal(bw.numpy().view(np.uint32), jbw)
    np.testing.assert_array_equal(tpacking.unpack_bitmap(bw, n).numpy(), np.asarray(jpacking.unpack_bitmap(jbw, n)))


# -- the registry codecs --------------------------------------------------------- #

# (registry name, kind, params, d, k, live slots)
CODEC_CASES = {
    "huffman": ("huffman", "index", {}, 70_000, 7_000, 7_000),
    "gzip": ("gzip", "value", {}, 20_000, 2_000, 2_000),
    "polyfit_host": ("polyfit_host", "value", {}, 20_000, 2_000, 2_000),
    **{f"bloom_native_{p}": ("bloom_native", "index", dict(policy=p, fpr=0.05), 20_000, 500, 500)
       for p in NATIVE_POLICIES},
    **{f"integer_native_{c}": ("integer_native", "index", dict(code=c), 20_000, 500, 321)
       for c in ("fbp", "varint", "pfor")},
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_registry_codec_matches_jitted_jax(case):
    name, kind, params, d, k, nnz = CODEC_CASES[case]
    g, vals, idx, nnz = _topk_input(d, k, seed=len(case), nnz=nnz)
    jsp, tsp = _pairs(g, vals, idx, nnz, d)
    jc, tc = jget_codec(name, kind)(k, d, params), get_codec(name, kind)(k, d, params)
    assert (tc.order_preserving, tc.fixed_size) == (jc.order_preserving, jc.fixed_size)
    assert tc.host
    step = 3
    if kind == "index":
        jpay = jax.jit(lambda sp, dense: jc.encode(sp, dense=dense, step=step))(jsp, jnp.asarray(g))
        tpay = tc.encode(tsp, _t(g), step=step)
        jdec = jax.jit(lambda p: jc.decode(p, (d,), step=step))(jpay)
        tdec = tc.decode(tpay, (d,), step=step)
    else:
        jpay = jax.jit(lambda sp: jc.encode(sp))(jsp)
        tpay = tc.encode(tsp)
        jdec = jax.jit(lambda p: jc.decode(p, (d,)))(jpay)
        tdec = tc.decode(tpay, (d,))
    _assert_leaves(tpay.leaves(), jax.tree_util.tree_leaves(jpay), case)
    assert [(tuple(l.shape), l.dtype) for l in tpay.leaves()] == tc.payload_specs(
        tc.value_slots if kind == "index" else k)
    _assert_leaves(tdec.leaves(), jax.tree_util.tree_leaves(jdec), f"{case} decode")
    # a payload rebuilt from its leaves decodes the same, with the host copy handed in
    again = tc.payload_from_leaves(list(tpay.leaves()))
    kw = dict(step=step) if kind == "index" else {}
    redec = tc.decode(tpay, (d,), host_payload=again, **kw)
    _assert_leaves(redec.leaves(), tdec.leaves(), f"{case} decode of the host copy")
    assert float(tc.index_wire_bits(tpay)) == float(jc.index_wire_bits(jpay)), case
    assert float(tc.value_wire_bits(tpay)) == float(jc.value_wire_bits(jpay)), case
    if name in ("huffman", "gzip", "integer_native"):
        # lossless: the selection itself comes back
        live = np.arange(k) < nnz
        np.testing.assert_array_equal(tdec.indices.numpy()[live], idx[live])
        np.testing.assert_array_equal(tdec.values.numpy()[live], vals[live])


def test_bloom_native_refuses_both_mode_and_unknown_policies():
    tc = get_codec("bloom_native", "index")(50, 1000, {})
    with pytest.raises(NotImplementedError):
        tc.strip_for_both(None)
    with pytest.raises(ValueError, match="policy"):
        get_codec("bloom_native", "index")(50, 1000, dict(policy="conflict_sets_approx"))
    with pytest.raises(KeyError):
        get_codec("integer_native", "index")(50, 1000, dict(code="simple16"))


# -- TensorCodec, the exchange and the wire, per arm ----------------------------- #

LEAF = ("LSTM_0/kernel", (96, 100))


def _port_uniforms(tc, key):
    if tc.rows_leaf is None:
        return None
    return _t(jax.random.uniform(key, (tc.val_codec.meta.padded_len,)))


@pytest.mark.parametrize("arm", [*HOST_ARMS, *BOTH_ARMS])
def test_tensor_codec_per_arm_matches_jax(arm):
    jcfg, tcfg = _cfgs(arm)
    name, shape = LEAF
    g = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jc = JTensorCodec(shape, jcfg, name=name)
    tc = port.TensorCodec(shape, tcfg, name=name, device="cpu")
    assert (tc.compressed, tc.k, tc.host) == (jc.compressed, jc.k, True)
    key = jax.random.PRNGKey(5)
    step = 2
    jpay = jax.jit(lambda t: jc.encode(t, step=step, key=key))(jnp.asarray(g))
    tpay = tc.encode(_t(g), step=step, uniforms=_port_uniforms(tc, key))
    jleaves = jax.tree_util.tree_leaves(jpay)
    assert [(tuple(s), dt) for s, dt in tc.payload_specs()] == [(tuple(l.shape), l.dtype) for l in tpay.leaves()]
    for i, (a, b) in enumerate(zip(tpay.leaves(), jleaves)):
        b = np.asarray(b)
        if i == tc.rows_leaf:
            # the QSGD rows: the norms to 1 ulp, the levels under equal norms
            meta = tc.val_codec.meta
            ra, rb = a.numpy().reshape(meta.num_buckets, -1), b.reshape(meta.num_buckets, -1)
            na, nb = (r[:, meta.bucket_size:].copy().view(np.float32) for r in (ra, rb))
            np.testing.assert_allclose(na, nb, rtol=1e-6)
            np.testing.assert_array_equal(ra[(na == nb).reshape(-1)], rb[(na == nb).reshape(-1)])
        else:
            np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=f"{arm} leaf {i}")
    # JAX's compiled decode of the port's own payload
    same = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jpay),
                                        [jnp.asarray(t.numpy().view(np.asarray(j).dtype))
                                         for t, j in zip(tpay.leaves(), jleaves)])
    tdec = tc.decode(tpay, step=step)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jax.jit(lambda p: jc.decode(p, step=step))(same)))
    js, ts = jc.wire_stats(jpay), tc.wire_stats(tpay)
    for f in ("index_bits", "value_bits", "dense_bits", "saturated"):
        assert float(getattr(ts, f)) == float(getattr(js, f)), (arm, f)
    # the live lengths, not the static budgets
    budget_bits = 8 * sum(math.prod(s) * torch.empty((), dtype=dt).element_size() for s, dt in tc.payload_specs())
    assert 0 < float(ts.total_bits) < budget_bits


def test_micro_benchmark_matches_jax_keys_and_volumes(capsys):
    jcfg, tcfg = _cfgs("drqsgd_huffman", micro_benchmark=True)
    name, shape = LEAF
    g = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    jout = JTensorCodec(shape, jcfg, name=name).micro_benchmark(jnp.asarray(g), iters=1)
    capsys.readouterr()
    tout = port.TensorCodec(shape, tcfg, name=name, device="cpu").micro_benchmark(_t(g), iters=2)
    printed = capsys.readouterr().out.splitlines()
    assert list(tout) == list(jout)
    assert [line.split(":")[0] for line in printed] == list(jout)
    for key in ("idx_relative_volume", "val_relative_volume", "relative_volume"):
        assert tout[key] == jout[key], key
    assert tout["compression_time"] > 0 and tout["decompression_time"] > 0


def _grid_tree(rng, shapes):
    """Gradients on the grid 2**-6 (|g| < 2): every QSGD bucket norm is an
    exact float32 sum, so the port's and JAX's rows agree bitwise."""
    return {n: (rng.integers(-127, 128, size=s) / 64).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("arm", list(HOST_ARMS))
def test_two_worker_exchange_matches_jax_mesh(arm):
    """Two workers through the port's encode, fused buffer and loop decode
    against the JAX package's exchange on a two-device mesh: every buffer
    byte, the aggregate, the residuals and the live wire bits bitwise (QSGD
    given JAX's uniforms)."""
    W, step, seed = 2, 3, 7
    shapes = {"b": (40,), "a/kernel": (48, 40), "c": (3000,)}
    rng = np.random.default_rng(11)
    res_w = [_grid_tree(rng, shapes) for _ in range(W)]
    grads_w = [_grid_tree(rng, shapes) for _ in range(W)]
    jcfg, tcfg = _cfgs(arm, seed=seed, min_compress_size=100)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, jcfg)
    tex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert tex.payload_bytes() == jex.payload_bytes(like)
    assert tex.fused.host_units == ["a/kernel", "c"]
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in shapes}

    def spmd(g, r):
        g = {n: x[0] for n, x in g.items()}
        r = {n: x[0] for n, x in r.items()}
        agg, new_r, wire = jex.exchange(g, r, step=step)
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}, wire.total_bits[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    jagg, jres, jbits = jax.jit(fn)(stack(grads_w), stack(res_w))
    bufs, comps = [], []
    for w in range(W):
        keys = jex._keys(jax.random.fold_in(jax.random.PRNGKey(seed), w), jnp.asarray(step, jnp.int32))
        uniforms = {n: _port_uniforms(c, keys[n]) for n, c in tex.codecs.items() if c.rows_leaf is not None}
        buf, comp, stats = tex.encode_worker({n: _t(x) for n, x in grads_w[w].items()},
                                             {n: _t(x) for n, x in res_w[w].items()}, step=step, worker=w,
                                             uniforms=uniforms)
        jcomp = {n: jnp.asarray(grads_w[w][n]) + jnp.asarray(res_w[w][n]) for n in shapes}
        jpay = {n: jex.codecs[n].encode(jcomp[n], step=step, key=keys[n]) for n in shapes}
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jex._pack_fused(jpay)), err_msg=arm)
        # the live bits (the jitted rel_volume divides as x * fl(1 / dense))
        assert float(stats.total_bits) == float(jbits[w]), arm
        bufs.append(buf)
        comps.append(comp)
    gathered = torch.stack(bufs)
    for w in range(W):
        agg, own = tex.decode_aggregate(gathered, own=w, step=step)
        new_res = {n: comps[w][n] - own[n] for n in shapes}
        for n in shapes:
            np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][w]), err_msg=f"{arm} agg {n}")
            np.testing.assert_array_equal(new_res[n].numpy(), np.asarray(jres[n][w]), err_msg=f"{arm} res {n}")


# the bucketed exchange (comm_bucket) with a host codec per bucket
CENSUS = {"emb": (3000,), "w1": (900,), "w2": (700,), "b1": (300,)}


@pytest.mark.parametrize("arm", ["drqsgd_huffman", "topr_gzip"])
def test_bucketed_host_arm_matches_jax(arm):
    """A host arm bucketed (bucket_bytes 4800: three buckets) at W = 2, in the
    pipelined and the barrier schedule, against JAX's bucketed exchange:
    the aggregate, the residuals and the live wire bits bitwise."""
    W, seed = 2, 7
    knobs = _knobs(arm, seed=seed, min_compress_size=100, bucket_bytes=4800)
    jcfg = JConfig(**knobs)
    rng = np.random.default_rng(13)
    grads_w = [_grid_tree(rng, CENSUS) for _ in range(W)]
    res_w = [_grid_tree(rng, CENSUS) for _ in range(W)]
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in CENSUS.items()}
    jex = JExchanger(like, jcfg, num_workers=W)

    def spmd(g, r):
        agg, new_r, wire = jex.exchange({n: x[0] for n, x in g.items()}, {n: x[0] for n, x in r.items()}, step=3)
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}, wire.total_bits[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in CENSUS}
    jagg, jres, jbits = jax.jit(fn)(stack(grads_w), stack(res_w))
    tex = port.GradientExchanger(CENSUS, port.DeepReduceConfig(**knobs), device="cpu")
    assert tex.num_buckets == 3 and tex.fused.host_units == [s.label for s in tex.bucket_specs]
    assert tex.payload_bytes() == jex.payload_bytes(like)
    uniforms_w = []
    for w in range(W):
        wkey = jax.random.fold_in(jax.random.PRNGKey(seed), w)
        uniforms_w.append({label: _port_uniforms(c, per_tensor_key(wkey, label, jnp.asarray(3, jnp.int32)))
                           for label, c in tex.codecs.items() if c.rows_leaf is not None})
    for pipeline in (True, False):
        cfg = port.DeepReduceConfig(**dict(knobs, bucket_pipeline=pipeline))

        def work(coll, g, r, u):
            ex = port.GradientExchanger(CENSUS, cfg, device="cpu", group=coll)
            return ex.exchange({n: _t(x) for n, x in g.items()}, {n: _t(x) for n, x in r.items()}, step=3, uniforms=u)

        for w, (agg, new_r, wire) in enumerate(port.InProcessGroup(W).run(work, grads_w, res_w, uniforms_w)):
            for n in CENSUS:
                np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][w]), err_msg=f"{pipeline} {w} {n}")
                np.testing.assert_array_equal(new_r[n].numpy(), np.asarray(jres[n][w]), err_msg=f"{pipeline} {w} {n}")
            assert float(wire.total_bits) == float(jbits[w])


# -- the full-width wire and the config ------------------------------------------ #


def test_full_width_payload_bytes_per_host_arm():
    shapes = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    for arm, (_, nbytes) in HOST_ARMS.items():
        jcfg, tcfg = _cfgs(arm)
        ex = port.GradientExchanger(shapes, tcfg, device="cpu")
        assert ex.payload_bytes() == JExchanger(like, jcfg).payload_bytes(like) == nbytes, arm
        # the twelve compressed leaves each run the host codec
        assert len(ex.fused.host_units) == sum(c.compressed for c in ex.codecs.values()) == 12, arm


def test_config_takes_the_host_codecs_and_rejects_what_jax_rejects():
    for arm in HOST_ARMS:
        jcfg, tcfg = _cfgs(arm)
        assert port.from_params(_knobs(arm)) == tcfg
        assert tcfg.codec_params()["code"] == jcfg.codec_params()["code"]
    assert port.DeepReduceConfig().code == JConfig().code == "fbp"
    # the checkpoint stamp: `code` changes what is computed, micro_benchmark only what is observed
    base = port.DeepReduceConfig(**_knobs("drqsgd_varint"))
    assert config_fingerprint(base) != config_fingerprint(dataclasses.replace(base, code="pfor"))
    assert config_fingerprint(base) == config_fingerprint(dataclasses.replace(base, micro_benchmark=True))
    assert port.from_params({"micro-benchmark": True}).micro_benchmark is jfrom_params({"micro-benchmark": True}).micro_benchmark
    # the exact P2 off the C++ library: JAX raises when its codec is built
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**_knobs("drqsgd_huffman", index="bloom", policy="conflict_sets"))
    assert e.value.knob == "policy"
    with pytest.raises(NotImplementedError, match="bloom_native"):
        JTensorCodec((5000,), JConfig(**_knobs("drqsgd_huffman", index="bloom", policy="conflict_sets")))
    # bloom_native under 'both': JAX's TensorCodec raises a ValueError
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**_knobs("bloom_native_p2", deepreduce="both"))
    assert e.value.knob == "index" and isinstance(e.value, ValueError)
    with pytest.raises(ValueError, match="index-mode only"):
        JTensorCodec((5000,), JConfig(**_knobs("bloom_native_p2", deepreduce="both")))
    # every other host codec composes under 'both', as in JAX
    for knobs in (dict(value="polyfit_host"), dict(value="gzip"), dict(index="integer_native", value="gzip")):
        assert port.DeepReduceConfig(**{**FLAGSHIP, **knobs}).deepreduce == "both"
    for knob, val in [("code", "simple16"), ("micro_benchmark", 1)]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**{**_knobs("drqsgd_varint"), knob: val})
        assert e.value.knob == knob
    # the sketch route needs the sparse_rs communicator, as in JAX; 'auto' is a route choice there
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**{**_knobs("drqsgd_varint"), "rs_mode": "sketch"})
    assert e.value.reason_code == "rs-mode-needs-sparse-rs"
    assert port.DeepReduceConfig(communicator="sparse_rs", deepreduce=None, rs_mode="auto").rs_mode == "auto"


# -- Trainer.step ------------------------------------------------------------------ #

VOCAB, EMBED, HIDDEN, BATCH, SEQ, LR, MOM, SEED = 64, 8, 16, 4, 5, 0.1, 0.9, 3


def _tokens(n, seed=4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, size=(n, BATCH, SEQ + 1)).astype(np.int32)
    return [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(n)]


@pytest.mark.parametrize("arm", ["drqsgd_huffman", "bloom_native_p2"])
def test_wordlstm_trainer_step_matches_jax(arm):
    """One `Trainer.step` of both packages on a narrow WordLSTM from the same
    weights and batch at W = 1 (the gate lowered to its leaves): the loss,
    the live wire bits and every parameter. The exchange is bitwise, so the
    parameters differ only by the float32 forward and backward."""
    jcfg, tcfg = _cfgs(arm, seed=SEED, min_compress_size=100)
    (x, y), = _tokens(1)
    jtr = JTrainer(JWordLSTM(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN), jcfg,
                   optax.sgd(LR, momentum=MOM), shared_mesh(1))
    jstate = jtr.init_state(jax.random.PRNGKey(0), (x, y))
    tmodel = WordLSTM(VOCAB, EMBED, HIDDEN)
    tmodel.load_flax_params(params_from_jax(_jax_flat_params(jstate.params)))
    ttr = port.Trainer(tmodel, tcfg, lr=LR, momentum=MOM, device="cpu")
    tstate = ttr.init_state()
    assert len(ttr.exchanger.fused.host_units) == sum(c.compressed for c in jtr.exchanger.codecs.values()) >= 5
    key = jax.random.PRNGKey(100)
    wkey = jax.random.fold_in(key, 0)
    uniforms = {n: _port_uniforms(c, per_tensor_key(wkey, n, jnp.asarray(0, jnp.int32)))
                for n, c in ttr.exchanger.codecs.items() if c.rows_leaf is not None}
    jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
    tstate, tloss, twire = ttr.step(tstate, (_t(x).long(), _t(y).long()), uniforms=uniforms)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(twire.total_bits), float(jwire.total_bits), rtol=1e-6)
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    assert tstate.step == 1


def test_two_rank_gloo_trainer_step_equals_virtual_workers(tmp_path):
    """`bloom_native_p2`'s `Trainer.step` in two processes over gloo: each
    rank's aggregate and residuals equal the single-process encode and loop
    decode of the two ranks' gradients, bitwise, and both ranks end on the
    same parameters."""
    world = 2
    knobs = _knobs("bloom_native_p2", seed=SEED, min_compress_size=100)
    batches = [(_t(x).long(), _t(y).long()) for x, y in _tokens(world, seed=6)]
    model = ("WordLSTM", dict(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN, seed=1))
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=run_trainer_rank, args=(r, world, store, outs[r], knobs, batches, model))
             for r in range(world)]
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
    for n, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][n]), n
    ex = port.GradientExchanger(got[0]["grads"], port.DeepReduceConfig(**knobs), device="cpu")
    assert len(ex.fused.host_units) >= 5
    zeros = {n: torch.zeros_like(g) for n, g in got[0]["grads"].items()}
    bufs, comps = [], []
    for w in range(world):
        buf, comp, _ = ex.encode_worker(got[w]["grads"], zeros, step=0, worker=w)
        bufs.append(buf)
        comps.append(comp)
    for r in range(world):
        agg, own = ex.decode_aggregate(torch.stack(bufs), own=r)
        for n in ex.names:
            assert torch.equal(got[r]["agg"][n], agg[n]), (r, n)
            assert torch.equal(got[r]["residuals"][n], comps[r][n] - own[n]), (r, n)
