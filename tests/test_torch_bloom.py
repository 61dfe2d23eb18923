"""Port parity: the mod- and hash-blocked bloom codec and its policies
against the JAX package, bitwise (hash words, filter words, membership,
positions, the random policies' selections given the JAX package's
uniforms, decoded tensors, the measured false-positive rate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu.sparse import _prefix_positions as j_prefix_positions
from deepreduce_tpu_torch import ops as tops
from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.codecs import bloom as tbloom
from deepreduce_tpu_torch.ops import bloom_mod
from deepreduce_tpu_torch.sparse import SparseGrad, _prefix_positions, topk


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32_words(rng, n):
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    x[:3] = [0, 2**32 - 1, 2**31]
    return x


def test_fmix32_bitwise():
    x = _u32_words(np.random.default_rng(0), 4096)
    ref = np.asarray(jbloom.fmix32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(tbloom.fmix32(_t(x.astype(np.int64))).numpy(), ref)


@pytest.mark.parametrize("num_hash", [1, 3, 6, 7, 12])
def test_lane_mask_bitwise(num_hash):
    idx = np.random.default_rng(num_hash).integers(0, 5_000_000, size=3000).astype(np.int32)
    ref = np.asarray(jbloom.lane_mask(jnp.asarray(idx), num_hash)).astype(np.int64)
    np.testing.assert_array_equal(tbloom.lane_mask(_t(idx), num_hash).numpy(), ref)


@pytest.mark.parametrize(
    "k,d,fpr,policy",
    [(96038, 960384, 0.02, "p0"), (53, 536, 0.02, "p0"), (400, 4000, None, "leftmost"), (1, 12, 0.3, "p0")],
)
def test_meta_geometry_matches(k, d, fpr, policy):
    j = jbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked="mod")
    t = tbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked="mod")
    assert (t.m_bits, t.num_hash, t.fpr, t.budget, t.d, t.k) == (
        j.m_bits, j.num_hash, j.fpr, j.budget, j.d, j.k,
    )


def test_meta_rejects_unported_layouts():
    with pytest.raises(ValueError, match="bloom_blocked"):
        tbloom.BloomMeta.create(10, 100, blocked="diagonal")
    # exact P2 is the C++ host library's alone (codecs.bloom_native)
    with pytest.raises(ValueError, match="policy"):
        tbloom.BloomMeta.create(10, 100, policy="conflict_sets", blocked="mod")
    with pytest.raises(ValueError, match="threshold_insert"):
        tbloom.BloomMeta.create(10, 100, blocked="hash", threshold_insert=True)


def _dense(d, seed, zero_frac=0.5):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=d).astype(np.float32)
    g[rng.random(d) < zero_frac] = 0.0
    return g


def _pair(d, ratio, fpr, policy, seed):
    g = _dense(d, seed)
    k = max(1, int(d * ratio))
    jm = jbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked="mod")
    tm = tbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked="mod")
    return g, k, jm, tm


@pytest.mark.parametrize("d,ratio,fpr,policy,nnz_cut", [
    (4000, 0.1, 0.02, "p0", 0), (7919, 0.05, 0.05, "p0", 17), (3000, 0.1, 0.2, "leftmost", 0),
])
def test_insert_query_encode_decode_bitwise(d, ratio, fpr, policy, nnz_cut):
    g, k, jm, tm = _pair(d, ratio, fpr, policy, seed=d)
    tsp = topk(_t(g), ratio)
    nnz = k - nnz_cut  # dead slots must not reach the filter
    idx = tsp.indices.numpy()
    jwords = np.asarray(jbloom.insert(jnp.asarray(idx), jnp.asarray(nnz, jnp.int32), jm))
    twords = tbloom.insert(tsp.indices, torch.tensor(nnz, dtype=torch.int32), tm)
    np.testing.assert_array_equal(twords.numpy().view(np.uint32), jwords)

    jmask = np.asarray(jbloom.query_universe(jnp.asarray(jwords), jm))
    np.testing.assert_array_equal(tbloom.query_universe(twords, tm).numpy(), jmask)

    jsp = JSparseGrad(
        values=jnp.asarray(tsp.values.numpy()), indices=jnp.asarray(idx),
        nnz=jnp.asarray(nnz, jnp.int32), shape=(d,),
    )
    tsp_cut = SparseGrad(tsp.values, tsp.indices, torch.tensor(nnz, dtype=torch.int32), (d,))
    jpay = jbloom.encode(jsp, jnp.asarray(g), jm)
    tpay = tbloom.encode(tsp_cut, _t(g), tm)
    np.testing.assert_array_equal(tpay.words.numpy().view(np.uint32), np.asarray(jpay.words))
    assert int(tpay.nsel) == int(jpay.nsel)
    np.testing.assert_array_equal(tpay.values.numpy(), np.asarray(jpay.values))

    jdec = np.asarray(jbloom.decode_dense(jpay, jm, (d,)))
    np.testing.assert_array_equal(tbloom.decode_dense(tpay, tm, (d,)).numpy(), jdec)
    assert float(tbloom.wire_bits(tpay, tm)) == float(jbloom.wire_bits(jpay, jm))


def test_more_positives_than_budget_truncates_like_jax():
    # leftmost's budget is k: with a loose filter the false positives push
    # the positive count past it, and the ascending prefix is cut at k
    d, ratio, fpr = 5000, 0.1, 0.3
    g, k, jm, tm = _pair(d, ratio, fpr, "leftmost", seed=3)
    tsp = topk(_t(g), ratio)
    jsp = JSparseGrad(
        values=jnp.asarray(tsp.values.numpy()), indices=jnp.asarray(tsp.indices.numpy()),
        nnz=jnp.asarray(k, jnp.int32), shape=(d,),
    )
    jpay = jbloom.encode(jsp, jnp.asarray(g), jm)
    tpay = tbloom.encode(tsp, _t(g), tm)
    positives = int(tbloom.query_universe(tpay.words, tm).sum())
    assert positives > tm.budget
    assert int(tpay.nsel) == int(jpay.nsel) == tm.budget
    assert bool(tbloom.saturated(tpay, tm)) and bool(jbloom.saturated(jpay, jm))
    np.testing.assert_array_equal(tpay.values.numpy(), np.asarray(jpay.values))
    np.testing.assert_array_equal(
        tbloom.decode_dense(tpay, tm, (d,)).numpy(), np.asarray(jbloom.decode_dense(jpay, jm, (d,)))
    )


@pytest.mark.parametrize("d,density,budget", [(1000, 0.1, 150), (1000, 0.3, 150), (77, 0.5, 77), (4096, 0.0, 64)])
def test_prefix_positions_bitwise(d, density, budget):
    # covers dead slots (fewer positives than budget), truncation, an
    # all-false mask and a ragged last group word
    mask = np.random.default_rng(d + budget).random(d) < density
    jpos, jcount = j_prefix_positions(jnp.asarray(mask), budget)
    tpos, tcount = _prefix_positions(_t(mask), budget)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert int(tcount) == int(jcount)


def test_u32_bits_round_trip():
    w = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    bits = u32.to_bits(w)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), w.numpy().astype(np.uint32))
    np.testing.assert_array_equal(u32.from_bits(bits).numpy(), w.numpy())


# -- the hash layout, the random policies, the list decode, the FPR ---------- #


_j_encode = jax.jit(jbloom.encode, static_argnums=2, static_argnames=("step", "seed"))
_j_query = jax.jit(jbloom.query_universe, static_argnums=1)
_j_select = jax.jit(jbloom.select, static_argnums=1, static_argnames=("step", "seed"))
_j_decode = jax.jit(jbloom.decode, static_argnums=(1, 2), static_argnames=("step", "seed"))
_j_decode_dense = jax.jit(jbloom.decode_dense, static_argnums=(1, 2), static_argnames=("step", "seed"))
_j_measured_fpr = jax.jit(jbloom.measured_fpr, static_argnums=2)


def _jax_select_uniforms(seed, step, n):
    """The JAX package's draws of the random policies: keyed by (seed, step)."""
    return _t(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(step)), (n,)))


@pytest.mark.parametrize("d,k,fpr", [(20_000, 2000, 0.02), (4096, 400, None)])
def test_hash_layout_bitwise(d, k, fpr):
    jm = jbloom.BloomMeta.create(k, d, fpr=fpr, policy="p0", blocked="hash")
    tm = tbloom.BloomMeta.create(k, d, fpr=fpr, policy="p0", blocked="hash")
    assert (tm.m_bits, tm.num_hash, tm.budget, tm.blocked) == (jm.m_bits, jm.num_hash, jm.budget, "hash")
    idx = _t(np.random.default_rng(d).integers(0, d, size=5000).astype(np.int32))
    jb, jmask = jbloom.blocked_block_and_mask(jnp.asarray(idx.numpy()), jm)
    tb, tmask = tbloom.blocked_block_and_mask(idx, tm)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask).astype(np.int64))
    g = _dense(d, seed=k)
    sp = topk(_t(g), 1.0, k=k)
    jsp = JSparseGrad(jnp.asarray(sp.values.numpy()), jnp.asarray(sp.indices.numpy()), jnp.int32(k), (d,))
    jp, tp = _j_encode(jsp, jnp.asarray(g), jm), tbloom.encode(sp, _t(g), tm)
    np.testing.assert_array_equal(tp.words.numpy(), np.asarray(jp.words).view(np.int32))
    np.testing.assert_array_equal(tbloom.query_universe(tp.words, tm).numpy(), np.asarray(_j_query(jp.words, jm)))
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    assert int(tp.nsel) == int(jp.nsel)
    np.testing.assert_array_equal(tbloom.decode_dense(tp, tm, (d,)).numpy(), np.asarray(_j_decode_dense(jp, jm, (d,))))


@pytest.mark.parametrize("policy", ["random", "conflict_sets_approx"])
@pytest.mark.parametrize("blocked,d,k,fpr", [("mod", 20_000, 2000, 0.02), ("hash", 8192, 800, 0.1),
                                             (False, 4096, 400, 0.3), ("mod", 2048, 1000, 0.6)])
def test_random_policies_bitwise_given_jax_uniforms(policy, blocked, d, k, fpr):
    """P1 and the approximate P2 with JAX's uniforms injected: the selection,
    its count, the FP-aware values, the list and the dense decodes, bitwise.
    Then with the Philox draws: encode and decode agree on the selection."""
    step, seed = 3, 7
    jm = jbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked=blocked)
    tm = tbloom.BloomMeta.create(k, d, fpr=fpr, policy=policy, blocked=blocked)
    assert (tm.m_bits, tm.num_hash, tm.budget) == (jm.m_bits, jm.num_hash, jm.budget)
    g = _dense(d, seed=d + k)
    sp = topk(_t(g), 1.0, k=k)
    jsp = JSparseGrad(jnp.asarray(sp.values.numpy()), jnp.asarray(sp.indices.numpy()), jnp.int32(k), (d,))
    n = d if policy == "random" else jbloom.p0_budget(k, d, jm.fpr)
    u = _jax_select_uniforms(seed, step, n)
    jp = _j_encode(jsp, jnp.asarray(g), jm, step=step, seed=seed)
    tp = tbloom.encode(sp, _t(g), tm, step=step, seed=seed, uniforms=u)
    np.testing.assert_array_equal(tp.words.numpy(), np.asarray(jp.words).view(np.int32))
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    assert int(tp.nsel) == int(jp.nsel)
    mask = tbloom.query_universe(tp.words, tm)
    jsel, jcount = _j_select(jnp.asarray(mask.numpy()), jm, step=step, seed=seed)
    tsel, tcount = tbloom.select(mask, tm, step=step, seed=seed, uniforms=u)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert int(tcount) == int(jcount) and tsel.dtype == torch.int32
    jl, tl = _j_decode(jp, jm, (d,), step=step, seed=seed), tbloom.decode(tp, tm, (d,), step=step, seed=seed, uniforms=u)
    np.testing.assert_array_equal(tl.indices.numpy(), np.asarray(jl.indices))
    assert int(tl.nnz) == int(jl.nnz)
    np.testing.assert_array_equal(tbloom.decode_dense(tp, tm, (d,), step=step, seed=seed, uniforms=u).numpy(),
                                  np.asarray(_j_decode_dense(jp, jm, (d,), step=step, seed=seed)))
    # the Philox draws: the decoder re-derives the encoder's selection
    own = tbloom.encode(sp, _t(g), tm, step=step, seed=seed)
    dec = tbloom.decode_dense(own, tm, (d,), step=step, seed=seed).numpy()
    assert np.count_nonzero(dec) == np.count_nonzero(own.values.numpy())
    assert np.all(dec[dec != 0] == g[dec != 0])
    other_step = tbloom.select(mask, tm, step=step + 1, seed=seed)[0]
    assert not torch.equal(other_step, tbloom.select(mask, tm, step=step, seed=seed)[0])


@pytest.mark.parametrize("blocked", [False, "hash", "mod"])
def test_measured_fpr_and_fp_stats_match_jax(blocked):
    d, k = 20_000, 2000
    jm = jbloom.BloomMeta.create(k, d, fpr=0.05, policy="p0", blocked=blocked)
    tm = tbloom.BloomMeta.create(k, d, fpr=0.05, policy="p0", blocked=blocked)
    g = _dense(d, seed=5)
    sp = topk(_t(g), 1.0, k=k)
    jsp = JSparseGrad(jnp.asarray(sp.values.numpy()), jnp.asarray(sp.indices.numpy()), jnp.int32(k), (d,))
    jp, tp = _j_encode(jsp, jnp.asarray(g), jm), tbloom.encode(sp, _t(g), tm)
    got = tbloom.measured_fpr(sp, tp.words, tm)
    assert got.dtype == torch.float32 and float(got) == float(_j_measured_fpr(jsp, jp.words, jm))
    assert 0.0 < float(got) < 0.2
    from deepreduce_tpu.codecs.registry import BloomCodec as JBloomCodec

    fp, universe = tbloom.fp_stats(tp, tm)
    jfp, juni = jax.jit(JBloomCodec(k, d, dict(fpr=0.05, policy="p0", bloom_blocked=blocked)).fp_stats)(jp)
    assert (float(fp), float(universe)) == (float(jfp), float(juni))


# -- the mod layout under a prefix policy: the torch code the card's kernels
# (ops/bloom_mod.py) equal, and the rule that chooses them ------------------ #


def _mod_meta(d, k, n_words, h, budget, policy="p0"):
    return tbloom.BloomMeta(d=d, k=k, m_bits=32 * n_words, num_hash=h, fpr=0.01, policy=policy, budget=budget,
                            blocked="mod")


def _spec_hits(words, meta):
    """The universe positives by the kernels' definition, in numpy: j < d
    with (words[j mod W] & lane_mask(j)) == lane_mask(j)."""
    j = np.arange(meta.d)
    m = tbloom.lane_mask(torch.from_numpy(j), meta.num_hash).numpy()
    w = words.numpy().view(np.uint32).astype(np.int64)[j % meta.n_words]
    return np.nonzero((w & m) == m)[0]


# (d, k, W, h, nnz cut, budget: "under" the hits, "exact", "over" them)
EDGE = [
    (1001, 60, 47, 5, 7, "over"),     # d = 1,001, not a multiple of W; nnz < k; fewer hits than budget
    (1001, 60, 47, 9, 0, "exact"),    # h > 6: two mixes; exactly `budget` hits
    (1001, 80, 23, 3, 0, "under"),    # more hits than budget
    (4099, 120, 101, 12, 31, "over"),
    (777, 1, 1, 1, 0, "under"),       # one word
]


def _edge_case(d, k, n_words, h, cut, mode, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(d, size=k, replace=False)).astype(np.int32)
    nnz = k - cut
    # the insert's words under a wide budget give the hit count the budget is set from
    meta = _mod_meta(d, k, n_words, h, d)
    words = tbloom.insert(torch.from_numpy(idx), torch.tensor(nnz, dtype=torch.int32), meta)
    hits = _spec_hits(words, meta).shape[0]
    budget = {"over": min(d, hits + 13), "exact": hits, "under": max(1, hits - 9)}[mode]
    flat = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    return idx, nnz, _mod_meta(d, k, n_words, h, budget), words, flat


def _bloom_launches():
    return {name: n for name, n in tops.launch_counts().items() if name.startswith("bloom_mod")}


@pytest.mark.parametrize("d,k,n_words,h,cut,mode", EDGE)
def test_bloom_mod_plain_entry_points_match_the_composition(d, k, n_words, h, cut, mode):
    """The three stages the card's kernels take over, as the codec runs them
    on CPU tensors (`insert`, `_fp_aware_payload`, `decode_dense`): bitwise
    the numpy spec the kernels implement (the OR of live lane masks; values
    at the first `budget` positives; the rank inversion bounded by
    min(nsel, budget, len(vals))), and no kernel launch counted."""
    before = _bloom_launches()
    idx, nnz, meta, words, flat = _edge_case(d, k, n_words, h, cut, mode, seed=d + h)

    want = np.zeros(n_words, dtype=np.uint32)
    live = idx[:nnz]
    np.bitwise_or.at(want, live % n_words, tbloom.lane_mask(torch.from_numpy(live), h).numpy().astype(np.uint32))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert words.dtype == torch.int32

    hits = _spec_hits(words, meta)
    assert {"over": hits.shape[0] < meta.budget, "exact": hits.shape[0] == meta.budget,
            "under": hits.shape[0] > meta.budget}[mode]
    payload = tbloom._fp_aware_payload(words, flat, meta)
    values, nsel = payload.values, payload.nsel
    take = hits[: meta.budget]
    want_v = np.zeros(meta.budget, dtype=np.float32)
    want_v[: take.shape[0]] = flat.numpy()[take]
    np.testing.assert_array_equal(values.numpy(), want_v)
    assert nsel.dtype == torch.int32 and int(nsel) == take.shape[0]
    # and the codec's composition for the other policies' path: select, then gather
    pos, cnt = tbloom.select(tbloom.query_universe(words, meta), meta)
    assert torch.equal(values, torch.where(torch.arange(meta.budget) < cnt, flat[pos.long()], 0.0))
    assert torch.equal(nsel, cnt)

    vals = torch.from_numpy(np.random.default_rng(k).normal(size=meta.budget).astype(np.float32))
    for table, count in ((vals, nsel), (vals[: max(0, meta.budget - 7)], nsel), (vals, nsel - 3),
                         (vals, torch.tensor(meta.budget + 5, dtype=torch.int32))):
        bound = max(0, min(int(count), meta.budget, table.shape[0], take.shape[0]))
        want_d = np.zeros(d, dtype=np.float32)
        want_d[take[:bound]] = table.numpy()[:bound]
        got = tbloom.decode_dense(tbloom.BloomPayload(values=vals, words=words, nsel=count), meta, (d,), values=table)
        np.testing.assert_array_equal(got.numpy(), want_d)
    assert _bloom_launches() == before


class _OnCard:
    is_cuda = True


@pytest.mark.parametrize("blocked,policy,kernel", [("mod", "leftmost", True), ("mod", "p0", True),
                                                   ("mod", "random", False), ("hash", "p0", False),
                                                   ("", "leftmost", False)])
def test_bloom_dispatch_takes_the_kernel_entry_for_mod_prefix_only(blocked, policy, kernel):
    """The codec's one rule: the card's kernels for the mod layout under a
    prefix policy with the tensors on the card, its torch code for every
    other layout and policy and on the CPU."""
    meta = tbloom.BloomMeta.create(50, 5000, fpr=0.01, policy=policy, blocked=blocked)
    assert tbloom._on_kernel(meta, _OnCard()) is kernel
    assert tbloom._on_kernel(meta, torch.zeros(3, dtype=torch.int32)) is False


def test_bloom_mod_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch on the card only: CPU tensors raise and
    count no launch (the codec runs its torch code there instead)."""
    meta = _mod_meta(1001, 60, 47, 5, 80)
    idx = torch.arange(0, 600, 10, dtype=torch.int32)
    words = torch.zeros(47, dtype=torch.int32)
    before = _bloom_launches()
    for call in (lambda: bloom_mod.insert(idx, torch.tensor(60), meta),
                 lambda: bloom_mod.select_gather(words, torch.zeros(1001), meta),
                 lambda: bloom_mod.place(words, torch.zeros(80), torch.tensor(3), meta)):
        with pytest.raises(ValueError, match="on the card"):
            call()
    assert _bloom_launches() == before


def test_bloom_mod_vmap_rule_calls_the_entry_once_a_row():
    """Under `torch.func.vmap` an entry point has no storage to launch on:
    its vmap rule calls it once per row of the batch, with unbatched inputs
    shared and rows taken along any batch dimension, and stacks the rows'
    outputs (one tensor or a tuple)."""
    from torch.func import vmap

    meta = _mod_meta(1001, 60, 47, 5, 80)
    rows = []

    def entry(words, flat, meta_):
        assert meta_ is meta and not torch._C._functorch.is_functorch_wrapped_tensor(words)
        assert words.is_contiguous() and flat.is_contiguous()
        rows.append((words.clone(), flat.clone()))
        return words.sum() + flat.sum(), flat[:3] * 2

    words = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    flat = torch.arange(15, dtype=torch.float32).reshape(5, 3)  # batched along dim 1: strided rows
    shared = torch.ones(5)

    sums, heads = vmap(lambda w, f: bloom_mod._PerRow.apply(entry, meta, w, f), in_dims=(0, 1))(words[:3], flat)
    assert len(rows) == 3
    for b in range(3):
        assert torch.equal(rows[b][0], words[b]) and torch.equal(rows[b][1], flat[:, b])
    assert torch.equal(sums, words[:3].sum(1) + flat.sum(0))
    assert torch.equal(heads, flat[:3].T * 2)

    rows.clear()
    out = vmap(lambda w: bloom_mod._PerRow.apply(entry, meta, w, shared), in_dims=0)(words)
    assert len(rows) == 4 and all(torch.equal(f, shared) for _, f in rows)
    assert torch.equal(out[0], words.sum(1) + shared.sum())
