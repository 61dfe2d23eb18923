"""Port parity: the mod-blocked bloom codec against the JAX package, bitwise
(hash words, filter words, membership, positions, decoded tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreduce_tpu.codecs import bloom as jbloom
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu.sparse import _prefix_positions as j_prefix_positions
from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.codecs import bloom as tbloom
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
    with pytest.raises(ValueError, match="mod"):
        tbloom.BloomMeta.create(10, 100, blocked="hash")
    with pytest.raises(ValueError, match="policy"):
        tbloom.BloomMeta.create(10, 100, policy="random", blocked="mod")


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
