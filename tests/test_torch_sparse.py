"""Port parity: top-k selection (with heavy zero ties), the rank-inversion
helpers, scatter, the name hash and the residual memory against the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreduce_tpu import memory as jmemory
from deepreduce_tpu import sparse as jsparse
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch import sparse as tsparse


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d,ratio,nonzero", [(5000, 0.1, 100), (4096, 0.25, 0), (1000, 0.1, 1000), (96, 0.1, 3)])
def test_topk_matches_jax_under_zero_ties(d, ratio, nonzero):
    # fewer nonzeros than k (or none): the rest of the selection is zeros,
    # and JAX takes the lowest indices among them
    rng = np.random.default_rng(d + nonzero)
    g = np.zeros(d, np.float32)
    where = rng.choice(d, size=nonzero, replace=False)
    g[where] = rng.normal(size=nonzero).astype(np.float32)
    # duplicated magnitudes of both signs tie too
    g[where[: nonzero // 4]] = np.float32(0.5) * np.sign(g[where[: nonzero // 4]])
    j = jsparse.topk(jnp.asarray(g).reshape(-1, 8) if d % 8 == 0 else jnp.asarray(g), ratio)
    t = tsparse.topk(_t(g).reshape(-1, 8) if d % 8 == 0 else _t(g), ratio)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert int(t.nnz) == int(j.nnz) and t.shape == j.shape
    assert t.indices.dtype == torch.int32


def test_select_bit_bitwise():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=2000, dtype=np.uint64)
    t = rng.integers(0, 32, size=2000).astype(np.int32)
    ref = np.asarray(jsparse._select_bit(jnp.asarray(words.astype(np.uint32)), jnp.asarray(t)))
    got = tsparse._select_bit(_t(words.astype(np.int64)), _t(t.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_scatter_ascending_and_fit_length():
    d, budget, nsel = 300, 40, 25
    rng = np.random.default_rng(1)
    pos = np.sort(rng.choice(d, size=budget, replace=False)).astype(np.int32)
    vals = rng.normal(size=budget).astype(np.float32)
    ref = jsparse.scatter_ascending(jnp.asarray(vals), jnp.asarray(pos), jnp.asarray(nsel, jnp.int32), d)
    got = tsparse.scatter_ascending(_t(vals), _t(pos), torch.tensor(nsel, dtype=torch.int32), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for n in (10, 40, 55):
        np.testing.assert_array_equal(
            tsparse.fit_length(_t(vals), n).numpy(), np.asarray(jsparse.fit_length(jnp.asarray(vals), n))
        )


def test_sparse_grad_to_dense_matches_jax():
    rng = np.random.default_rng(2)
    idx = np.sort(rng.choice(50, size=8, replace=False)).astype(np.int32)
    vals = rng.normal(size=8).astype(np.float32)
    j = jsparse.SparseGrad(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(5, jnp.int32), (5, 10))
    t = tsparse.SparseGrad(_t(vals), _t(idx), torch.tensor(5, dtype=torch.int32), (5, 10))
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))


@pytest.mark.parametrize("name", ["", "Embed_0/embedding", "OptimizedLSTMCell_0/hf/bias", "ünï/çødé"])
def test_stable_name_hash_matches(name):
    assert tsparse.stable_name_hash(name) == jsparse.stable_name_hash(name)


def test_per_tensor_stream_is_distinct():
    seen = {
        tsparse.per_tensor_stream(0, name, step, worker)
        for name in ("a", "b")
        for step in range(3)
        for worker in range(4)
    }
    assert len(seen) == 24


def test_memory_matches_jax():
    rng = np.random.default_rng(3)
    names = ["a", "b/c"]
    g = {n: rng.normal(size=(4, 5)).astype(np.float32) for n in names}
    r = {n: rng.normal(size=(4, 5)).astype(np.float32) for n in names}
    dec = {n: rng.normal(size=(4, 5)).astype(np.float32) for n in names}
    tg, tr, td = ({n: _t(x[n]) for n in names} for x in (g, r, dec))
    jg, jr, jd = ({n: jnp.asarray(x[n]) for n in names} for x in (g, r, dec))
    for beta, gamma in ((1.0, 1.0), (0.9, 0.5)):
        jc = jmemory.compensate(jg, jr, beta=beta, gamma=gamma)
        tc = tmemory.compensate(tg, tr, beta=beta, gamma=gamma)
        for n in names:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        ju, tu = jmemory.update(jc, jd), tmemory.update(tc, td)
        for n in names:
            np.testing.assert_array_equal(tu[n].numpy(), np.asarray(ju[n]))
    z = tmemory.init(tg)
    assert all(float(z[n].abs().sum()) == 0.0 and z[n].shape == tg[n].shape for n in names)


# -- random-k and the threshold sparsifier ----------------------------------- #


def _natural(d, touched, seed, width=8):
    """An embedding-like gradient: `touched` rows of `width` nonzeros, the
    rest exactly zero."""
    rng = np.random.default_rng(seed)
    g = np.zeros((d // width, width), np.float32)
    rows = rng.choice(d // width, size=touched, replace=False)
    g[rows] = rng.normal(size=(touched, width)).astype(np.float32)
    return g.reshape(-1)


@pytest.mark.parametrize("d,ratio", [(2048, 0.1), (65536, 0.01), (5000, 0.5)])
def test_randomk_matches_jax_given_its_uniforms(d, ratio):
    """Bitwise with JAX's priorities injected; ties among them (uniforms of
    2**23 values) break toward the lower index in both."""
    import jax

    g = np.random.default_rng(d).normal(size=d).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    pri = _t(jax.random.uniform(key, (d,)))
    j = jsparse.randomk(jnp.asarray(g), ratio, key)
    t = tsparse.randomk(_t(g), ratio, (0, 0), uniforms=pri)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert int(t.nnz) == int(j.nnz) == tsparse.num_slots(d, ratio)
    # the Philox draws: a fixed stream repeats, another stream differs
    a = tsparse.randomk(_t(g), ratio, (5, 1 << 32))
    assert torch.equal(a.indices, tsparse.randomk(_t(g), ratio, (5, 1 << 32)).indices)
    assert not torch.equal(a.indices, tsparse.randomk(_t(g), ratio, (5, 2 << 32)).indices)
    assert torch.equal(a.indices, torch.sort(a.indices).values) and len(set(a.indices.tolist())) == a.k


@pytest.mark.parametrize("d,touched,ratio,thr", [
    (8192, 100, 0.2, 0.0),   # natural sparsity inside the budget
    (8192, 400, 0.2, 0.0),   # more nonzeros than the budget: the largest win
    (4096, 60, 0.2, 0.5),    # a positive threshold
    (4096, 60, 0.2, 50.0),   # above max |g|: clamped to it, one survivor
    (1024, 0, 0.1, 0.0),     # all zero: nothing kept
])
def test_threshold_and_its_diagnostics_match_jax(d, touched, ratio, thr):
    g = _natural(d, touched, seed=d + touched)
    j = jsparse.threshold(jnp.asarray(g), thr, budget_ratio=ratio)
    t = tsparse.threshold(_t(g), thr, budget_ratio=ratio)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert int(t.nnz) == int(j.nnz) and t.nnz.dtype == torch.int32
    for th in (thr, 0.0):
        assert int(tsparse.threshold_overflow(_t(g), th, budget_ratio=ratio)) == int(
            jsparse.threshold_overflow(jnp.asarray(g), th, budget_ratio=ratio))
        assert float(tsparse.natural_sparsity(_t(g), th)) == float(jsparse.natural_sparsity(jnp.asarray(g), th))
    grads = {"a": g, "b": _natural(d, touched // 2, seed=1)}
    assert tsparse.calibrate_threshold_budget({n: _t(x) for n, x in grads.items()}, thr) == \
        jsparse.calibrate_threshold_budget(grads, thr)
