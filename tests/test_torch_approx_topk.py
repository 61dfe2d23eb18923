"""`approx_topk=True` in the port: `sparse.topk(approx=True)` selects what
jitted JAX's `sparse.topk(approx=True)` selects on the CPU (XLA computes
`jax.lax.approx_max_k` exactly off the TPU), ties and order included, with
sorted and unsorted indices, on both sides of JAX's d > 4k switch; the
flagship exchange with the knob on matches JAX's; the sparse_rs routes
take it and oktopk refuses it, as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_slice import _assert_same_wire, _cfgs, _grad_tree, _jax_uniforms, _t

from deepreduce_tpu import sparse as jax_sparse
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch import sparse, sparse_rs
from deepreduce_tpu_torch.collectives import collectives_for


def _tied(d: int, seed: int) -> np.ndarray:
    """Values on a coarse grid: most magnitudes are tied with many others,
    zeros included."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, size=d) * 0.25).astype(np.float32)


@pytest.mark.parametrize("sort_indices", [True, False])
@pytest.mark.parametrize("d,k", [(100_000, 1_000), (4_096, 100), (50_000, 5_000), (1_000, 300), (400, 100)])
def test_approx_topk_selects_what_jitted_jax_selects(d, k, sort_indices):
    x = _tied(d, seed=d + k)
    jfn = jax.jit(lambda v: jax_sparse.topk(v, 1.0, sort_indices=sort_indices, approx=True, k=k))
    want = jfn(jnp.asarray(x))
    got = sparse.topk(torch.from_numpy(x), 1.0, sort_indices=sort_indices, approx=True, k=k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert int(got.nnz) == int(want.nnz) == k
    # the flag changes no result: exact top-k selects the same
    exact = sparse.topk(torch.from_numpy(x), 1.0, sort_indices=sort_indices, k=k)
    assert torch.equal(exact.indices, got.indices) and torch.equal(exact.values, got.values)


def test_flagship_exchange_with_approx_topk_matches_jax_mesh():
    """The 4-worker fused DRQSGD-BF-P0 exchange with approx_topk=True: the
    wire bytes JAX's (with JAX's QSGD draws), the aggregate and residuals
    within the norm-rounding bound of the exact-top-k test."""
    W, step, seed = 4, 2, 5
    shapes = {"b": (40,), "a/kernel": (48, 40), "c": (3000,)}  # d > 4k on both compressed leaves
    rng = np.random.default_rng(3)
    res_w = [_grad_tree(rng, shapes) for _ in range(W)]
    grads_w = [_grad_tree(rng, shapes) for _ in range(W)]
    jcfg, tcfg = _cfgs(seed=seed, min_compress_size=100, approx_topk=True)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, jcfg)
    tex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert tex.payload_bytes() == jex.payload_bytes(like)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in shapes}

    def spmd(g, r):
        agg, new_r, _ = jex.exchange({n: x[0] for n, x in g.items()}, {n: x[0] for n, x in r.items()}, step=step)
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                   check_vma=False)
    jagg, jres = jax.jit(fn)(stack(grads_w), stack(res_w))
    bufs, comps = [], []
    for w in range(W):
        keys = jex._keys(jax.random.fold_in(jax.random.PRNGKey(seed), w), jnp.asarray(step, jnp.int32))
        uniforms = {n: _jax_uniforms(jex.codecs[n], keys[n]) for n in shapes if jex.codecs[n].compressed}
        assert len(uniforms) == 2
        buf, comp, _ = tex.encode_worker({n: _t(grads_w[w][n]) for n in shapes},
                                         {n: _t(res_w[w][n]) for n in shapes}, step=step, worker=w,
                                         uniforms=uniforms)
        jcomp = {n: jnp.asarray(grads_w[w][n]) + jnp.asarray(res_w[w][n]) for n in shapes}
        jpay = {n: jex.codecs[n].encode(jcomp[n], step=step, key=keys[n]) for n in shapes}
        _assert_same_wire(tex, buf, _t(jex._pack_fused(jpay)))
        bufs.append(buf)
        comps.append(comp)
    gathered = torch.stack(bufs)
    for w in range(W):
        agg, own = tex.decode_aggregate(gathered, own=w)
        new_res = tmemory.update(comps[w], own)
        for n in shapes:
            np.testing.assert_allclose(agg[n].numpy(), np.asarray(jagg[n][w]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(new_res[n].numpy(), np.asarray(jres[n][w]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rs_mode", ["sparse", "adaptive"])
def test_sparse_rs_routes_take_approx_topk_and_oktopk_refuses_it(rs_mode):
    flat = torch.from_numpy(_tied(5_003, seed=9))
    coll = collectives_for(None)
    kw = dict(ratio=0.05, rs_mode=rs_mode, density_threshold=1.0, stream=(11, 0))
    exact = sparse_rs.exchange(flat, coll, **kw)
    approx = sparse_rs.exchange(flat, coll, approx_topk=True, **kw)
    for a, b in zip(exact[:2], approx[:2]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exact local top-k"):
        sparse_rs.exchange(flat, coll, ratio=0.05, rs_mode="oktopk", approx_topk=True)
