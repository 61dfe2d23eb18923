"""Port parity for NeuMF (`models/ncf.py`) and the Table-6 per-leaf encode
(`chip_smoke.table6_route`, `ncf_batch`: benchmarks/ncf_table6.py's routing
and batches) against the JAX package on the CPU, with the weights carried
across by `weights.params_from_flax`.

NeuMF keeps its widths (mf_dim 64, MLP 256-256-128-64) at 20,000 users and
3,000 items. The forward agrees to rtol 1e-5 (atol 1e-6) and the loss to
rel 1e-5: torch's `exp` and `log1p` are not XLA's to the last bit; the
gradients to rtol 1e-4 and atol 1e-5 of the leaf's largest magnitude
(sums in another order). Their zero patterns, which decide the routes, are
equal.

The Table-6 encode at 10^4 interactions: the natural sparsity, budgets and
routes from each package's own gradient are equal; then both packages'
codecs encode JAX's gradient mapped onto the 2**-6 grid with its zero
pattern kept (so QSGD's bucket norms are exact in both), with JAX's QSGD
uniforms injected: every payload leaf, the wire bits and the decoded leaf
are bitwise equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_slice import _t

import chip_smoke
from deepreduce_tpu import sparse as jsparse
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.ncf import NeuMF as JNeuMF
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import sparse as psparse
from deepreduce_tpu_torch.models import NeuMF
from deepreduce_tpu_torch.models.ncf import sigmoid_bce_mean
from deepreduce_tpu_torch.weights import flatten_flax, params_from_flax

USERS, ITEMS = 20_000, 3_000


@functools.lru_cache(maxsize=None)
def _jax():
    model = JNeuMF(num_users=USERS, num_items=ITEMS)
    users, items, _ = chip_smoke.ncf_batch(0, USERS, ITEMS, interactions=10_000)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(users[:2]), jnp.asarray(items[:2]))["params"]

    def loss(p, u, i, z):
        return optax.sigmoid_binary_cross_entropy(model.apply({"params": p}, u, i), z).mean()

    return model, params, jax.jit(jax.value_and_grad(loss))


def _port_model(params):
    model = NeuMF(num_users=USERS, num_items=ITEMS)
    model.load_flax_params(params_from_flax(jax.device_get(params)))
    return model


def _port_grads(model, batch):
    users, items, labels = (torch.from_numpy(a) for a in batch)
    model.zero_grad()
    loss = sigmoid_bce_mean(model(users, items), labels)
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in model.flax_params().items()}


def test_names_and_full_width_parameter_count():
    _, params, _ = _jax()
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    jnames = ["/".join(k.key for k in path) for path, _ in leaves]
    own = NeuMF(num_users=USERS, num_items=ITEMS).flax_params()
    assert sorted(own, key=lambda n: n.split("/")) == jnames
    full = NeuMF().flax_params()
    assert sum(p.numel() for p in full.values()) == 31_832_577


def test_forward_loss_and_gradients_match_flax():
    model, params, grad_fn = _jax()
    batch = chip_smoke.ncf_batch(0, USERS, ITEMS, interactions=10_000)
    jloss, jgrads = grad_fn(params, *batch)
    jlogits = model.apply({"params": params}, batch[0], batch[1])
    pmodel = _port_model(params)
    with torch.no_grad():
        logits = pmodel(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    torch.testing.assert_close(logits, _t(jlogits), rtol=1e-5, atol=1e-6)
    loss, grads = _port_grads(pmodel, batch)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    jg = {n: _t(g) for n, g in flatten_flax(jax.device_get(jgrads)).items()}
    for n, g in grads.items():
        assert torch.equal(g != 0, jg[n] != 0), n
        torch.testing.assert_close(g, jg[n], rtol=1e-4, atol=1e-5 * float(jg[n].abs().max()),
                                   msg=lambda m, n=n: f"{n}: {m}")


def _on_grid(g):
    """g on the 2**-6 grid within [-1, 1], every nonzero kept nonzero."""
    scale = np.abs(g).max()
    q = np.maximum(1.0, np.round(np.abs(g) / scale * 64)) * np.sign(g)
    return (q * 2.0**-6).astype(np.float32)


def test_table6_routing_and_encode_match_jax():
    model, params, grad_fn = _jax()
    sample_batch = chip_smoke.ncf_batch(0, USERS, ITEMS, interactions=10_000)
    fresh_batch = chip_smoke.ncf_batch(1, USERS, ITEMS, interactions=10_000)
    _, jsample = grad_fn(params, *sample_batch)
    _, jfresh = grad_fn(params, *fresh_batch)
    jsample, jfresh = flatten_flax(jax.device_get(jsample)), flatten_flax(jax.device_get(jfresh))
    pmodel = _port_model(params)
    _, psample = _port_grads(pmodel, sample_batch)
    _, pfresh = _port_grads(pmodel, fresh_batch)
    key = jax.random.PRNGKey(0)
    routes = {}
    for n in sorted(jsample, key=lambda n: n.split("/")):
        # the JAX script's routing (benchmarks/ncf_table6.py:138-145)
        jratio = jsparse.calibrate_threshold_budget(jnp.asarray(jsample[n]), 0.0, safety=1.25)
        route, ratio, knobs = chip_smoke.table6_route(psample[n])
        assert ratio == jratio, n
        routes[n] = route
        assert route == ("dense_qsgd" if jratio >= 1.0 else "threshold_bloom_qsgd"), n
        assert float(psparse.natural_sparsity(pfresh[n])) == float(jsparse.natural_sparsity(jnp.asarray(jfresh[n])))
        jcfg, pcfg = JConfig(**knobs), port.DeepReduceConfig(**knobs)
        shape = jfresh[n].shape
        jc, pc = JTensorCodec(shape, jcfg, name=n), port.TensorCodec(shape, pcfg, name=n, device="cpu")
        g = _on_grid(jfresh[n])
        jpay = jax.jit(lambda t: jc.encode(t, step=0, key=key))(jnp.asarray(g))
        uniforms = None
        if pc.rows_leaf is not None:
            meta = jc.val_codec.meta
            uniforms = _t(jax.random.uniform(key, (meta.num_buckets * meta.bucket_size,)))
        ppay = pc.encode(_t(g), step=0, worker=0, uniforms=uniforms)
        jleaves, pleaves = jax.tree_util.tree_leaves(jpay), ppay.leaves()
        assert len(jleaves) == len(pleaves) == len(pc.payload_specs()), n
        for jl, pl, (spec_shape, spec_dtype) in zip(jleaves, pleaves, pc.payload_specs()):
            assert tuple(pl.shape) == tuple(spec_shape) and pl.dtype == spec_dtype, n
            assert np.array_equal(np.asarray(jl).reshape(-1).view(np.uint8), pl.reshape(-1).numpy().view(np.uint8)), n
        jw, pw = jc.wire_stats(jpay), pc.wire_stats(ppay)
        for f in ("index_bits", "value_bits", "dense_bits", "saturated"):
            assert float(np.asarray(getattr(jw, f))) == float(getattr(pw, f)), (n, f)
        # the port decodes as the jitted JAX package does (`/ q` as `* fl(1/q)`)
        assert torch.equal(pc.decode(ppay), _t(jax.jit(lambda p: jc.decode(p, step=0))(jpay))), n
        if route == "threshold_bloom_qsgd":
            assert int(psparse.threshold_overflow(pfresh[n], 0.0, budget_ratio=ratio)) == int(
                jsparse.threshold_overflow(jnp.asarray(jfresh[n]), 0.0, budget_ratio=jratio)), n
    # both routes are exercised: the user tables are naturally sparse
    assert routes["mf_user/embedding"] == routes["mlp_user/embedding"] == "threshold_bloom_qsgd"
    assert routes["mf_item/embedding"] == "dense_qsgd"
