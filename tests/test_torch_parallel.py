"""Port parity for sequence and tensor parallelism (`parallel/mesh.py`,
`functional.py`, `ring.py`, `ulysses.py`, `tp.py`, `data_seq.py` and BERT's
sequence-parallel modes) against the JAX package on the CPU, at
`tests/test_parallel.py`'s sizes and tolerances (2e-5 on the attention
forward, 3e-4 on gradients, 2e-4 on BERT logits).

The JAX side runs `shard_map` over `conftest.shared_mesh`; the port's
workers are threads of a `collectives.InProcessGroup` / `InProcessMesh`, or
four spawned gloo ranks (`tests/torch_ranks.py`) for `make_mesh` over a
real group. Inputs come from numpy seeds; JAX's QSGD uniforms are injected
into the data x sequence step.
"""

import functools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_slice import _jax_flat_params, _jax_uniforms, _t
from torch_ranks import run_mesh_rank

from deepreduce_tpu import parallel as jpar
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models import BertEncoder as JBert
from deepreduce_tpu.models.bert import TransformerLayer as JLayer
from deepreduce_tpu.parallel.ring import ring_self_attention_reference as jref
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import parallel as tpar
from deepreduce_tpu_torch.collectives import InProcessGroup, InProcessMesh, Solo
from deepreduce_tpu_torch.models import BertEncoder
from deepreduce_tpu_torch.models.bert import TransformerLayer
from deepreduce_tpu_torch.parallel.data_seq import DataSeqStep, token_loss
from deepreduce_tpu_torch.parallel.functional import backward
from deepreduce_tpu_torch.parallel.ring import ring_self_attention_reference
from deepreduce_tpu_torch.parallel.tp import from_params, shard, shard_params
from deepreduce_tpu_torch.weights import params_from_flax

BERT = dict(vocab_size=64, hidden=16, layers=2, heads=4, mlp_dim=32, max_len=32)


def _qkv(b=2, s=64, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))


def _chunks(x, n, r):
    c = x.shape[1] // n
    return x[:, r * c : (r + 1) * c]


def _port_attention(fn, qkv, co, n, causal):
    """Each of n in-process workers runs `fn` on its chunks and the
    backward of sum(out * co): the outputs and the gradients of q, k and v,
    concatenated over the sequence."""

    def work(coll, r):
        q, k, v = (_t(_chunks(x, n, r)).requires_grad_() for x in qkv)
        out = fn(q, k, v, coll, causal=causal)
        backward((out * _t(_chunks(co, n, r))).sum())
        return out.detach(), q.grad, k.grad, v.grad

    res = InProcessGroup(n).run(work, list(range(n)))
    return [torch.cat([r[i] for r in res], dim=1).numpy() for i in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_attention(name, n, causal):
    """JAX's sharded attention under shard_map over n devices, jitted:
    (forward, the gradients of sum(out * co) in q, k, v)."""
    fn = {"ring": jpar.ring_attention, "ulysses": jpar.ulysses_attention}[name]
    sharded = shard_map(lambda q, k, v: fn(q, k, v, "seq", causal=causal), mesh=shared_mesh(n, "seq"),
                        in_specs=P(None, "seq"), out_specs=P(None, "seq"))
    grad = jax.grad(lambda q, k, v, co: (sharded(q, k, v) * co).sum(), argnums=(0, 1, 2))
    return jax.jit(sharded), jax.jit(grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,n,h", [("ring", 4, 4), ("ring", 8, 4), ("ulysses", 4, 8)])
def test_sequence_parallel_attention_matches_jax(name, n, h, causal):
    qkv = _qkv(s=32, h=h, seed=3)
    co = np.random.default_rng(9).normal(size=qkv[0].shape).astype(np.float32)
    fwd, grad = _jax_attention(name, n, causal)
    want = [np.asarray(fwd(*qkv))] + [np.asarray(g) for g in grad(*qkv, co)]
    fn = {"ring": tpar.ring_attention, "ulysses": tpar.ulysses_attention}[name]
    got = _port_attention(fn, qkv, co, n, causal)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w, what in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, atol=3e-4, err_msg=what)
    # and the oracle: the port's sharded form against its own unsharded reference
    np.testing.assert_allclose(got[0], ring_self_attention_reference(*map(_t, qkv), causal=causal).numpy(), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_local_forms_match_jax(causal):
    """coll=None: ring attention's single block, Ulysses' dense reference
    and the oracle itself, each against the JAX package's."""
    qkv = _qkv(s=16, seed=4)
    tq = [_t(x) for x in qkv]
    want_ring = np.asarray(jax.jit(lambda q, k, v: jpar.ring_attention(q, k, v, None, causal=causal))(*qkv))
    want_ref = np.asarray(jax.jit(lambda q, k, v: jref(q, k, v, causal=causal))(*qkv))
    np.testing.assert_allclose(tpar.ring_attention(*tq, causal=causal).numpy(), want_ring, atol=2e-5)
    np.testing.assert_allclose(tpar.ulysses_attention(*tq, causal=causal).numpy(), want_ref, atol=2e-5)
    np.testing.assert_allclose(ring_self_attention_reference(*tq, causal=causal).numpy(), want_ref, atol=2e-5)


def test_ulysses_needs_heads_divisible_by_the_group():
    q = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="divisible"):
        InProcessGroup(2).run(lambda coll, _: tpar.ulysses_attention(q, q, q, coll), [0, 1])


@pytest.mark.parametrize("axes", [("data",), ("data", "seq"), ("data", "seq", "model")])
def test_factor_devices_matches_jax(axes):
    for n in range(1, 17):
        assert tpar.factor_devices(n, axes) == jpar.factor_devices(n, axes), n


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2}, {"data": 2, "seq": 4}, {"a": 2, "b": 2, "c": 2}])
def test_in_process_mesh_lays_ranks_out_as_jax(axes):
    """Worker r of an InProcessMesh sits where device r sits in JAX's
    make_mesh, and each of its groups holds the devices of its mesh line,
    in the mesh's order."""
    n = int(np.prod(list(axes.values())))
    mesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    pos = {int(ids[idx]): idx for idx in np.ndindex(ids.shape)}
    names = list(axes)

    def line(r):
        return {a: [int(i) for i in np.moveaxis(ids, k, -1)[tuple(x for j, x in enumerate(pos[r]) if j != k)]]
                for k, a in enumerate(names)}

    members = InProcessMesh(axes).run(lambda m, _: {a: (c.rank, c.world_size) for a, c in m.items()}, list(range(n)))
    for r in range(n):
        for k, a in enumerate(names):
            assert members[r][a] == (pos[r][k], axes[a]), (r, a)
            assert line(r)[a][members[r][a][0]] == r
    # the two-tier grid keeps its layout: worker r's (ici, dcn) ranks
    assert [(i.rank, d.rank) for i, d in (port.InProcessGrid(2, 2).member(r) for r in range(4))] == [
        (0, 0), (1, 0), (0, 1), (1, 1)]


def test_make_mesh_errors_match_jax():
    with pytest.raises(ValueError) as jerr:
        jpar.make_mesh({"ici": 1, "dcn": 1}, devices=jax.devices()[:1], dcn_axis="dcn")
    with pytest.raises(ValueError) as terr:
        tpar.make_mesh({"ici": 1, "dcn": 1}, dcn_axis="dcn")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jpar.make_mesh({"data": 2}, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as terr:
        tpar.make_mesh({"data": 2})
    assert str(terr.value) == str(jerr.value)
    assert all(isinstance(c, Solo) for c in tpar.make_mesh({"data": 1, "seq": 1}).values())


def test_four_gloo_ranks_make_the_mesh_and_run_sequence_parallel_attention(tmp_path):
    """Four spawned gloo ranks: `make_mesh({'data': 2, 'seq': 2})` and
    `make_hybrid_mesh(2, 2)` give each rank the groups of JAX's layout;
    ring and Ulysses attention over the real 'seq' groups (P2P hops,
    all_to_all_single) equal the oracle, forward and gradients."""
    axes, W = {"data": 2, "seq": 2}, 4
    qkv = _qkv(b=1, s=16, h=4, d=8, seed=5)
    co = np.random.default_rng(6).normal(size=qkv[0].shape).astype(np.float32)
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(W)]
    procs = [ctx.Process(target=run_mesh_rank, args=(r, W, store, outs[r], axes, [_t(x) for x in qkv], _t(co)))
             for r in range(W)]
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
    assert [p.exitcode for p in procs] == [0] * W
    res = [torch.load(o) for o in outs]
    ids = np.vectorize(lambda d: d.id)(jpar.make_mesh(axes, devices=jax.devices()[:W]).devices)
    for r in range(W):
        (d, s), = np.argwhere(ids == r)
        assert res[r]["mesh"] == {"data": (d, 2, [int(i) for i in ids[:, s]]), "seq": (s, 2, [int(i) for i in ids[d]])}
        assert res[r]["hybrid"] == {"dcn": (d, 2, [int(i) for i in ids[:, s]]), "ici": (s, 2, [int(i) for i in ids[d]])}
    tq = [_t(x).requires_grad_() for x in qkv]
    want = ring_self_attention_reference(*tq, causal=True)
    (want * _t(co)).sum().backward()
    for name in ("ring", "ulysses"):
        for i, ref in enumerate([want.detach()] + [t.grad for t in tq]):
            # the seq groups of data row 0: ranks 0 and 1 hold chunks 0 and 1
            got = torch.cat([res[r][name][i] for r in (0, 1)], dim=1)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5 if i == 0 else 3e-4, err_msg=f"{name} {i}")
            assert torch.equal(torch.cat([res[r][name][i] for r in (2, 3)], dim=1), got)


# -- BERT's sequence-parallel modes ------------------------------------------ #


def _jax_shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in leaves}


def _seeded(shapes, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in shapes.items():
        if n.endswith("scale"):
            a = 1 + 0.2 * rng.normal(size=s)
        elif n.endswith("bias"):
            a = 0.1 * rng.normal(size=s)
        else:
            a = rng.normal(size=s) / np.sqrt(s[0] if len(s) < 3 or "out" not in n else s[0] * s[1])
        out[n] = a.astype(np.float32)
    return out


def _unflatten(flat):
    tree = {}
    for n, a in flat.items():
        *path, leaf = n.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return tree


@functools.lru_cache(maxsize=None)
def _bert_params(attention):
    """numpy-seeded parameters of the small BERT in `attention`'s layout
    (flax names), and a batch of 2 x 32 tokens."""
    jm = JBert(attention=attention, **BERT)
    toks = np.random.default_rng(0).integers(0, BERT["vocab_size"], size=(2, BERT["max_len"])).astype(np.int32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), toks)
    return _seeded(_jax_shapes(v["params"])), toks


@functools.lru_cache(maxsize=None)
def _jax_bert(attention, causal):
    """JAX's sharded forward over 4 devices (shard_map) and the local twin's
    gradients of the mean cross-entropy on the tokens themselves."""
    flat, toks = _bert_params(attention)
    params = _unflatten(flat)
    sp = JBert(attention=attention, seq_axis="seq", causal=causal, **BERT)
    local = JBert(attention=attention, seq_axis=None, causal=causal, **BERT)
    fwd = jax.jit(shard_map(lambda t: sp.apply({"params": params}, t), mesh=shared_mesh(4, "seq"),
                            in_specs=P(None, "seq"), out_specs=P(None, "seq")))

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(local.apply({"params": p}, toks), toks).mean()

    return np.asarray(fwd(toks)), _jax_flat_params(jax.jit(jax.grad(loss))(params))


def _port_bert_sharded(attention, causal, remat=False, n=4):
    """n in-process workers on their chunks: logits (concatenated) and the
    gradients of the global mean loss (each worker's chunk mean over n,
    summed over the workers)."""
    flat, toks = _bert_params(attention)

    def work(coll, r):
        m = BertEncoder(attention=attention, seq_axis=coll, causal=causal, remat=remat, **BERT)
        m.load_flax_params(params_from_flax(flat))
        t = _t(_chunks(toks, n, r)).long()
        logits = m(t)
        backward(token_loss(logits, t) / n)
        return logits.detach(), {k: p.grad for k, p in m.flax_params().items()}

    res = InProcessGroup(n).run(work, list(range(n)))
    logits = torch.cat([r[0] for r in res], dim=1).numpy()
    grads = {k: sum(r[1][k] for r in res).numpy() for k in res[0][1]}
    return logits, grads


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_bert_sequence_parallel_matches_jax(attention):
    """Logits of the port's 4 sequence-sharded workers against JAX's
    shard_map forward; their summed gradients against JAX's local twin; the
    port's own twin (seq_axis=None) against both; remat equal to no remat."""
    causal = attention == "ring"
    want_logits, want_grads = _jax_bert(attention, causal)
    logits, grads = _port_bert_sharded(attention, causal)
    np.testing.assert_allclose(logits, want_logits, atol=2e-4)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k], g, atol=3e-4, err_msg=k)
    flat, toks = _bert_params(attention)
    twin = BertEncoder(attention=attention, causal=causal, **BERT)
    twin.load_flax_params(params_from_flax(flat))
    assert sorted(twin.flax_params()) == sorted(want_grads)
    with torch.no_grad():
        np.testing.assert_allclose(twin(_t(toks).long()).numpy(), want_logits, atol=2e-4)
    if attention == "ring":
        rlogits, rgrads = _port_bert_sharded(attention, causal, remat=True)
        np.testing.assert_array_equal(rlogits, logits)
        for k, g in grads.items():
            np.testing.assert_allclose(rgrads[k], g, rtol=2e-5, atol=1e-6, err_msg=k)


def test_invalid_mode_combinations_raise_as_jax():
    tokens = jnp.zeros((1, 8), jnp.int32)
    jm = JBert(vocab_size=16, hidden=8, layers=1, heads=2, mlp_dim=16, max_len=8, attention="dense", seq_axis="seq")
    with pytest.raises(ValueError) as jerr:
        jm.init(jax.random.PRNGKey(0), tokens)
    with pytest.raises(ValueError) as terr:
        BertEncoder(vocab_size=16, hidden=8, layers=1, heads=2, mlp_dim=16, max_len=8, attention="dense",
                    seq_axis=InProcessGroup(1).member(0))
    assert str(terr.value) == str(jerr.value) and "sequence-sharded" in str(terr.value)
    mask = np.ones((1, 1, 8, 8), bool)
    with pytest.raises(ValueError) as jerr:
        JLayer(hidden=8, heads=2, mlp_dim=16, attention="ring").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8), jnp.float32), mask=jnp.asarray(mask))
    layer = TransformerLayer(8, 2, 16, torch.Generator().manual_seed(0), None, attention="ring")
    with pytest.raises(ValueError) as terr:
        layer(torch.zeros(1, 8, 8), mask=torch.from_numpy(mask))
    assert str(terr.value) == str(jerr.value) and "causal" in str(terr.value)
    with pytest.raises(ValueError, match="one of"):
        BertEncoder(**BERT, attention="flash")


def test_dense_layer_mask_matches_flax():
    """The dense layer applies flax's boolean mask (the argument JAX's
    TransformerLayer takes); ring and Ulysses refuse one (above)."""
    x = np.random.default_rng(7).normal(size=(2, 6, 8)).astype(np.float32)
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    jl = JLayer(hidden=8, heads=2, mlp_dim=16)
    jv = jax.eval_shape(jl.init, jax.random.PRNGKey(0), x)
    flat = _seeded(_jax_shapes(jv["params"]), seed=2)
    want = np.asarray(jax.jit(lambda p, x, m: jl.apply({"params": p}, x, mask=m))(_unflatten(flat), x, mask))
    layer = TransformerLayer(8, 2, 16, torch.Generator().manual_seed(0), None)
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(_t(flat[n.replace(".", "/")]))
        got = layer(_t(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- tensor parallelism ------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _tp_setup():
    """The dense small BERT at max_len 16: numpy-seeded params, tokens, and
    JAX's single-device logits."""
    kw = dict(BERT, max_len=16)
    jm = JBert(**kw)
    toks = np.random.default_rng(1).integers(0, kw["vocab_size"], size=(2, 16)).astype(np.int32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), toks)
    flat = _seeded(_jax_shapes(v["params"]), seed=3)
    return kw, flat, toks, np.asarray(jax.jit(lambda p, t: jm.apply({"params": p}, t))(_unflatten(flat), toks))


@pytest.mark.parametrize("scope", [None, "params"])
def test_tp_specs_equal_jax_partition_specs(scope):
    """Every parameter's spec equals JAX's PartitionSpec, on the params tree
    (the embedding and the head replicate: their rules need a component
    before `tok` / `mlm`) and under the variables dict's `params` scope
    (they shard the vocabulary)."""
    kw, flat, _, _ = _tp_setup()
    tree = _unflatten(flat) if scope is None else {"params": _unflatten(flat)}
    jspecs = jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                    jpar.tp_shardings(tree, jpar.make_mesh({"model": 2}), jpar.bert_tp_rules()),
                                    is_leaf=lambda x: isinstance(x, NamedSharding))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, tuple))
    want = {"/".join(str(k.key) for k in p[1 if scope else 0:]): s for p, s in leaves}
    got = tpar.tp_shardings(flat, {"model": 2}, tpar.bert_tp_rules(), scope=scope)
    assert got == want
    sharded = {n for n, s in got.items() if any(a is not None for a in s)}
    assert len(sharded) >= 4 * 2 + 3
    assert ({"tok/embedding", "mlm/kernel", "mlm/bias"} <= sharded) == (scope == "params")


@pytest.mark.parametrize("scope", [None, "params"])
def test_shard_params_equal_jax_addressable_shards(scope):
    kw, flat, _, _ = _tp_setup()
    tree = _unflatten(flat) if scope is None else {"params": _unflatten(flat)}
    mesh = jpar.make_mesh({"model": 2})
    placed = jax.device_put(tree, jpar.tp_shardings(tree, mesh, jpar.bert_tp_rules()))
    leaves, _ = jax.tree_util.tree_flatten_with_path(placed if scope is None else placed["params"])
    got = InProcessGroup(2).run(
        lambda coll, _: shard_params(params_from_flax(_unflatten(flat)), {"model": coll}, tpar.bert_tp_rules(),
                                     scope=scope),
        [0, 1])
    assert {"/".join(str(k.key) for k in path) for path, _ in leaves} == set(flat) == set(got[0])
    for r, dev in enumerate(mesh.devices):  # model rank r holds the shard on the mesh's r-th device
        for path, leaf in leaves:
            n = "/".join(str(k.key) for k in path)
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(got[r][n].numpy(), np.asarray(shard.data), err_msg=f"{r} {n}")


def test_uneven_shards_raise_as_jax():
    """A vocabulary of 63 rows over 2 workers: JAX's device_put and the
    port's shard_params both raise ValueError."""
    table = {"tok": {"embedding": jnp.zeros((63, 4), jnp.float32)}}
    mesh = jpar.make_mesh({"model": 2})
    with pytest.raises(ValueError):
        jax.device_put({"params": table}, jpar.tp_shardings({"params": table}, mesh, jpar.bert_tp_rules()))
    with pytest.raises(ValueError, match="not divisible"):
        InProcessGroup(2).run(lambda coll, _: shard_params({"tok/embedding": torch.zeros(63, 4)}, {"model": coll},
                                                            tpar.bert_tp_rules(), scope="params"), [0, 1])


@pytest.mark.parametrize("scope", [None, "params"])
def test_tensor_parallel_bert_matches_jax_and_single_device(scope):
    """At model = 2: each rank's logits against JAX's single-device forward
    (GSPMD computes that function), and each rank's gradients against the
    port's single-device model's, sliced as the rank's shard."""
    kw, flat, toks, want = _tp_setup()
    single = BertEncoder(**kw)
    single.load_flax_params(params_from_flax(flat))
    t = _t(toks).long()
    token_loss(single(t), t).backward()
    full = {n: p.grad for n, p in single.flax_params().items()}
    specs = tpar.tp_shardings(flat, {"model": 2}, tpar.bert_tp_rules(), scope=scope)

    def work(coll, _):
        m = from_params(params_from_flax(flat), coll, shard_vocab=scope == "params")
        logits = m(t)
        backward(token_loss(logits, t))
        return logits.detach(), {n: p.grad for n, p in m.flax_params().items()}

    for r, (logits, grads) in enumerate(InProcessGroup(2).run(work, [0, 1])):
        np.testing.assert_allclose(logits.numpy(), want, atol=2e-4)
        for n, g in grads.items():
            ref = shard(full[n], specs[n], {"model": InProcessGroup(2).member(r)})
            np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=3e-4, rtol=1e-5, err_msg=f"{r} {n}")


@pytest.mark.parametrize("shard_vocab", [False, True])
def test_tensor_parallel_bert_from_a_seed_holds_the_dense_models_shards(shard_vocab):
    """`BertEncoder(model_axis=..., seed=s)` keeps this rank's shards of
    `BertEncoder(seed=s)`'s parameters, and with remat computes the same
    logits and gradients as without."""
    kw = dict(BERT, max_len=16)
    dense = BertEncoder(seed=5, **kw).flax_params()
    specs = tpar.tp_shardings(dense, {"model": 2}, tpar.bert_tp_rules(), scope="params" if shard_vocab else None)
    t = torch.from_numpy(np.random.default_rng(6).integers(0, kw["vocab_size"], size=(2, 16)))

    def work(coll, _):
        out = []
        for remat in (False, True):
            m = BertEncoder(model_axis=coll, shard_vocab=shard_vocab, remat=remat, seed=5, **kw)
            logits = m(t)
            backward(token_loss(logits, t))
            out.append((logits.detach(), {n: p.grad for n, p in m.flax_params().items()}))
        return {n: p.detach() for n, p in m.flax_params().items()}, out

    for r, (params, ((logits, grads), (rlogits, rgrads))) in enumerate(InProcessGroup(2).run(work, [0, 1])):
        for n, p in dense.items():
            assert torch.equal(params[n], shard(p.detach(), specs[n], {"model": InProcessGroup(2).member(r)})), n
        assert torch.equal(rlogits, logits)
        for n, g in grads.items():
            torch.testing.assert_close(rgrads[n], g, rtol=0, atol=1e-6)


def test_tensor_parallel_bert_rejects_what_it_does_not_compute():
    """Tensor parallelism runs the dense attention only, and `shard_vocab`
    needs a model group."""
    with pytest.raises(ValueError, match="runs attention='dense'"):
        BertEncoder(attention="ring", model_axis=Solo(), **BERT)
    with pytest.raises(ValueError, match="model_axis, which is None"):
        BertEncoder(shard_vocab=True, **BERT)


# -- the data x sequence step ------------------------------------------------ #

DP_SP_CFG = dict(compressor="topk", compress_ratio=0.1, memory="none", communicator="allgather", deepreduce="both",
                 index="integer", value="qsgd", policy="p0", min_compress_size=256)


def test_data_seq_step_matches_jax_spmd_body():
    """`__graft_entry__._dryrun_dp_sp`'s spmd body on a (2, 2) (data, seq)
    mesh against `DataSeqStep` on four in-process workers, JAX's QSGD
    uniforms injected: the seq-summed gradients, then (JAX's gradients
    exchanged, so both codecs choose from one gradient) the loss,
    rel_volume, payload bytes and the new parameters; and every worker's
    new parameters bitwise alike."""
    sizes = jpar.factor_devices(4, ("data", "seq"))
    dp, sp = sizes["data"], sizes["seq"]
    chunk, batch = 4, dp
    seq = chunk * sp
    kw = dict(vocab_size=64, hidden=16, layers=1, heads=2, mlp_dim=32, max_len=seq)
    model = JBert(attention="ring", seq_axis="seq", causal=True, **kw)
    local = JBert(attention="ring", seq_axis=None, causal=True, **kw)
    tokens = np.random.default_rng(2).integers(0, 64, size=(batch, seq)).astype(np.int32)
    like = jax.eval_shape(local.init, jax.random.PRNGKey(0), tokens)["params"]
    flat = _seeded(_jax_shapes(like), seed=4)
    params = _unflatten(flat)
    cfg = JConfig(**DP_SP_CFG)
    ex = JExchanger(params, cfg, axis_name="data")
    key = jax.random.PRNGKey(3)

    def spmd(params, tokens):
        def loss_fn(p):
            logits = model.apply({"params": p}, tokens)
            return optax.softmax_cross_entropy_with_integer_labels(logits, tokens).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, "seq"), grads)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "seq"), "data")
        agg, _, wire = ex.exchange(grads, None, step=jnp.zeros((), jnp.int32), key=key)
        new_params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, agg)
        stacked = jax.tree_util.tree_map(lambda g: g[None], grads)
        return new_params, loss, wire.rel_volume()[None], stacked

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(dp, sp), ("data", "seq"))
    fn = jax.jit(shard_map(spmd, mesh=mesh, in_specs=(P(), P("data", "seq")),
                           out_specs=(P(), P(), P(("data", "seq")), P("data")), check_vma=False))
    jnew, jloss, jvol, jgrads = fn(params, tokens)
    jnew, jgrads = _jax_flat_params(jnew), _jax_flat_params(jgrads)
    uniforms = [{n: _jax_uniforms(c, per_tensor_key(jax.random.fold_in(key, w), n, jnp.asarray(0, jnp.int32)))
                 for n, c in ex.codecs.items() if c.val_codec is not None} for w in range(dp)]
    scale = max(float(np.abs(g).max()) for g in jgrads.values())

    def work(m, d, s):
        bert = BertEncoder(attention="ring", seq_axis=m["seq"], causal=True, **kw)
        bert.load_flax_params(params_from_flax(flat))
        step = DataSeqStep(bert, port.DeepReduceConfig(**DP_SP_CFG), data=m["data"], seq=m["seq"], device="cpu")
        inner = step.exchanger.exchange

        def checked(grads, residuals, **kwargs):
            for n, g in grads.items():
                np.testing.assert_allclose(g.numpy(), jgrads[n][d], rtol=1e-4, atol=1e-4 * scale, err_msg=n)
            return inner({n: _t(jgrads[n][d]) for n in grads}, residuals, **kwargs)

        step.exchanger.exchange = checked
        loss, wire = step.step(_t(tokens[d : d + 1, s * chunk : (s + 1) * chunk]).long(), uniforms=uniforms[d])
        return float(loss), float(wire.rel_volume()), step.exchanger.payload_bytes(), {
            n: p.detach().clone() for n, p in step.params.items()}

    coords = [(r // sp, r % sp) for r in range(dp * sp)]
    out = InProcessMesh({"data": dp, "seq": sp}).run(work, [c[0] for c in coords], [c[1] for c in coords])
    assert out[0][2] == ex.payload_bytes(like)
    for r, (loss, vol, _, new) in enumerate(out):
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        np.testing.assert_allclose(vol, float(jvol[r]), rtol=1e-6)  # this worker's
        assert 0 < vol < 1
        for n, p in jnew.items():
            np.testing.assert_allclose(new[n].numpy(), p, rtol=1e-4, atol=1e-6, err_msg=f"{r} {n}")
            assert torch.equal(new[n], out[0][3][n]), (r, n)


def test_phase20_constants_match_jax():
    """chip_smoke phase 20's pinned numbers: the JAX package's payload bytes
    of the ring-layout BERT-base under the data x sequence config (JAX's
    dry-run knobs), equal to the port's; every one of its 200 leaves a QSGD
    segment, so 2 `qsgd_encode_rows` launches a worker-step at 128 segments
    a launch; and the arms' widths BERT-base's published ones."""
    import chip_smoke

    from deepreduce_tpu_torch.ops.qsgd_encode import MAX_SEGMENTS

    jm = JBert(attention="ring", causal=True, **chip_smoke.BERT20)
    assert jm == JBert(attention="ring", causal=True)
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32))["params"]
    assert JExchanger(like, JConfig(**chip_smoke.DP_SP20), num_workers=2).payload_bytes(like) == chip_smoke.PAYLOAD20
    tex = port.GradientExchanger(_jax_shapes(like), port.DeepReduceConfig(**chip_smoke.DP_SP20), device="cpu")
    assert tex.payload_bytes() == chip_smoke.PAYLOAD20
    segments = sum(c.rows_leaf is not None for c in tex.codecs.values())
    assert segments == len(tex.codecs) == 200 and -(-segments // MAX_SEGMENTS) == chip_smoke.ENCODE20
