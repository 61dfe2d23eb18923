"""Port parity for compressed FedAvg (`fedavg.FedAvg`, the round body of
`fedsim.round`, the per-leaf codec bank `fedsim.TreeCodec`) against the JAX
package on the CPU.

Inputs of the bitwise cases are integers x 2**-6, so every QSGD bucket norm
is exact in both packages (the JAX package sums squares in float32, the
port in float64); JAX's QSGD uniforms are injected, drawn under the keys
its round derives: `fold_in(key_s2c, i)` for the broadcast's leaf i and
`fold_in(fold_in(key_c2s, 2 * pos + 1), i)` for client `pos`.

Whole rounds are compared with the jitted JAX `run_round`. Local training
sums in another order than XLA's, so parameters agree to rtol 1e-5 (atol
1e-7; 2.5e-7, two float32 ulps at 1.0, on the MobileNet, whose BatchNorm
scales near 1 make an update the difference of two such numbers); the wire stats and `rel_volume` agree exactly. Before the values,
each round checks that both packages transmitted the same index sets (the
nonzero pattern of the decoded broadcast and of the averaged update). On the
narrow MobileNet the port's local training is held against JAX's (rtol 1e-4,
atol 1e-6 of each leaf's largest magnitude: the conv backward) and JAX's
client outputs are then injected, and each round starts from JAX's state:
QSGD bucket norms differ from JAX's in the last bit where its float32 sum
rounds, and the next round's broadcast, a mean of quantized updates full of
exact magnitude ties, would let that bit decide which tie top-k keeps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from test_fedavg import _problem
from test_torch_slice import _t

import chip_smoke
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.fedavg import FedAvg as JFedAvg
from deepreduce_tpu.fedsim.codec_tree import TreeCodec as JTreeCodec
from deepreduce_tpu.fedsim.round import FedConfig as JFedConfig
from deepreduce_tpu.fedsim.round import cohort_updates as jcohort_updates
from deepreduce_tpu.fedsim.round import make_client_step as jmake_client_step
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.fedsim.round import cohort_updates, make_client_step
from deepreduce_tpu_torch.models import MobileNetV1
from deepreduce_tpu_torch.weights import flatten_flax

# DRQSGD-BF-P0 as the Table-2/5 scripts build it, exact top-k
DRQSGD = dict(
    compressor="topk", compress_ratio=0.1, deepreduce="both", index="bloom", value="qsgd",
    policy="p0", fpr=0.02, bloom_blocked="mod", memory="residual", approx_topk=False,
)
# leaves that cover the codec's paths: compressed, a sparse pair, a flat
# order where SeparableBlock_10 precedes SeparableBlock_2
TREE = {
    "Dense_0/kernel": (64, 10), "Dense_0/bias": (10,),
    "SeparableBlock_10/Conv_0/kernel": (3, 3, 1, 64), "SeparableBlock_2/BatchNorm_0/scale": (600,),
}


def _cfgs(**kw):
    knobs = {**DRQSGD, **kw}
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _nest(flat):
    out = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _to_port(nested):
    return {n: _t(a) for n, a in flatten_flax(jax.device_get(nested)).items()}


def _grid(rng, shape, lo=-64, hi=65):
    return (rng.integers(lo, hi, size=shape) * 2.0**-6).astype(np.float32)


def _tree_uniforms(jtc, nested, key):
    """JAX's QSGD draws of every QSGD leaf of `nested`, keyed by path."""
    spec = jtc.spec(nested)
    out = {}
    for i, (path, shape) in enumerate(zip(spec.paths, spec.shapes)):
        jc = jtc.codec(path, shape)
        if jc.compressed and jc.val_codec is not None:
            meta = jc.val_codec.meta
            out[path] = _t(jax.random.uniform(jax.random.fold_in(key, i), (meta.num_buckets * meta.bucket_size,)))
    return out


def _round_uniforms(jfa, nested_params, key):
    """The draws of one JAX round under `key`: the broadcast's and each
    cohort position's."""
    key_s2c, key_c2s = jax.random.split(key)
    c2s = jfa._tree_codecs["c2s"]
    return {
        "s2c": _tree_uniforms(jfa._tree_codecs["s2c"], nested_params, key_s2c),
        "c2s": [_tree_uniforms(c2s, nested_params, jax.random.fold_in(key_c2s, 2 * c + 1))
                for c in range(jfa.fed.clients_per_round)],
    }


def _assert_wire_equal(jwire, pwire):
    for f in ("index_bits", "value_bits", "dense_bits", "saturated"):
        assert float(np.asarray(getattr(jwire, f))) == float(getattr(pwire, f)), f


# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "kw",
    [dict(num_clients=0, clients_per_round=1), dict(num_clients=4, clients_per_round=0),
     dict(num_clients=4, clients_per_round=5), dict(num_clients=4, clients_per_round=2, local_steps=0),
     dict(num_clients=4, clients_per_round=2, server_lr=0.0)],
)
def test_fed_config_rejections_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JFedConfig(**kw)
    with pytest.raises(ValueError) as perr:
        port.FedConfig(**kw)
    assert str(perr.value) == str(jerr.value)


def test_tree_codec_paths_follow_jax_flatten_order():
    jcfg, pcfg = _cfgs()
    shapes = _mobilenet_shapes()
    nested = _nest({n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()})
    jspec = JTreeCodec("c2s", jcfg).spec(nested)
    pspec = port.TreeCodec("c2s", pcfg, device="cpu").spec({n: torch.empty(s) for n, s in shapes.items()})
    assert pspec.paths == jspec.paths
    assert pspec.shapes == jspec.shapes
    assert pspec.paths.index("['SeparableBlock_10']['Conv_0']['kernel']") < pspec.paths.index(
        "['SeparableBlock_2']['BatchNorm_0']['bias']")
    assert port.TreeCodec("c2s", pcfg, device="cpu").codec(pspec.paths[0], pspec.shapes[0]).name == "c2s/" + jspec.paths[0]
    tc = port.TreeCodec("c2s", pcfg, device="cpu")
    tc.codec("['w']", (3,))
    with pytest.raises(ValueError, match="one static shape"):
        tc.codec("['w']", (4,))


@functools.lru_cache(maxsize=None)
def _jax_compress(jtc, with_residual):
    if with_residual:
        return jax.jit(lambda tree, res, key: jtc.compress_tree(tree, res, 0, key))
    return jax.jit(lambda tree, key: jtc.compress_tree(tree, None, 0, key))


@pytest.mark.parametrize("direction,with_residual,zero", [
    ("s2c", False, True), ("s2c", False, False), ("c2s", True, False), ("c2s", True, True),
])
def test_compress_tree_bitwise(direction, with_residual, zero):
    """Both directions, with and without a residual, and the all-zero tree
    (round 0's broadcast: every top-k magnitude ties, every bucket norm 0)."""
    jcfg, pcfg = _cfgs(min_compress_size=500)
    rng = np.random.default_rng(3)
    flat = {n: np.zeros(s, np.float32) if zero else _grid(rng, s) for n, s in TREE.items()}
    res = {n: _grid(rng, s, -8, 9) for n, s in TREE.items()} if with_residual else None
    jtc = _jax_tree_codec(direction, jcfg)
    key = jax.random.PRNGKey(11)
    nested = _nest(flat)
    if with_residual:
        jdec, jres, jwire = _jax_compress(jtc, True)(nested, _nest(res), key)
    else:
        jdec, jres, jwire = _jax_compress(jtc, False)(nested, key)
    ptc = port.TreeCodec(direction, pcfg, device="cpu")
    pdec, pres, pwire = ptc.compress_tree(
        {n: _t(a) for n, a in flat.items()}, None if res is None else {n: _t(a) for n, a in res.items()},
        step=0, worker=0, uniforms=_tree_uniforms(jtc, nested, key),
    )
    jdec = _to_port(jdec)
    assert list(pdec) == [n for n in sorted(TREE, key=lambda n: n.split("/"))]
    for n in TREE:
        assert torch.equal(pdec[n], jdec[n]), n
    if with_residual:
        jres = _to_port(jres)
        for n in TREE:
            assert torch.equal(pres[n], jres[n]), n
    else:
        assert pres is None and jres is None
    _assert_wire_equal(jwire, pwire)
    if zero and not with_residual:
        assert all(not bool(d.any()) for d in pdec.values())


@functools.lru_cache(maxsize=None)
def _jax_tree_codec(direction, jcfg):
    return JTreeCodec(direction, jcfg)


@pytest.mark.parametrize("masked", [False, True])
def test_cohort_updates_bitwise_given_client_outputs(masked):
    """The cohort sum, residual stack, wire sums and live gates, given the
    same client outputs (the client's `local_train` returns its batch). With
    the mask, client 1 churns and its update holds a NaN: the select keeps
    it out of the sum, its residual stays, its wire bits are zero."""
    C, step = 3, 2
    jcfg, pcfg = _cfgs(min_compress_size=500)
    rng = np.random.default_rng(9)
    w_ref = {n: _grid(rng, s) for n, s in TREE.items()}
    p_end = {n: np.stack([_grid(rng, s) for _ in range(C)]) for n, s in TREE.items()}
    res = {n: np.stack([_grid(rng, s, -8, 9) for _ in range(C)]) for n, s in TREE.items()}
    part = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    if masked:
        p_end["Dense_0/kernel"][1, 3, 4] = np.nan
    jtc = _jax_tree_codec("c2s", jcfg)
    key_c2s = jax.random.PRNGKey(21)

    def jrun(batches, res_stack, w):
        client_step = jmake_client_step(jtc, lambda w_, b, k: b, w, jnp.int32(step), key_c2s)
        return jcohort_updates(client_step, batches, res_stack, jnp.arange(C, dtype=jnp.uint32),
                               update_template=w, participation=None if part is None else jnp.asarray(part))

    jsum, jres, jwire, jlive = jax.jit(jrun)(_nest(p_end), _nest(res), _nest(w_ref))
    uniforms = [_tree_uniforms(jtc, _nest(w_ref), jax.random.fold_in(key_c2s, 2 * c + 1)) for c in range(C)]
    ptc = port.TreeCodec("c2s", pcfg, device="cpu")
    tw = {n: _t(a) for n, a in w_ref.items()}
    client_step = make_client_step(ptc, lambda w_, b: b, tw, step, uniforms=uniforms)
    psum, pres, pwire, plive = cohort_updates(
        client_step, {n: _t(a) for n, a in p_end.items()}, {n: _t(a) for n, a in res.items()}, range(C),
        update_template=tw, participation=None if part is None else _t(part),
    )
    jsum, jres = _to_port(jsum), _to_port(jres)
    for n in TREE:
        assert bool(torch.isfinite(psum[n]).all()), n
        assert torch.equal(psum[n], jsum[n]), n
        assert torch.equal(pres[n], jres[n]), n
    if masked:
        assert torch.equal(pres["Dense_0/kernel"][1], _t(res["Dense_0/kernel"][1]))
    for jw, pw in zip(jwire, pwire):
        assert float(np.asarray(jw)) == float(pw)
    assert torch.equal(plive, _t(jlive))


# --------------------------------------------------------------------------- #
# whole rounds


def _transmitted(a, b):
    """The positions where a round moved a tree."""
    return {n: (a[n] != b[n]) for n in a}


def _assert_same_sets(jmoved, pmoved, what):
    for n in pmoved:
        assert torch.equal(pmoved[n], jmoved[n]), f"{what}: the packages transmitted other index sets at {n}"


def _assert_state_close(jstate, pstate, rtol, atol_of):
    for field in ("params", "w_ref"):
        jt = _to_port(getattr(jstate, field))
        for n, t in getattr(pstate, field).items():
            torch.testing.assert_close(t, jt[n], rtol=rtol, atol=atol_of(jt[n]), msg=lambda m, n=n, field=field: f"{field} {n}: {m}")
    if pstate.c2s_residuals is not None:
        jres = _to_port(jstate.c2s_residuals)
        for n, t in pstate.c2s_residuals.items():
            torch.testing.assert_close(t, jres[n], rtol=rtol, atol=atol_of(jres[n]), msg=lambda m, n=n: f"residual {n}: {m}")


def _run_both(jfa, pfa, jparams, batches_of, rounds, key_of, rtol, atol_of, participation=None, carry=False):
    """`rounds` rounds in both packages, compared after each. With `carry`
    each port round starts from JAX's state, so that it holds the round and
    not the drift of the one before."""
    jstate = jfa.init(jparams)
    pstate = pfa.init(_to_port(jparams))
    run_round = jax.jit(jfa.run_round)
    for r in range(rounds):
        if carry:
            pstate = port.FedAvgState(
                params=_to_port(jstate.params), w_ref=_to_port(jstate.w_ref),
                c2s_residuals=None if jstate.c2s_residuals is None else _to_port(jstate.c2s_residuals),
                round=int(jstate.round),
            )
        key = key_of(r)
        ids = jfa.sample_clients(jstate, key)
        jbatch, pbatch = batches_of(np.asarray(ids), r)
        round_key = jax.random.fold_in(key, 1)
        part = participation[r] if participation is not None else None
        before = (_to_port(jstate.w_ref), _to_port(jstate.params))
        jstate, jout = run_round(jstate, ids, jbatch, round_key,
                                 participation=None if part is None else jnp.asarray(part))
        pstate, pout = pfa.run_round(pstate, torch.tensor(np.asarray(ids)), pbatch,
                                     participation=None if part is None else _t(part),
                                     uniforms=_round_uniforms(jfa, jparams, round_key))
        # the same index sets first: the broadcast's and the averaged update's
        jw, jp = _to_port(jstate.w_ref), _to_port(jstate.params)
        _assert_same_sets(_transmitted(jw, before[0]), _transmitted(pstate.w_ref, before[0]), f"round {r} S2C")
        _assert_same_sets(_transmitted(jp, jw), _transmitted(pstate.params, pstate.w_ref), f"round {r} C2S")
        assert pstate.round == int(jstate.round) == r + 1
        assert float(pout["rel_volume"]) == float(jout["rel_volume"])
        _assert_wire_equal(jout["wire"], pout["wire"])
        _assert_state_close(jstate, pstate, rtol, atol_of)
    return jstate, pstate


@pytest.mark.parametrize("participation", [None, [None, [1.0, 0.0, 1.0]]], ids=["all", "churn"])
def test_two_rounds_on_the_mlp_problem(participation):
    """tests/test_fedavg.py's linear federation, 6 clients, 3 a round, 2
    local steps of SGD, DRQSGD-BF-P0 both ways; the second case drops client
    1 of round 2 (mean by the live count)."""
    _, batches_for, loss_fn, params = _problem(num_clients=6, local_steps=2)
    jcfg, pcfg = _cfgs(compress_ratio=0.25, fpr=0.05, min_compress_size=16)
    fed = dict(num_clients=6, clients_per_round=3, local_steps=2)
    jfa = JFedAvg(loss_fn, jcfg, JFedConfig(**fed), optax.sgd(0.05))

    def ploss(p, b):
        x, y = b
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

    pfa = port.FedAvg(ploss, pcfg, port.FedConfig(**fed), 0.05, device="cpu")

    def batches_of(ids, r):
        xs, ys = batches_for(ids, round_seed=r)
        return (xs, ys), (_t(xs), _t(ys))

    part = None if participation is None else [None if p is None else np.asarray(p, np.float32)
                                               for p in participation]
    _run_both(jfa, pfa, params, batches_of, 2, lambda r: jax.random.PRNGKey(100 + r),
              rtol=1e-5, atol_of=lambda ref: 1e-7, participation=part)


NARROW = dict(num_classes=10, width_mult=0.25, blocks=((64, 1), (128, 2), (128, 1)))


@functools.lru_cache(maxsize=None)
def _narrow_mobilenet():
    model = JMobileNetV1(**NARROW)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3), jnp.float32), train=True)
    return model, variables["params"], variables["batch_stats"]


def test_two_rounds_on_a_narrow_mobilenet():
    """MobileNetV1 at 3 blocks, width 0.25, 16x16 inputs (a stride-2 block,
    depthwise convs, BatchNorm in batch mode with its statistics dropped):
    4 clients, 2 a round, 2 local steps of SGD 0.2 momentum 0.9."""
    jmodel, jparams, bn_stats = _narrow_mobilenet()

    def jloss(p, b):
        logits, _ = jmodel.apply({"params": p, "batch_stats": bn_stats}, b[0], train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean()

    pmodel = MobileNetV1(**NARROW)

    def ploss(p, b):
        return F.cross_entropy(pmodel.functional(p, b[0]), b[1].long())

    jcfg, pcfg = _cfgs(min_compress_size=100)
    fed = dict(num_clients=4, clients_per_round=2, local_steps=2)
    jfa = JFedAvg(jloss, jcfg, JFedConfig(**fed), optax.sgd(0.2, momentum=0.9))
    pfa = port.FedAvg(ploss, pcfg, port.FedConfig(**fed), 0.2, 0.9, device="cpu")
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 2, 2, 6, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 2, 2, 6)).astype(np.int32)

    def batches_of(ids, r):
        return (images[r], labels[r]), (_t(images[r]), _t(labels[r]))

    # the port's local training against JAX's, then JAX's output injected
    jlocal = jax.jit(lambda w, b: jfa._local_train(w, b, jax.random.PRNGKey(0)))
    own_local = pfa._local_train
    checked = []

    def local_train(w_ref, batch):
        mine = own_local(w_ref, batch)
        theirs = _to_port(jlocal(_nest({n: t.numpy() for n, t in w_ref.items()}), (batch[0].numpy(), batch[1].numpy())))
        for n, t in mine.items():
            scale = float(theirs[n].abs().max())
            torch.testing.assert_close(t, theirs[n], rtol=1e-4, atol=1e-6 * scale, msg=lambda m, n=n: f"local train {n}: {m}")
        checked.append(len(mine))
        return theirs

    pfa._local_train = local_train
    _run_both(jfa, pfa, jparams, batches_of, 2, lambda r: jax.random.PRNGKey(200 + r),
              rtol=1e-5, atol_of=lambda ref: 2.5e-7, carry=True)
    assert checked == [len(pmodel.flax_params())] * 4


# --------------------------------------------------------------------------- #
# the full-width wire constants chip_smoke holds its FedAvg arms to


def _shapes_of(abstract_params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract_params)
    return {"/".join(k.key for k in path): tuple(leaf.shape) for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def _mobilenet_shapes(width=1.0):
    model = JMobileNetV1(num_classes=10, width_mult=width)
    return _shapes_of(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=True))["params"])


def _lstm_shapes():
    model = JWordLSTM()
    return _shapes_of(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 20), jnp.int32)))["params"])


def _wire_bounds(cfg, shapes):
    """From the JAX package's codec geometry: (index bits, dense bits) of one
    tree as float32 sums in flatten order, and the least and most value bits
    (a p0 bloom sends nsel in [k, budget] values: every top-k index is
    positive, and the budget caps the positives)."""
    jtc = JTreeCodec("c2s", cfg)
    spec = jtc.spec(_nest({n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}))
    idx = dense = np.float32(0)
    lo = hi = 0.0
    for path, shape in zip(spec.paths, spec.shapes):
        jc = jtc.codec(path, shape)
        dense = np.float32(dense + np.float32(jc.d * 32))
        if jc.dense_fallback:
            lo += jc.d * 32
            hi += jc.d * 32
        elif not jc.compressed:
            idx = np.float32(idx + np.float32(jc.k * 32))
            lo += jc.k * 32
            hi += jc.k * 32
        else:
            meta = jc.idx_codec.meta
            idx = np.float32(idx + np.float32(64.0 + meta.m_bits))
            vm = jc.val_codec.meta
            bits = lambda n: n * vm.level_bits + -(-n // vm.bucket_size) * 32
            lo += bits(jc.k)
            hi += bits(meta.budget)
    return float(idx), float(dense), lo, hi


def test_full_width_wire_constants_match_jax_geometry():
    """chip_smoke's FEDAVG table: each arm's per-client index and dense bits
    (float32 sums in JAX's leaf order) and the value-bit bounds, from the JAX
    package's codecs at the full shapes (MobileNetV1 width 1.0 on 32x32x3,
    the WordLSTM at vocab 10,004 / embed 96 / LSTM 670)."""
    shapes = {"mobilenet": _mobilenet_shapes(), "wordlstm": _lstm_shapes()}
    assert sum(int(np.prod(s)) for s in shapes["mobilenet"].values()) == 3_217_226
    assert sum(int(np.prod(s)) for s in shapes["wordlstm"].values()) == 4_050_748
    for arm, spec in chip_smoke.FEDAVG.items():
        jcfg = JConfig(**spec["knobs"])
        assert chip_smoke.FEDAVG_WIRE[arm] == _wire_bounds(jcfg, shapes[spec["model"]]), arm
        # the port's codecs agree with the geometry
        pcfg = port.DeepReduceConfig(**spec["knobs"])
        ptc = port.TreeCodec("c2s", pcfg, device="cpu")
        pspec = ptc.spec({n: torch.empty(s, device="meta") for n, s in shapes[spec["model"]].items()})
        for path, shape in zip(pspec.paths, pspec.shapes):
            jc, pc = JTensorCodec(shape, jcfg, name="c2s/" + path), ptc.codec(path, shape)
            assert (pc.compressed, pc.dense_fallback, pc.k) == (jc.compressed, jc.dense_fallback, jc.k), path
            if pc.compressed:
                assert (pc.idx_codec.meta.m_bits, pc.idx_codec.meta.budget) == (jc.idx_codec.meta.m_bits,
                                                                               jc.idx_codec.meta.budget), path
