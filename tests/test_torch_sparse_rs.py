"""Port parity for the sparse_rs reduce-scatter routes (sparse, adaptive,
quantized, oktopk) against the JAX package on the CPU mesh, at W in
{1, 2, 4} through the port's in-process group of lockstep workers, and two
training steps per in-collective route (qar included) against the JAX
Trainer.

Inputs sit on the grid 2**-6 with few distinct magnitudes, so top-k and the
phase-2 re-selection meet many ties, and every norm, sum and dequantized
value is exact in float32 in both packages: given the uniforms JAX draws
where a route quantizes, the mean, the own-transmitted tensor, the wire
stats and the observables are bitwise equal."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_qar import QAR
from test_torch_slice import _jax_flat_params, _t, jax_trainer_state

from deepreduce_tpu import costmodel as jcostmodel
from deepreduce_tpu import sparse as jsparse
from deepreduce_tpu import sparse_rs as jsparse_rs
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.train import classification_loss as jclassification_loss
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import costmodel, qar, sparse, sparse_rs
from deepreduce_tpu_torch.collectives import Solo
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.train import classification_loss
from deepreduce_tpu_torch.weights import params_from_jax

RS = dict(communicator="sparse_rs", compressor="topk", compress_ratio=0.1, memory="residual", deepreduce=None)
D, RATIO, BLOCK = 5003, 0.1, 256
COLLECT = {
    "adaptive": ("rs_density", "rs_dense_switches"),
    "oktopk": ("rs_oktopk_survivors", "rs_oktopk_threshold", "rs_oktopk_spills"),
}
QUANTIZING = ("adaptive", "quantized")


def _grid(rng, d=D, span=40, zeros=0.4):
    """f32[d]: integers in [-span, span] times 2**-6, a share of them zero."""
    g = (rng.integers(-span, span + 1, size=d) * 2.0**-6).astype(np.float32)
    g[rng.random(d) < zeros] = 0.0
    return g


def _uniform_len(mode, d, W, block=BLOCK):
    sp = sparse_rs.padded_shard(d, W, block)
    return sp if mode == "adaptive" else sp * W


def _jax_uniforms(mode, key, W, d=D, block=BLOCK):
    """What each worker's `qar.bucket_quantize` draws in JAX's route."""
    if mode not in QUANTIZING:
        return [None] * W
    n = _uniform_len(mode, d, W, block)
    return [_t(jax.random.uniform(jax.random.fold_in(key, w), (n,))) for w in range(W)]


def _jax_route(flat_w, mode, key, **kw):
    """JAX's `sparse_rs.exchange` on a W-device mesh: per worker (mean, own,
    index bits, value bits, dense bits, *observables)."""
    W = len(flat_w)
    names = COLLECT.get(mode, ())

    def spmd(g):
        collect = {}
        mean, own, st = jsparse_rs.exchange(g[0], "data", W, ratio=RATIO, rs_mode=mode, collect=collect,
                                            key=key if mode in QUANTIZING else None, **kw)
        outs = (mean, own, st.index_bits, st.value_bits, st.dense_bits) + tuple(collect[n] for n in names)
        return tuple(o[None] for o in outs)

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"),),
                   out_specs=tuple(P("data") for _ in range(5 + len(names))), check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(jnp.asarray(np.stack(flat_w)))]


def _port_route(flat_w, mode, uniforms_w, **kw):
    """The port's `sparse_rs.exchange` on W in-process workers: per worker
    the same tuple as `_jax_route`."""
    W = len(flat_w)

    def work(coll, flat, u):
        collect = {}
        mean, own, st = sparse_rs.exchange(_t(flat), coll, ratio=RATIO, rs_mode=mode, stream=(5, 0), uniforms=u,
                                           collect=collect, **kw)
        outs = (mean, own, st.index_bits, st.value_bits, st.dense_bits)
        outs += tuple(collect[n] for n in COLLECT.get(mode, ()))
        return [o.numpy() for o in outs]

    return port.InProcessGroup(W).run(work, flat_w, uniforms_w)


def _assert_same(tout, jout, mode, W):
    fields = ["mean", "own", "index_bits", "value_bits", "dense_bits", *COLLECT.get(mode, ())]
    for w in range(W):
        for f, t, j in zip(fields, tout[w], jout):
            np.testing.assert_array_equal(t, j[w], err_msg=f"{mode} W={W} worker {w} {f}")


CASES = [("sparse", {}), ("adaptive", {}), ("adaptive", dict(density_threshold=0.0)), ("quantized", {}),
         ("oktopk", {})]


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("mode,kw", CASES, ids=["sparse", "adaptive_sparse", "adaptive_dense", "quantized", "oktopk"])
def test_route_bitwise_matches_jax_mesh(mode, kw, W):
    rng = np.random.default_rng(W)
    flat_w = [_grid(rng) for _ in range(W)]
    key = jax.random.PRNGKey(21)
    jout = _jax_route(flat_w, mode, key, block_size=BLOCK, **kw)
    tout = _port_route(flat_w, mode, _jax_uniforms(mode, key, W), block_size=BLOCK, **kw)
    _assert_same(tout, jout, mode, W)
    mean, own = tout[0][0], tout[0][1]
    assert np.count_nonzero(mean) > 0 and np.count_nonzero(own) > 0
    if mode == "adaptive":
        assert float(tout[0][6]) == (1.0 if kw else 0.0)  # the branch under test was taken
    if mode == "quantized":
        # the route really quantized: some mean value is off the input grid
        assert np.any(mean * 64 * W != np.round(mean * 64 * W))


def test_topk_unsorted_order_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    g = (rng.integers(-3, 4, size=1000) * 0.5).astype(np.float32)  # 7 values, thousands of ties
    g[:10] = 0.0
    for ratio in (0.01, 0.3, 0.95):
        for sort_indices in (False, True):
            j = jsparse.topk(jnp.asarray(g), ratio, sort_indices=sort_indices)
            t = sparse.topk(_t(g), ratio, sort_indices=sort_indices)
            np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
            np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    order = sparse.topk(_t(g), 0.95, sort_indices=False).indices.numpy()
    mags = np.abs(g[order])
    assert np.all(mags[:-1] >= mags[1:])
    tie = mags[:-1] == mags[1:]
    assert tie.sum() > 800 and np.all(order[:-1][tie] < order[1:][tie])  # lower index first


def test_phase1_overflow_drops_smallest_magnitude():
    """One crowded shard with the largest magnitudes at the highest indices:
    what goes out is the budget's worth of largest magnitudes, as in the
    JAX package (tests/test_sparse_rs.py), bitwise."""
    W, d, ratio = 4, 4096, 0.05
    k = sparse.num_slots(d, ratio)
    g = np.zeros(d, np.float32)
    g[:k] = np.arange(1, k + 1, dtype=np.float32)
    flat_w = [g] * W
    headroom = 1.0 / W
    jmean, jown = jax.jit(shard_map(
        lambda x: tuple(o[None] for o in jsparse_rs.exchange(x[0], "data", W, ratio=ratio, headroom=headroom)[:2]),
        mesh=shared_mesh(W), in_specs=(P("data"),), out_specs=(P("data"), P("data")), check_vma=False,
    ))(jnp.asarray(np.stack(flat_w)))

    def work(coll, flat):
        return sparse_rs.exchange(_t(flat), coll, ratio=ratio, headroom=headroom)[:2]

    out = port.InProcessGroup(W).run(work, flat_w)
    B = sparse_rs.send_budget(d, ratio, W, headroom)
    for w, (mean, own) in enumerate(out):
        np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean)[w])
        np.testing.assert_array_equal(own.numpy(), np.asarray(jown)[w])
        np.testing.assert_array_equal(np.nonzero(own.numpy())[0], np.arange(k - B, k))


@pytest.mark.parametrize("case", ["all_equal", "zero"])
def test_oktopk_degenerate_gradients_match_jax(case):
    """Every candidate tied in one histogram bucket (capacity does the
    triage), and an all-zero gradient (nothing survives, every observable
    reads 0), as in the JAX package's tests/test_oktopk.py; bitwise."""
    W, d, ratio = 4, 4096, 0.02
    k = sparse.num_slots(d, ratio)
    g = np.zeros(d, np.float32)
    if case == "all_equal":
        g[:k] = 2.5
    flat_w = [g] * W
    names = COLLECT["oktopk"]

    def spmd(x):
        collect = {}
        mean, own, _ = jsparse_rs.exchange(x[0], "data", W, ratio=ratio, rs_mode="oktopk", collect=collect)
        return tuple(o[None] for o in (mean, own) + tuple(collect[n] for n in names))

    jout = [np.asarray(o) for o in jax.jit(shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"),),
                                                     out_specs=(P("data"),) * 5, check_vma=False))(
        jnp.asarray(np.stack(flat_w)))]

    def work(coll, flat):
        collect = {}
        mean, own, _ = sparse_rs.exchange(_t(flat), coll, ratio=ratio, rs_mode="oktopk", collect=collect)
        return [o.numpy() for o in (mean, own) + tuple(collect[n] for n in names)]

    tout = port.InProcessGroup(W).run(work, flat_w)
    for w in range(W):
        for f, t, j in zip(("mean", "own") + names, tout[w], jout):
            np.testing.assert_array_equal(t, j[w], err_msg=f"{case} worker {w} {f}")
    survivors, threshold, spills = tout[0][2:]
    if case == "zero":
        assert survivors == threshold == spills == 0.0 and not np.any(tout[0][0])
    else:
        kept = np.count_nonzero(tout[0][1])
        assert survivors == W * k and threshold > 0 and kept <= sparse_rs.oktopk_send_budget(d, ratio, W)
        assert spills == k - kept


def _shapes_of(which):
    if which == "small":
        return {"a/kernel": (40, 100), "b": (1003,)}
    return {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}


WORDLSTM_BYTES = {  # the JAX package's payload_bytes at W = 1, 4, 8
    "sparse": [9_721_776, 7_291_336, 6_886_296], "adaptive": [10_595_428, 7_509_748, 6_995_500],
    "quantized": [7_354_832, 4_924_392, 4_519_320], "oktopk": [9_738_160, 2_446_856, 1_231_640],
    "sketch": [6_481_192, 4_050_752, 3_645_680],
}


@pytest.mark.parametrize("which", ["small", "wordlstm"])
def test_payload_bytes_match_jax_costmodel(which):
    shapes = _shapes_of(which)
    d = sum(math.prod(s) for s in shapes.values())
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    for mode in sparse_rs.RS_MODES:
        got = []
        for W in (1, 4, 8):
            coll = None if W == 1 else port.InProcessGroup(W).member(0)
            ex = port.GradientExchanger(shapes, port.DeepReduceConfig(**RS, rs_mode=mode), device="cpu", group=coll)
            want = jcostmodel.rs_payload_bytes(mode, d, W, RATIO)
            assert costmodel.rs_payload_bytes(mode, d, W, RATIO) == want
            assert costmodel.rs_wire_bytes(mode, d, W, RATIO) == jcostmodel.rs_wire_bytes(mode, d, W, RATIO)
            assert ex.payload_bytes() == int(want) == JExchanger(
                like, JConfig(**RS, rs_mode=mode), num_workers=W).payload_bytes(like)
            got.append(ex.payload_bytes())
        if which == "wordlstm":
            assert d == 4_050_748 and got == WORDLSTM_BYTES[mode]
    for W, B in ((1, 1), (3, 7), (8, 100)):
        assert sparse_rs.shard_size(D, W) == jsparse_rs.shard_size(D, W)
        assert sparse_rs.padded_shard(D, W, B * 4) == jsparse_rs.padded_shard(D, W, B * 4)
        assert sparse_rs.oktopk_send_budget(D, RATIO, W, 0.5) == jsparse_rs.oktopk_send_budget(D, RATIO, W, 0.5)
        assert sparse_rs.adaptive_lanes(D, RATIO, W, 2.0, 16) == jsparse_rs.adaptive_lanes(D, RATIO, W, 2.0, 16)
        assert sparse_rs.quantized_levels_budget(W) == jsparse_rs.quantized_levels_budget(W)
    assert [sparse_rs.oktopk_shift(b) for b in (64, 4096, 1 << 24)] == [jsparse_rs.oktopk_shift(b) for b in
                                                                         (64, 4096, 1 << 24)]


def test_config_fences_match_jax():
    # the same fence codes as the JAX package, at config time (JAX raises the
    # codec-stack fences when the exchanger is built)
    for knobs, code in [
        (dict(rs_mode="adaptive"), "rs-mode-needs-sparse-rs"),
        (dict(RS, deepreduce="both", index="bloom", value="qsgd"), "build-sparse-rs-codec-stack"),
        (dict(RS, compressor="topk_sampled"), "build-sparse-rs-codec-stack"),
    ]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**knobs)
        assert e.value.knob == code
        with pytest.raises(JConfigError) as je:
            JExchanger({"w": jnp.zeros((D,))}, JConfig(**knobs), num_workers=2)
        assert je.value.reason_code == code
    # ranges: the JAX package rejects the same values
    for knob, val in [("rs_block_size", 6), ("rs_block_size", 0), ("rs_density_threshold", 1.5),
                      ("rs_oktopk_bins", 1000), ("rs_oktopk_bins", 32), ("rs_oktopk_cap_headroom", 0.0)]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**RS, **{knob: val})
        assert e.value.knob == knob
        with pytest.raises(JConfigError):
            JConfig(**RS, **{knob: val})
    # the sketch route and the cost model's pick are knobs of both packages;
    # 'auto' is resolved by the exchanger, so the route function refuses it
    for mode in ("sketch", "auto"):
        assert JConfig(**RS, rs_mode=mode).rs_mode == mode == port.DeepReduceConfig(**RS, rs_mode=mode).rs_mode
    with pytest.raises(ValueError, match="auto"):
        sparse_rs.exchange(torch.zeros(8), Solo(), ratio=0.5, rs_mode="auto")
    for knob, val in (("rs_sketch_rows", 0), ("rs_sketch_cols", -1)):
        assert port.from_params({**RS, knob: 5}) == port.DeepReduceConfig(**RS, **{knob: 5})
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**RS, **{knob: val})
        with pytest.raises(JConfigError) as je:
            JConfig(**RS, **{knob: val})
        assert e.value.reason_code == je.value.reason_code == knob.replace("_", "-") + "-range"
    defaults = port.DeepReduceConfig(**RS)
    for knob in ("rs_headroom", "rs_out_headroom", "rs_mode", "rs_block_size", "rs_density_threshold",
                 "rs_sketch_rows", "rs_sketch_cols", "rs_oktopk_bins", "rs_oktopk_cap_headroom"):
        assert getattr(defaults, knob) == getattr(JConfig(), knob), knob
    with pytest.raises(ValueError, match="stream"):
        sparse_rs.exchange(torch.zeros(BLOCK), Solo(), ratio=0.5, rs_mode="quantized")


# -- two training steps on a small WordLSTM ---------------------------------- #

ROUTES = {
    "qar": QAR,
    "rs_sparse": dict(RS, rs_mode="sparse"),
    # the dense phase-2 branch at W = 1 (density 0.1 > 0.05), as chip_smoke runs it
    "rs_adaptive": dict(RS, rs_mode="adaptive", rs_density_threshold=0.05),
    "rs_quantized": dict(RS, rs_mode="quantized"),
    "rs_oktopk": dict(RS, rs_mode="oktopk"),
}
VOCAB, EMBED, HIDDEN, BATCH, SEQ, LR, MOMENTUM = 64, 8, 16, 4, 5, 0.1, 0.9


def _trainer_uniforms(route, key, step, d):
    """JAX's draws at one worker (W = 1) of one Trainer step, by the port's
    stream names."""
    skey = jax.random.fold_in(key, jnp.uint32(step))
    if route == "qar":
        n = qar.pad_len(d, 1, 512)
        k1 = jax.random.fold_in(skey, 0)
        k2 = jax.random.fold_in(k1, jnp.uint32(0x5EED))
        return {qar.STREAM_PHASE1: _t(jax.random.uniform(k1, (n,))),
                qar.STREAM_PHASE2: _t(jax.random.uniform(k2, (n,)))}
    mode = ROUTES[route]["rs_mode"]
    if mode not in QUANTIZING:
        return None
    name = sparse_rs.STREAM_ADAPTIVE if mode == "adaptive" else sparse_rs.STREAM_QUANTIZED
    return {name: _t(jax.random.uniform(jax.random.fold_in(skey, 0), (_uniform_len(mode, d, 1),)))}


_jax_grad = jax.jit(jax.grad(lambda p, b: jclassification_loss(JWordLSTM(VOCAB, EMBED, HIDDEN))(p, {}, b)[0]))


def _check_same_choices(trainer, tstate, jstate, batch, uniforms, step):
    """The route's discrete choices (the top-k set, the phase-2 re-select,
    the oktopk bucket, every stochastic level) must not hinge on rounding,
    or the comparison after the step fails obscurely or passes by luck.
    Both packages' compensated gradients (JAX's gradient at its state plus
    its residual; the port's from a probe copy of its model) go through the
    port's route with the same draws: the outputs must have the same
    support and differ no more than the gradients do (rtol 1e-4), where a
    flipped choice moves a whole value or a whole quantization step."""
    x, y = batch
    jgrads = _jax_flat_params(_jax_grad(jstate.params, (jnp.asarray(x), jnp.asarray(y))))
    probe = copy.deepcopy(trainer.model)
    classification_loss(probe)((_t(x).long(), _t(y).long())).backward()
    ex = trainer.exchanger
    tflat = ex._flatten({n: p.grad for n, p in probe.flax_params().items()})
    jflat = torch.cat([_t(jgrads[n]).reshape(-1) for n in ex.names])
    if tstate.residuals is not None:
        jres = _jax_flat_params(jstate.residuals)
        tflat = tflat + ex._flatten(tstate.residuals)
        jflat = jflat + torch.cat([_t(jres[n][0]).reshape(-1) for n in ex.names])
    apart = float((tflat - jflat).abs().max())
    routed = [ex.route_flat(flat, step=0, uniforms=uniforms)[:2] for flat in (tflat, jflat)]
    for what, t, j in zip(("mean", "own"), *routed):
        if t is None:
            continue
        where = f"step {step}, the {what}, where the packages' compensated gradients differ by up to {apart:.3g}"
        hint = ": torch and XLA rounding decide differently here; choose other batches"
        assert torch.equal(t != 0, j != 0), f"{where}: a selection differs{hint}"
        gap = float(((t - j).abs() - 1e-4 * j.abs()).max())
        assert gap <= 1e-6 * float(j.abs().max()), f"{where}: a level or value jumps by {gap:.3g}{hint}"


@pytest.mark.parametrize("route", list(ROUTES))
def test_two_step_wordlstm_trainer_matches_jax(route):
    knobs = dict(ROUTES[route], seed=3)
    jcfg, tcfg = JConfig(**knobs), port.DeepReduceConfig(**knobs)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, VOCAB, size=(2, BATCH, SEQ + 1)).astype(np.int32)
    batches = [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(2)]
    jtr = JTrainer(JWordLSTM(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN), jcfg,
                   optax.sgd(LR, momentum=MOMENTUM), shared_mesh(1))
    jstate = jax_trainer_state(jtr, jax.random.PRNGKey(0), batches[0], shared_mesh(1))
    tmodel = WordLSTM(VOCAB, EMBED, HIDDEN)
    tmodel.load_flax_params(params_from_jax(_jax_flat_params(jstate.params)))
    ttr = port.Trainer(tmodel, tcfg, lr=LR, momentum=MOMENTUM, device="cpu")
    tstate = ttr.init_state()
    assert (tstate.residuals is None) == (route == "qar")
    d = ttr.exchanger.d
    for i, (x, y) in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        uniforms = _trainer_uniforms(route, key, i, d)
        _check_same_choices(ttr, tstate, jstate, (x, y), uniforms, i)
        jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
        collect = {}
        tstate, tloss, twire = ttr.step(tstate, (_t(x).long(), _t(y).long()), uniforms=uniforms, collect=collect)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-5)
        if route == "rs_adaptive":
            assert float(collect["rs_dense_switches"]) == 1.0
    assert tstate.step == 2
    jflat = _jax_flat_params(jstate.params)
    # the gradients agree to float32 rounding of the LSTM backward; every
    # choice is the same (checked above), so the steps agree to rtol 1e-5
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    if tstate.residuals is not None:
        jres = _jax_flat_params(jstate.residuals)
        for n, r in tstate.residuals.items():
            np.testing.assert_allclose(r.numpy(), jres[n][0], rtol=1e-4, atol=1e-6, err_msg=n)
