"""Port parity for the slice as a whole: the 'both' TensorCodec, the fused
4-worker exchange and a 2-step WordLSTM training run against the JAX
package on the CPU mesh, plus the port's packaging rules (no jax import,
no silent CPU fallback, loud config rejections).

Stochastic stages are held bitwise by injecting the uniforms JAX draws
(`jax.random.uniform` under the exchanger's own per-tensor keys) into the
port's QSGD. Float reductions that differ in order (the LSTM backward) are
compared at rtol 1e-5."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P

from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.comm import _leaf_name
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.lstm import WordLSTM as JWordLSTM
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.utils.compat import shard_map
from deepreduce_tpu.wrappers import TensorCodec as JTensorCodec
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch.models import WordLSTM
from deepreduce_tpu_torch.ops import qsgd_encode_rows, quantize_levels
from deepreduce_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = dict(
    compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both",
    index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod",
    approx_topk=False,
)


def _cfgs(**kw):
    knobs = {**FLAGSHIP, **kw}
    return JConfig(**knobs), port.DeepReduceConfig(**knobs)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_uniforms(codec, key):
    meta = codec.val_codec.meta
    return _t(jax.random.uniform(key, (meta.num_buckets * meta.bucket_size,)))


@pytest.mark.parametrize(
    "deepreduce,ratio,path",
    [("both", 0.1, "compressed"), (None, 0.1, "sparse"), (None, 0.5, "dense_fallback")],
)
def test_tensor_codec_round_trip_matches_jax(deepreduce, ratio, path):
    shape = (64, 50)
    rng = np.random.default_rng(0)
    g = rng.normal(size=shape).astype(np.float32)
    g[rng.random(shape) < 0.4] = 0.0
    jcfg, tcfg = _cfgs(deepreduce=deepreduce, compress_ratio=ratio)
    jc = JTensorCodec(shape, jcfg, name="w")
    tc = port.TensorCodec(shape, tcfg, name="w", device="cpu")
    assert (tc.compressed, tc.dense_fallback) == (path == "compressed", path == "dense_fallback")
    assert (tc.compressed, tc.dense_fallback, tc.k) == (jc.compressed, jc.dense_fallback, jc.k)
    key = jax.random.PRNGKey(5)
    jpay = jc.encode(jnp.asarray(g), step=0, key=key)
    tpay = tc.encode(_t(g), uniforms=_jax_uniforms(jc, key) if tc.compressed else None)
    jleaves = jax.tree_util.tree_leaves(jpay)
    tleaves = tpay.leaves()
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        np.testing.assert_array_equal(tl.numpy().view(np.asarray(jl).dtype), np.asarray(jl))
    np.testing.assert_array_equal(tc.decode(tpay).numpy(), np.asarray(jc.decode(jpay)))
    js, ts = jc.wire_stats(jpay), tc.wire_stats(tpay)
    assert float(ts.rel_volume()) == float(js.rel_volume())
    assert float(ts.saturated) == float(js.saturated)


def _grad_tree(rng, shapes):
    out = {}
    for name, shape in shapes.items():
        g = rng.normal(size=shape).astype(np.float32)
        g[rng.random(shape) < 0.3] = 0.0
        out[name] = g
    return out


def _assert_same_wire(tex, tbuf, jbuf):
    """The port's fused buffer against the JAX package's: every byte equal
    except the QSGD bucket norms, a float32 reduction whose summation order
    differs (the port accumulates in float64). Norms agree to rtol 1e-6,
    and levels are bitwise equal in every bucket whose norm bytes match."""
    assert tbuf.shape == jbuf.shape and tbuf.dtype == jbuf.dtype == torch.uint8
    for n in tex.names:
        lay, lo, codec = tex.layouts[n], tex.offsets[n], tex.codecs[n]
        tl = lay.unpack(tbuf[lo : lo + lay.nbytes])
        jl = lay.unpack(jbuf[lo : lo + lay.nbytes])
        for i, (a, b) in enumerate(zip(tl, jl)):
            if i != codec.rows_leaf:
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{n} leaf {i}")
                continue
            meta = codec.val_codec.meta
            ra = a.numpy().reshape(meta.num_buckets, meta.bucket_size + 4)
            rb = b.numpy().reshape(meta.num_buckets, meta.bucket_size + 4)
            na = ra[:, meta.bucket_size :].copy().view(np.float32)
            nb = rb[:, meta.bucket_size :].copy().view(np.float32)
            np.testing.assert_allclose(na, nb, rtol=1e-6, err_msg=n)
            same = (na == nb).reshape(-1)
            np.testing.assert_array_equal(ra[same], rb[same], err_msg=n)


def test_four_worker_exchange_matches_jax_mesh():
    W, step, seed = 4, 3, 7
    shapes = {"b": (40,), "a/kernel": (48, 40), "c": (3000,), "d/bias": (12,)}
    rng = np.random.default_rng(1)
    res_w = [_grad_tree(rng, shapes) for _ in range(W)]
    grads_w = [_grad_tree(rng, shapes) for _ in range(W)]
    jcfg, tcfg = _cfgs(seed=seed, min_compress_size=100)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, jcfg)
    tex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert tex.names == jex.names
    assert tex.payload_bytes() == jex.payload_bytes(like)

    # JAX: the full exchange on a 4-device mesh
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in shapes}

    def spmd(g, r):
        g = {n: x[0] for n, x in g.items()}
        r = {n: x[0] for n, x in r.items()}
        agg, new_r, _ = jex.exchange(g, r, step=step)
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}

    fn = shard_map(
        spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False,
    )
    jagg, jres = jax.jit(fn)(stack(grads_w), stack(res_w))

    # port: per-worker encode+pack with JAX's draws, stacked rows, decode
    bufs, comps = [], []
    for w in range(W):
        wkey = jax.random.fold_in(jax.random.PRNGKey(seed), w)
        keys = jex._keys(wkey, jnp.asarray(step, jnp.int32))
        uniforms = {n: _jax_uniforms(jex.codecs[n], keys[n]) for n in shapes if jex.codecs[n].compressed}
        tg = {n: _t(grads_w[w][n]) for n in shapes}
        tr = {n: _t(res_w[w][n]) for n in shapes}
        buf, comp, _ = tex.encode_worker(tg, tr, step=step, worker=w, uniforms=uniforms)
        # the packed buffer is byte-identical to the JAX package's
        jcomp = {n: jnp.asarray(grads_w[w][n]) + jnp.asarray(res_w[w][n]) for n in shapes}
        jpay = {n: jex.codecs[n].encode(jcomp[n], step=step, key=keys[n]) for n in shapes}
        _assert_same_wire(tex, buf, _t(jex._pack_fused(jpay)))
        bufs.append(buf)
        comps.append(comp)
    gathered = torch.stack(bufs)
    # a norm one ulp apart moves each decoded value (|x| < 8 here) by at
    # most one float32 ulp of 8, ~1e-6; that bounds the aggregate and the
    # residual differences
    for w in range(W):
        agg, own = tex.decode_aggregate(gathered, own=w)
        new_res = tmemory.update(comps[w], own)
        for n in shapes:
            np.testing.assert_allclose(agg[n].numpy(), np.asarray(jagg[n][w]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(new_res[n].numpy(), np.asarray(jres[n][w]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("memory", ["residual", "none"])
def test_grouped_encode_equals_per_tensor_packs(memory, inject):
    """`encode_worker` writes every leaf into one buffer and all QSGD rows
    with one grouped call: the bytes equal the concatenation of each
    tensor's own encode, packed, under the same streams."""
    step, worker = 2, 1
    shapes = {"b": (40,), "a/kernel": (48, 40), "c": (3000,), "d/bias": (12,), "e": (2000,)}
    rng = np.random.default_rng(6)
    g = {n: _t(x) for n, x in _grad_tree(rng, shapes).items()}
    r = {n: _t(x) for n, x in _grad_tree(rng, shapes).items()} if memory == "residual" else None
    _, tcfg = _cfgs(seed=11, memory=memory, min_compress_size=100)
    ex = port.GradientExchanger(shapes, tcfg, device="cpu")
    uniforms = None
    if inject:
        uniforms = {
            n: torch.from_numpy(rng.random(c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size).astype(np.float32))
            for n, c in ex.codecs.items() if c.compressed
        }
    buf, comp, stats = ex.encode_worker(g, r, step=step, worker=worker, uniforms=uniforms)
    assert buf.dtype == torch.uint8 and buf.shape == (ex.payload_bytes(),)
    packs = []
    for n in ex.names:
        u = None if uniforms is None else uniforms.get(n)
        pay = ex.codecs[n].encode(comp[n], step=step, worker=worker, uniforms=u)
        packs.append(ex.layouts[n].pack(pay.leaves()))
    assert torch.equal(buf, torch.cat(packs))
    assert sum(c.compressed for c in ex.codecs.values()) == 3
    assert 0.0 < float(stats.rel_volume()) < 1.0


def test_exchange_without_memory_keeps_no_residual():
    # memory='none': no compensation, no residual; the W=1 aggregate is the
    # worker's own decode
    shapes = {"w": (3000,), "b": (10,)}
    rng = np.random.default_rng(2)
    g = {n: _t(x) for n, x in _grad_tree(rng, shapes).items()}
    _, tcfg = _cfgs(memory="none")
    ex = port.GradientExchanger(shapes, tcfg, device="cpu")
    assert ex.init_state(g) is None
    agg, res, stats = ex.exchange(g, None, step=0)
    assert res is None
    for n in shapes:
        np.testing.assert_array_equal(agg[n].numpy(), ex.codecs[n].decode(ex.codecs[n].encode(g[n])).numpy())
    assert 0.0 < float(stats.rel_volume()) < 1.0


def _jax_flat_params(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {_leaf_name(p): np.asarray(l) for p, l in leaves}


def test_two_step_wordlstm_trainer_matches_jax():
    vocab, embed, hidden, batch, seq, lr, mom, seed = 64, 8, 16, 4, 5, 0.1, 0.9, 3
    jcfg, tcfg = _cfgs(seed=seed, min_compress_size=100)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(2, batch, seq + 1)).astype(np.int32)
    batches = [(tokens[i, :, :-1], tokens[i, :, 1:]) for i in range(2)]

    jmodel = JWordLSTM(vocab_size=vocab, embed_dim=embed, hidden_dim=hidden)
    jtr = JTrainer(jmodel, jcfg, optax.sgd(lr, momentum=mom), shared_mesh(1))
    jstate = jtr.init_state(jax.random.PRNGKey(0), batches[0])
    flat0 = _jax_flat_params(jstate.params)

    tmodel = WordLSTM(vocab, embed, hidden)
    tmodel.load_flax_params(params_from_jax(flat0))
    ttr = port.Trainer(tmodel, tcfg, lr=lr, momentum=mom, device="cpu")
    tstate = ttr.init_state()
    assert sorted(tstate.params) == sorted(flat0)

    for i, (x, y) in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        wkey = jax.random.fold_in(key, 0)
        codecs = jtr.exchanger.codecs
        uniforms = {
            n: _jax_uniforms(c, per_tensor_key(wkey, n, jnp.asarray(i, jnp.int32)))
            for n, c in codecs.items() if c.compressed
        }
        assert len(uniforms) >= 8  # the codecs really run
        jstate, jloss, jwire = jtr.step(jstate, (x, y), key)
        tstate, tloss, twire = ttr.step(tstate, (_t(x).long(), _t(y).long()), uniforms=uniforms)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    assert tstate.step == 2


def test_port_imports_no_jax():
    code = (
        "import sys, deepreduce_tpu_torch, deepreduce_tpu_torch.models, deepreduce_tpu_torch.weights,"
        " deepreduce_tpu_torch.qar, deepreduce_tpu_torch.sparse_rs, deepreduce_tpu_torch.costmodel,"
        " deepreduce_tpu_torch.collectives, deepreduce_tpu_torch.comm_bucket, deepreduce_tpu_torch.comm_stream,"
        " deepreduce_tpu_torch.exchange, deepreduce_tpu_torch.numerics, deepreduce_tpu_torch.fedavg,"
        " deepreduce_tpu_torch.fedsim, deepreduce_tpu_torch.fedsim.round, deepreduce_tpu_torch.fedsim.codec_tree,"
        " deepreduce_tpu_torch.models.mobilenet, deepreduce_tpu_torch.models.ncf, deepreduce_tpu_torch.models.bert,"
        " deepreduce_tpu_torch.checkpoint, deepreduce_tpu_torch.resilience.retry;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax', 'optax'))"
        " or m == 'deepreduce_tpu' or m.startswith('deepreduce_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_default_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    cfg = port.DeepReduceConfig(**FLAGSHIP)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.TensorCodec((2000,), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.GradientExchanger({"w": (2000,)}, cfg)
    for knobs in (dict(communicator="qar", compressor="none", memory="none"), dict(communicator="sparse_rs")):
        with pytest.raises(RuntimeError, match="CUDA"):
            port.GradientExchanger({"w": (2000,)}, port.DeepReduceConfig(**knobs))
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Trainer(WordLSTM(16, 4, 8), cfg, lr=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.FedAvg(lambda p, b: p["w"].sum(), cfg, port.FedConfig(4, 2), 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.TreeCodec("c2s", cfg)
    v = torch.zeros(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_levels(v, v, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        qsgd_encode_rows([], torch.zeros(4, dtype=torch.uint8), quantum_num=127, bucket_size=512)


def test_config_rejects_unported_knobs_by_name():
    with pytest.raises(port.ConfigError, match="approx_topk") as e:
        port.DeepReduceConfig(**{**FLAGSHIP, "approx_topk": True})
    assert e.value.knob == "approx_topk"
    # the JAX package's host-side values (its C++ library, pure_callback)
    for knob, val in [("decode_strategy", "vmap"), ("policy", "conflict_sets"),
                      ("index", "huffman"), ("index", "bloom_native"), ("index", "integer_native"),
                      ("value", "gzip"), ("value", "polyfit_host")]:
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**{**FLAGSHIP, knob: val})
        assert e.value.knob == knob
    # sparse_rs runs, but not its count-sketch route
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(communicator="sparse_rs", compressor="topk", deepreduce=None, rs_mode="sketch")
    assert e.value.knob == "rs_mode"
    # qar runs, but not under the flagship's codec stack, which it would ignore
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**{**FLAGSHIP, "communicator": "qar"})
    assert e.value.knob == "build-qar-codec-stack"
    with pytest.raises(port.ConfigError) as e:
        port.from_params({**FLAGSHIP, "use_pallas": True})
    assert e.value.knob == "use_pallas"
    assert port.from_params(FLAGSHIP) == port.DeepReduceConfig(**FLAGSHIP)
    # the codec knobs are read only when a codec runs, as in the JAX package:
    # an unported value codec stands without one and is rejected with one
    assert port.DeepReduceConfig(value="polyfit_host").deepreduce is None
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(deepreduce="both", value="polyfit_host")
    assert e.value.knob == "value"
    # every on-device value builds
    for knob, val in [("bloom_blocked", "hash"), ("policy", "random"), ("policy", "conflict_sets_approx"),
                      ("compressor", "randomk"), ("compressor", "threshold"), ("deepreduce", "value"),
                      ("index", "rle"), ("value", "doubleexp"), ("value", "polyseg"), ("value", "countsketch")]:
        assert getattr(port.DeepReduceConfig(**{**FLAGSHIP, knob: val}), knob) == val
    assert dataclasses.asdict(port.from_params(FLAGSHIP))["policy"] == "p0"
