"""Port parity for the README quick start on ResNet-20: the model (names,
layout, SAME padding, flax BatchNorm), its loss, gradients and running
statistics, the payload bytes and two `Trainer` steps in both arms
(PolyFit, and QSGD on the same index), each against the JAX package on the
CPU at full width 16 on 8x8 images, batch 4, so every conv leaf keeps its
real d and k.

Tolerances: the conv backward sums in another order than XLA's, so the
loss agrees to rtol 1e-5 and the gradients and BatchNorm statistics to
rtol 1e-4 (atol 1e-5 of the leaf's largest magnitude). After two steps the
parameters agree to rtol 1e-4 / atol 1e-6: PolyFit's coefficients are
solved by another LU than XLA's (`test_torch_polyfit`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from conftest import shared_mesh
from test_torch_slice import _jax_flat_params, _jax_uniforms, _t

import flax.linen as fnn
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models.resnet import ResNet20 as JResNet20
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.train import classification_loss as jclassification_loss
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import memory as tmemory
from deepreduce_tpu_torch.models import ResNet20
from deepreduce_tpu_torch.models.common import Conv, same_pads
from deepreduce_tpu_torch.train import classification_loss
from deepreduce_tpu_torch.weights import batch_stats_from_jax, params_from_jax

from torch_ranks import run_trainer_rank

QUICKSTART = dict(
    compressor="topk", compress_ratio=0.01, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="polyfit", fpr=0.001, policy="leftmost",
)
ARMS = {"resnet20_quickstart": {}, "resnet20_drqsgd": dict(value="qsgd")}
PAYLOAD_BYTES = {"resnet20_quickstart": 18_756, "resnet20_drqsgd": 15_544}
LR, MOMENTUM = 0.1, 0.9


def _batches(n, batch=4, hw=8, seed=5):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, batch, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, batch)).astype(np.int32)
    return [(images[i], labels[i]) for i in range(n)]


def _tbatch(b):
    return _t(b[0]), _t(b[1]).long()


@functools.lru_cache(maxsize=None)
def _jax_init(hw=8):
    """JAX's initial (params, batch_stats); they depend on the input's
    shape, not on its values or the batch size."""
    variables = JResNet20().init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3), jnp.float32))
    return variables["params"], variables["batch_stats"]


# JAX's (loss, new batch_stats) and gradients at a state and a batch
_jax_grad = jax.jit(jax.value_and_grad(jclassification_loss(JResNet20()), has_aux=True))


def _port_model(jparams, jstats):
    model = ResNet20()
    model.load_flax_params(params_from_jax(_jax_flat_params(jparams)))
    model.load_flax_batch_stats(batch_stats_from_jax(_jax_flat_params(jstats)))
    return model


def _close(got, ref, rtol, what):
    """rtol, with atol 1e-5 of the reference's largest magnitude."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * float(np.abs(ref).max()), err_msg=what)


def test_leaf_names_and_sizes_match_jax():
    jparams, jstats = _jax_init()
    jnames = list(_jax_flat_params(jparams))  # the JAX flatten order: the wire's order
    model = ResNet20()
    assert sorted(model.flax_params()) == jnames
    assert sorted(model.flax_batch_stats()) == list(_jax_flat_params(jstats))
    assert len(jnames) == 61 and sum(p.numel() for p in model.parameters()) == 272_282
    stats = model.flax_batch_stats()
    assert len(stats) == 38 and sum(s.numel() for s in stats.values()) == 1_376
    shapes = {n: tuple(p.shape) for n, p in model.flax_params().items()}
    for n, a in _jax_flat_params(jparams).items():
        assert shapes[n] == a.shape, n
    # the projecting blocks name their shortcut Conv_0, as flax does
    assert shapes["BasicBlockV2_3/Conv_0/kernel"] == (1, 1, 16, 32)
    assert shapes["BasicBlockV2_6/Conv_2/kernel"] == (3, 3, 64, 64)
    assert shapes["Dense_0/kernel"] == (64, 10)


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2), (8, 3, 1), (32, 3, 2)])
def test_same_padding_matches_flax(size, kernel, stride):
    expected = {(8, 3, 2): (0, 1), (7, 3, 2): (1, 1), (8, 1, 2): (0, 0), (8, 3, 1): (1, 1), (32, 3, 2): (0, 1)}
    assert same_pads(size, kernel, stride) == expected[(size, kernel, stride)]
    rng = np.random.default_rng(size + kernel)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    conv = fnn.Conv(6, (kernel, kernel), (stride, stride), use_bias=False)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    tconv = Conv(5, 6, kernel, stride, torch.Generator().manual_seed(0))
    with torch.no_grad():
        tconv.kernel.copy_(_t(params["params"]["kernel"]))
        got = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_loss_grads_and_batch_stats_match_jax():
    batch = _batches(1)[0]
    jparams, jstats = _jax_init()
    (jloss, jnew), jgrads = _jax_grad(jparams, jstats, (jnp.asarray(batch[0]), jnp.asarray(batch[1])))
    model = _port_model(jparams, jstats).train()
    loss = classification_loss(model)(_tbatch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for n, g in _jax_flat_params(jgrads).items():
        _close(model.flax_params()[n].grad.numpy(), g, 1e-4, n)
    moved = 0
    for n, s in _jax_flat_params(jnew).items():
        got = model.flax_batch_stats()[n].numpy()
        _close(got, s, 1e-4, n)
        moved += not np.array_equal(got, _jax_flat_params(jstats)[n])
    assert moved == 38  # every running statistic moved by the batch's
    # eval mode normalizes with the running statistics instead
    model.eval()
    with torch.no_grad():
        ref = JResNet20().apply({"params": jparams, "batch_stats": jnew}, jnp.asarray(batch[0]), train=False)
        np.testing.assert_allclose(model(_t(batch[0])).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_payload_bytes_match_jax():
    jparams, _ = _jax_init()
    like = jax.tree_util.tree_map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), jparams)
    shapes = {n: tuple(p.shape) for n, p in ResNet20().flax_params().items()}
    for arm, nbytes in PAYLOAD_BYTES.items():
        knobs = {**QUICKSTART, **ARMS[arm]}
        ex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu")
        assert ex.payload_bytes() == JExchanger(like, JConfig(**knobs)).payload_bytes(like) == nbytes, arm
        assert sum(c.compressed for c in ex.codecs.values()) == 19
        ks = sorted(c.k for c in ex.codecs.values() if c.compressed)
        assert (ks[0], ks[-1]) == (20, 368)


def _exchange_jax_inputs(exchange, jgrads, jres, step):
    """Wrap the port exchanger's `exchange` so that it checks the port's
    gradient and residuals against JAX's (as `_close` does) and then
    exchanges JAX's: both packages' codecs choose from the same compensated
    gradient, so no near-tie between two roundings of it (the conv backward
    sums in another order than XLA's) can decide the comparison."""

    def wrapped(grads, residuals, **kw):
        for n in grads:
            _close(grads[n].numpy(), jgrads[n], 1e-4, f"step {step}, gradient of {n}")
            _close(residuals[n].numpy(), jres[n][0], 1e-4, f"step {step}, residual of {n}")
        return exchange({n: _t(jgrads[n]) for n in grads}, {n: _t(jres[n][0]) for n in grads}, **kw)

    return wrapped


@pytest.mark.parametrize("arm", list(ARMS))
def test_two_step_resnet20_trainer_matches_jax(arm):
    knobs = {**QUICKSTART, **ARMS[arm], "seed": 3}
    jcfg, tcfg = JConfig(**knobs), port.DeepReduceConfig(**knobs)
    batches = _batches(2, seed=8)
    jtr = JTrainer(JResNet20(), jcfg, optax.sgd(LR, momentum=MOMENTUM), shared_mesh(1))
    jstate = jtr.init_state(jax.random.PRNGKey(0), batches[0])
    ttr = port.Trainer(_port_model(jstate.params, jstate.batch_stats), tcfg, lr=LR, momentum=MOMENTUM, device="cpu")
    tstate = ttr.init_state()
    assert sorted(tstate.batch_stats) == list(_jax_flat_params(jstate.batch_stats))
    codecs = jtr.exchanger.codecs
    exchange = ttr.exchanger.exchange
    for i, b in enumerate(batches):
        _, jgrads = _jax_grad(jstate.params, jstate.batch_stats, (jnp.asarray(b[0]), jnp.asarray(b[1])))
        ttr.exchanger.exchange = _exchange_jax_inputs(
            exchange, _jax_flat_params(jgrads), _jax_flat_params(jstate.residuals), i
        )
        key = jax.random.PRNGKey(100 + i)
        uniforms = None
        if arm == "resnet20_drqsgd":
            wkey = jax.random.fold_in(key, 0)
            uniforms = {
                n: _jax_uniforms(c, per_tensor_key(wkey, n, jnp.asarray(i, jnp.int32)))
                for n, c in codecs.items() if c.val_codec is not None
            }
            assert len(uniforms) == 19
        jstate, jloss, jwire = jtr.step(jstate, (jnp.asarray(b[0]), jnp.asarray(b[1])), key)
        tstate, tloss, twire = ttr.step(tstate, _tbatch(b), uniforms=uniforms)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    assert tstate.step == 2
    jflat = _jax_flat_params(jstate.params)
    for n, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=1e-4, atol=1e-6, err_msg=n)
    for n, s in _jax_flat_params(jstate.batch_stats).items():
        _close(tstate.batch_stats[n].numpy(), s, 1e-4, n)


def test_two_rank_gloo_resnet20_step(tmp_path):
    """One quick-start step of two gloo ranks on their own batches: the
    running statistics on both ranks are the mean of the ranks' local ones,
    the parameters are equal across ranks, and each rank's aggregate and
    residual equal the single-process decode of the same two workers,
    bitwise."""
    world = 2
    batches = [_tbatch(b) for b in _batches(world, batch=2, seed=9)]
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=run_trainer_rank, args=(r, world, store, outs[r], QUICKSTART, batches))
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

    for n, s in got[0]["stats"].items():
        mean = (got[0]["local_stats"][n] + got[1]["local_stats"][n]) / world
        assert not torch.equal(got[0]["local_stats"][n], got[1]["local_stats"][n]), n
        for r in range(world):
            assert torch.equal(got[r]["stats"][n], mean), (r, n)
    for n, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][n]), n
    assert got[0]["loss"] == got[1]["loss"]
    ex = port.GradientExchanger(got[0]["grads"], port.DeepReduceConfig(**QUICKSTART), device="cpu")
    zeros = {n: torch.zeros_like(g) for n, g in got[0]["grads"].items()}
    bufs, comps = [], []
    for w in range(world):
        buf, comp, _ = ex.encode_worker(got[w]["grads"], zeros, step=0, worker=w)
        bufs.append(buf)
        comps.append(comp)
    for r in range(world):
        agg, own = ex.decode_aggregate(torch.stack(bufs), own=r)
        res = tmemory.update(comps[r], own)
        for n in ex.names:
            assert torch.equal(got[r]["agg"][n], agg[n]), (r, n)
            assert torch.equal(got[r]["residuals"][n], res[n]), (r, n)


def test_cuda_default_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    cfg = port.DeepReduceConfig(**QUICKSTART)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Trainer(ResNet20(), cfg, lr=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.TensorCodec((3, 3, 64, 64), cfg)
