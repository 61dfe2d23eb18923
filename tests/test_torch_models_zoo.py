"""Port parity for ResNet-50, DenseNet-40 and VGG16 (`models/resnet.py`,
`models/densenet.py`, `models/vgg.py` and the layers they share in
`models/common.py`) against the JAX package's flax models on the CPU.

- Full width: names, shapes, flatten order and parameter and statistic
  counts equal flax's (`jax.eval_shape`, no compile), and the payload bytes
  of every chip_smoke phase-14 arm of these models equal the JAX package's.
- Small size (ResNet-50 with one block a stage on 32x32, DenseNet with two
  layers a block at growth 4, VGG16 with three narrow stages), in training
  mode on numpy-seeded weights carried across by `weights.py`, every last
  ResNet-50 block norm at flax's zero scale: the loss to rtol 1e-5, the
  gradients to rtol 1e-4 and atol 1e-4 of the model's largest gradient
  (torch and XLA sum in other orders), the running statistics to rtol 1e-4.
  With a nonzero last scale, flax's own float32 gradients of the small
  ResNet-50 stray up to 2% of the largest from their float64 values (its
  tiny batch-mode norms), so the weights keep flax's zero there.
- ResNet-50 in bfloat16: each package rounds every convolution and norm
  output to 8 bits, in other summation orders, so a last-bit difference
  (0.4%) compounds through the layers. Measured on this input: loss 1.9e-3
  apart, logits 1.2e-2, running statistics 9e-4 (relative), and the
  gradients of both packages 17-20% (relative L2 over the model) from the
  float64 ones. Held: loss rtol 5e-3, logits atol 5e-2 of the largest,
  statistics rtol 5e-3, both packages' gradients within 30% of the
  float64 ones, and every gradient float32 as it reaches the exchange.
- One `Trainer` step per model under DRQSGD-BF-P0 against the JAX
  `Trainer` (JAX's uniforms injected into the QSGD rows, and JAX's
  gradient exchanged by both once the port's own is checked against it, as
  `test_torch_resnet.py` does): equal wire bytes, the parameters after the
  step to rtol 1e-4 / atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import shared_mesh
from test_torch_slice import _jax_flat_params, _jax_uniforms, _t

import flax.linen as fnn
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.comm import _leaf_name
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.models import DenseNet40 as JDenseNet40
from deepreduce_tpu.models import ResNet50 as JResNet50
from deepreduce_tpu.models import VGG16 as JVGG16
from deepreduce_tpu.sparse import per_tensor_key
from deepreduce_tpu.train import Trainer as JTrainer
from deepreduce_tpu.train import classification_loss as jclassification_loss
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.models import VGG16, DenseNet40, ResNet50
from deepreduce_tpu_torch.models.common import Conv, max_pool_same
from deepreduce_tpu_torch.train import classification_loss
from deepreduce_tpu_torch.weights import batch_stats_from_jax, params_from_flax

# model -> (flax model, port model, input hw) at the small test size
SMALL = {
    "resnet50": (lambda **kw: JResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1), **kw),
                 lambda **kw: ResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1), **kw), 32),
    "densenet40": (lambda **kw: JDenseNet40(growth=4, layers_per_block=2, **kw),
                   lambda **kw: DenseNet40(growth=4, layers_per_block=2, **kw), 16),
    "vgg16": (lambda **kw: JVGG16(stages=((8, 1), (16, 2), (16, 1)), **kw),
              lambda **kw: VGG16(stages=((8, 1), (16, 2), (16, 1)), **kw), 16),
}
# model -> (flax model, port model, input hw, leaves, parameters, statistics, statistic floats)
FULL = {
    "resnet50": (JResNet50, ResNet50, 224, 161, 25_557_032, 106, 53_120),
    "densenet40": (JDenseNet40, DenseNet40, 32, 119, 1_019_722, 78, 18_096),
    "vgg16": (JVGG16, VGG16, 32, 43, 14_986_698, 26, 8_448),
}
DRQSGD = dict(
    compressor="topk", compress_ratio=0.1, approx_topk=False, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod", quantum_num=127,
    bucket_size=512,
)
QUICKSTART = dict(
    compressor="topk", compress_ratio=0.01, memory="residual", communicator="allgather",
    deepreduce="both", index="bloom", value="polyfit", fpr=0.001, policy="leftmost",
)
# chip_smoke phase 14's arms of these models: (model, knobs, payload bytes
# of the JAX package's GradientExchanger at full width, compressed leaves)
PHASE14 = {
    "resnet50_dense": ("resnet50", dict(compressor="none", deepreduce=None, communicator="allreduce", memory="none"),
                       102_228_128, 0),
    "resnet50_topk1_bloom": ("resnet50", dict(compressor="topk", compress_ratio=0.01, memory="residual",
                                              deepreduce="index", index="bloom", bloom_blocked="mod", fpr=0.001),
                             2_335_272, 76),
    "resnet50_drqsgd_bloom": ("resnet50", dict(DRQSGD, compress_ratio=0.01, memory="none", fpr=0.001), 1_622_736, 76),
    "resnet50_quickstart": ("resnet50", QUICKSTART, 943_248, 76),
    "densenet40_drqsgd": ("densenet40", dict(QUICKSTART, value="qsgd"), 40_860, 39),
    "vgg16_polyseg": ("vgg16", dict(QUICKSTART, deepreduce="value", value="polyseg"), 1_694_552, 13),
}
LR, MOMENTUM = 0.1, 0.9


def _shapes(tree):
    """name -> shape of a flax tree of arrays or shape structs, in JAX's
    flatten order."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_leaf_name(p): tuple(l.shape) for p, l in leaves}


@functools.lru_cache(maxsize=None)
def _full_shapes(model):
    jctor, tctor, hw = FULL[model][:3]
    v = jax.eval_shape(jctor().init, jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3), jnp.float32))
    return v["params"], v["batch_stats"], tctor()


def _seeded(like, seed=1):
    """numpy-seeded weights shaped like the flax `params` tree: kernels
    normal over sqrt(fan-in), norm scales near 1 (0 where flax's init sets a
    zero scale: a bottleneck block's last norm), biases small."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = leaf.shape
        if name.endswith("scale"):
            a = np.zeros(shape) if "BottleneckBlock" in name and "BatchNorm_3" in name else 1 + 0.2 * rng.normal(size=shape)
        elif name.endswith("bias"):
            a = 0.1 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(make, like)


def _images(n=4, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, hw, hw, 3)).astype(np.float32), rng.integers(0, 10, size=n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _small(model, jax_dtype=jnp.float32):
    """(flax model, its seeded params, unit running statistics, a batch)."""
    jctor, _, hw = SMALL[model]
    jm = jctor(dtype=jax_dtype)
    x, y = _images(hw=hw)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1])
    stats = jax.tree_util.tree_map(lambda l: np.ones(l.shape, np.float32), v["batch_stats"])
    return jm, _seeded(v["params"]), stats, (x, y)


def _port(model, params, stats, **kw):
    m = SMALL[model][1](**kw).train()
    m.load_flax_params(params_from_flax(params))
    m.load_flax_batch_stats(batch_stats_from_jax(_jax_flat_params(stats)))
    return m


def _port_grads(m, batch):
    loss = classification_loss(m)((_t(batch[0]), _t(batch[1]).long()))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in m.flax_params().items()}


@pytest.mark.parametrize("model", list(FULL))
def test_full_width_structure_matches_flax(model):
    jparams, jstats, tm = _full_shapes(model)
    leaves, params, n_stats, stat_floats = FULL[model][3:]
    jnames = list(_shapes(jparams))  # JAX's flatten order: the wire's
    assert sorted(tm.flax_params()) == jnames and len(jnames) == leaves
    assert {n: tuple(p.shape) for n, p in tm.flax_params().items()} == _shapes(jparams)
    assert sum(p.numel() for p in tm.parameters()) == params
    stats = tm.flax_batch_stats()
    assert sorted(stats) == list(_shapes(jstats)) and len(stats) == n_stats
    assert sum(s.numel() for s in stats.values()) == stat_floats
    assert {n: tuple(s.shape) for n, s in stats.items()} == _shapes(jstats)


def test_resnet50_names_follow_flax_creation_order():
    """The projecting block's shortcut is created first (Conv_0,
    BatchNorm_0), its last norm starts at a zero scale; `BottleneckBlock_10`
    sorts before `_2` in the wire's order."""
    _, _, tm = _full_shapes("resnet50")
    p = tm.flax_params()
    assert tuple(p["BottleneckBlock_0/Conv_0/kernel"].shape) == (1, 1, 64, 256)
    assert tuple(p["BottleneckBlock_0/Conv_1/kernel"].shape) == (1, 1, 64, 64)
    assert tuple(p["BottleneckBlock_1/Conv_0/kernel"].shape) == (1, 1, 256, 64)  # identity shortcut
    assert tuple(p["BottleneckBlock_3/Conv_0/kernel"].shape) == (1, 1, 256, 512)
    assert tuple(p["Conv_0/kernel"].shape) == (7, 7, 3, 64)
    assert not bool(p["BottleneckBlock_7/BatchNorm_3/scale"].any()) and bool(p["BottleneckBlock_7/BatchNorm_2/scale"].all())
    names = sorted(p)
    assert names.index("BottleneckBlock_10/Conv_0/kernel") < names.index("BottleneckBlock_2/Conv_0/kernel")


@pytest.mark.parametrize("size,stride,pads", [(112, 2, (0, 1)), (7, 2, (1, 1)), (8, 1, (1, 1))])
def test_max_pool_same_and_explicit_conv_padding_match_flax(size, stride, pads):
    """flax's SAME max pool pads -inf asymmetrically ((0, 1) at ResNet-50's
    112 -> 56), and the stem's explicit (3, 3) conv padding."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32) - 3.0  # all negative: a 0 pad would show
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (stride, stride), padding="SAME"))
    got = max_pool_same(_t(x).permute(0, 3, 1, 2), 3, stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    conv = fnn.Conv(5, (7, 7), (2, 2), padding=[(3, 3), (3, 3)], use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tconv = Conv(4, 5, 7, 2, torch.Generator().manual_seed(0), padding=(3, 3))
    with torch.no_grad():
        tconv.kernel.copy_(_t(v["params"]["kernel"]))
        out = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(conv.apply(v, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(model, jax_dtype=jnp.float32):
    return jax.jit(jax.value_and_grad(jclassification_loss(_small(model, jax_dtype)[0]), has_aux=True))


@pytest.mark.parametrize("model", list(SMALL))
def test_forward_gradients_and_stats_match_flax(model):
    jm, params, stats, batch = _small(model)
    (jloss, jnew), jgrads = _jax_grad_fn(model)(params, stats, batch)
    m = _port(model, params, stats)
    loss, grads = _port_grads(m, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = _jax_flat_params(jgrads)
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    for n, g in jflat.items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=1e-4, atol=1e-4 * scale, err_msg=n)
    moved = 0
    for n, s in _jax_flat_params(jnew).items():
        got = m.flax_batch_stats()[n].numpy()
        np.testing.assert_allclose(got, s, rtol=1e-4, atol=1e-6, err_msg=n)
        moved += not np.array_equal(got, 1.0)
    assert moved == len(m.flax_batch_stats())
    # eval mode normalizes with the running statistics
    m.eval()
    with torch.no_grad():
        ref = jm.apply({"params": params, "batch_stats": jnew}, batch[0], train=False)
        np.testing.assert_allclose(m(_t(batch[0])).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def _global_rel_l2(grads, truth):
    num = sum(float(((g.double() - t) ** 2).sum()) for g, t in ((grads[n], truth[n]) for n in truth))
    return (num / sum(float((t ** 2).sum()) for t in truth.values())) ** 0.5


def test_resnet50_bfloat16_matches_flax_within_bfloat16_rounding():
    _, params, stats, batch = _small("resnet50", jnp.bfloat16)
    (jloss, jnew), jgrads = _jax_grad_fn("resnet50", jnp.bfloat16)(params, stats, batch)
    m = _port("resnet50", params, stats, dtype=torch.bfloat16)
    loss, grads = _port_grads(m, batch)
    assert all(g.dtype == torch.float32 for g in grads.values())  # parameters, and so gradients, stay float32
    np.testing.assert_allclose(loss, float(jloss), rtol=5e-3)
    for n, s in _jax_flat_params(jnew).items():
        np.testing.assert_allclose(m.flax_batch_stats()[n].numpy(), s, rtol=5e-3, atol=1e-5, err_msg=n)
    jm = _small("resnet50", jnp.bfloat16)[0]
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, batch[0], mutable=["batch_stats"])[0])
    with torch.no_grad():
        got = _port("resnet50", params, stats, dtype=torch.bfloat16)(_t(batch[0])).numpy()
    assert got.dtype == np.float32  # the head computes in float32
    np.testing.assert_allclose(got, ref, atol=5e-2 * float(np.abs(ref).max()))
    # the float64 gradients of the same function (the port's, a float64 copy)
    m64 = _port("resnet50", params, stats).double()
    _, truth = _port_grads(m64, (batch[0].astype(np.float64), batch[1]))
    jflat = {n: _t(g) for n, g in _jax_flat_params(jgrads).items()}
    assert _global_rel_l2(grads, truth) < 0.3
    assert _global_rel_l2(jflat, truth) < 0.3


def test_bfloat16_gradients_reach_the_exchange_as_float32():
    _, params, stats, batch = _small("resnet50")
    m = _port("resnet50", params, stats, dtype=torch.bfloat16)
    tr = port.Trainer(m, port.DeepReduceConfig(**DRQSGD), lr=LR, momentum=MOMENTUM, device="cpu")
    state = tr.init_state()
    seen = []
    exchange = tr.exchanger.exchange

    def recording(grads, residuals, **kw):
        seen.extend(g.dtype for g in grads.values())
        return exchange(grads, residuals, **kw)

    tr.exchanger.exchange = recording
    state, loss, _ = tr.step(state, (_t(batch[0]), _t(batch[1]).long()))
    assert len(seen) == 53 and set(seen) == {torch.float32}
    assert np.isfinite(float(loss)) and all(p.dtype == torch.float32 for p in state.params.values())


@pytest.mark.parametrize("arm", list(PHASE14))
def test_full_width_payload_bytes_match_jax(arm):
    model, knobs, nbytes, compressed = PHASE14[arm]
    jparams, _, tm = _full_shapes(model)
    like = jax.tree_util.tree_map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), jparams)
    shapes = {n: tuple(p.shape) for n, p in tm.flax_params().items()}
    ex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu")
    assert ex.payload_bytes() == JExchanger(like, JConfig(**knobs)).payload_bytes(like) == nbytes
    assert sum(c.compressed for c in ex.codecs.values()) == compressed
    if arm == "vgg16_polyseg":  # PolySeg's '(?i)conv' pattern: the 13 conv kernels
        assert sorted(n for n, c in ex.codecs.items() if c.compressed) == sorted(f"Conv_{i}/kernel" for i in range(13))


def jax_trainer(jm, cfg, batch, loss_fn=None):
    """The JAX `Trainer` (SGD lr 0.1 momentum 0.9, one worker) and its
    initial state. The model's `init` runs jitted: eagerly, flax compiles
    one small program per operation (20 s for these models)."""
    object.__setattr__(jm, "init", jax.jit(type(jm).init.__get__(jm)))
    jtr = JTrainer(jm, cfg, optax.sgd(LR, momentum=MOMENTUM), shared_mesh(1), loss_fn=loss_fn)
    return jtr, jtr.init_state(jax.random.PRNGKey(0), batch)


def _checked_exchange(exchange, jgrads, jres, scale):
    """The port exchanger's `exchange`, checking the port's gradient and
    residuals against JAX's and then exchanging JAX's (see
    `test_torch_resnet._exchange_jax_inputs`)."""

    def wrapped(grads, residuals, **kw):
        for n in grads:
            np.testing.assert_allclose(grads[n].numpy(), jgrads[n], rtol=1e-4, atol=1e-4 * scale, err_msg=n)
            np.testing.assert_array_equal(residuals[n].numpy(), jres[n][0], err_msg=n)
        return exchange({n: _t(jgrads[n]) for n in grads}, {n: _t(jres[n][0]) for n in grads}, **kw)

    return wrapped


# the one-step test compresses a few of the largest leaves (the smallest
# compressed size, and the count), which keeps the JAX step's compile short
STEP_COMPRESS = {"resnet50": (500_000, 6), "densenet40": (1000, 4), "vgg16": (1000, 5)}


@pytest.mark.parametrize("model", list(SMALL))
def test_one_drqsgd_trainer_step_matches_jax(model):
    knobs = dict(DRQSGD, seed=3, min_compress_size=STEP_COMPRESS[model][0])
    jm, params, stats, batch = _small(model)
    jtr, jstate = jax_trainer(jm, JConfig(**knobs), batch)
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, params),
                                 batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    ttr = port.Trainer(_port(model, params, stats), port.DeepReduceConfig(**knobs), lr=LR, momentum=MOMENTUM,
                       device="cpu")
    tstate = ttr.init_state()
    jbatch = (jnp.asarray(batch[0]), jnp.asarray(batch[1]))
    _, jgrads = _jax_grad_fn(model)(jstate.params, jstate.batch_stats, batch)
    jflat = _jax_flat_params(jgrads)
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    ttr.exchanger.exchange = _checked_exchange(ttr.exchanger.exchange, jflat, _jax_flat_params(jstate.residuals), scale)
    key = jax.random.PRNGKey(100)
    codecs = jtr.exchanger.codecs
    uniforms = {n: _jax_uniforms(c, per_tensor_key(jax.random.fold_in(key, 0), n, jnp.asarray(0, jnp.int32)))
                for n, c in codecs.items() if c.val_codec is not None}
    assert len(uniforms) == sum(c.compressed for c in ttr.exchanger.codecs.values()) == STEP_COMPRESS[model][1]
    jstate, jloss, jwire = jtr.step(jstate, jbatch, key)
    tstate, tloss, twire = ttr.step(tstate, (_t(batch[0]), _t(batch[1]).long()), uniforms=uniforms)
    assert ttr.exchanger.payload_bytes() == jtr.exchanger.payload_bytes(jstate.params)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(twire.rel_volume()), float(jwire.rel_volume()), rtol=1e-6)
    for n, p in _jax_flat_params(jstate.params).items():
        np.testing.assert_allclose(tstate.params[n].detach().numpy(), p, rtol=1e-4, atol=1e-6, err_msg=n)
    for n, r in _jax_flat_params(jstate.residuals).items():
        np.testing.assert_allclose(tstate.residuals[n].numpy(), r[0], rtol=1e-4, atol=1e-6, err_msg=n)
