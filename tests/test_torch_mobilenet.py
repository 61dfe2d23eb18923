"""Port parity for MobileNetV1 (`models/mobilenet.py`, the shared layers of
`models/common.py`) against the JAX package's flax model on the CPU, with
the weights carried across by `weights.params_from_flax`.

At 3 blocks, width 0.25, on 16x16x3 inputs (a stride-2 block, whose SAME
padding is (0, 1), and depthwise convolutions with groups = C) in training
mode (batch statistics): the logits agree to rtol 1e-5 (atol 1e-6), and the
gradients, which torch and XLA sum in other orders, to rtol 1e-4 and atol
1e-5 of the largest gradient magnitude of the model: at the initial zero
BatchNorm biases the loss does not depend on the stem's BatchNorm scales
(every block's BatchNorm divides them out), so their gradients are
rounding noise around 0.

At full width (width 1.0, 13 blocks, 32x32x3, the FedAvg arms' model) the
float32 gradients of both packages stray from their float64 values by up
to a few percent of the largest gradient: thirteen batch-mode BatchNorms,
the last two over 2x2 maps, make each pointwise kernel's gradient a
difference of large terms. So the full-width case holds the port to JAX
in float64 (atol 1e-6 of the largest magnitude), and each package's
float32 gradients to the float64 ones within 5% of the largest gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from test_torch_slice import _t

from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.fedavg import FedAvg as JFedAvg
from deepreduce_tpu.fedsim.round import FedConfig as JFedConfig
from deepreduce_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch.models import MobileNetV1
from deepreduce_tpu_torch.weights import flatten_flax, params_from_flax

NARROW = dict(num_classes=10, width_mult=0.25, blocks=((64, 1), (128, 2), (128, 1)))


@functools.lru_cache(maxsize=None)
def _jax():
    model = JMobileNetV1(**NARROW)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 16, 3), jnp.float32), train=True)

    def loss(params, x, y):
        logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    return variables["params"], jax.jit(jax.value_and_grad(loss, has_aux=True))


def _batch(seed=2, batch=6):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, 16, 16, 3)).astype(np.float32), rng.integers(0, 10, size=batch).astype(np.int32)


def test_names_shapes_and_flatten_order_match_flax():
    jparams, _ = _jax()
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jnames = ["/".join(k.key for k in path) for path, _ in leaves]
    model = MobileNetV1(**NARROW)
    own = model.flax_params()
    assert set(own) == set(jnames)
    # the port's trees flatten in JAX's order (sorted keys, level by level)
    assert sorted(own, key=lambda n: n.split("/")) == jnames
    for (path, leaf), name in zip(leaves, jnames):
        assert tuple(own[name].shape) == leaf.shape, name
    assert tuple(own["SeparableBlock_1/Conv_0/kernel"].shape) == (3, 3, 1, 16)  # depthwise HWIO


def test_full_width_parameter_count():
    params = MobileNetV1().flax_params()
    assert len(params) == 83
    assert sum(p.numel() for p in params.values()) == 3_217_226


def test_forward_and_gradients_match_flax():
    jparams, grad_fn = _jax()
    model = MobileNetV1(**NARROW)
    model.load_flax_params(params_from_flax(jax.device_get(jparams)))
    x, y = _batch()
    (jloss, jlogits), jgrads = grad_fn(jparams, x, y)
    params = {n: p.detach().clone().requires_grad_(True) for n, p in model.flax_params().items()}
    logits = model.functional(params, _t(x))
    loss = F.cross_entropy(logits, _t(y).long())
    loss.backward()
    torch.testing.assert_close(logits, _t(jlogits), rtol=1e-5, atol=1e-6)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    jg = {n: _t(g) for n, g in flatten_flax(jax.device_get(jgrads)).items()}
    scale = max(float(g.abs().max()) for g in jg.values())
    for n, p in params.items():
        torch.testing.assert_close(p.grad, jg[n], rtol=1e-4, atol=1e-5 * scale, msg=lambda m, n=n: f"{n}: {m}")
    # the module's own forward is the functional one at its own parameters
    with torch.no_grad():
        torch.testing.assert_close(model(_t(x)), logits.detach(), rtol=0, atol=0)


def test_loader_rejects_a_wrong_shape_or_name():
    jparams, _ = _jax()
    flat = params_from_flax(jax.device_get(jparams))
    model = MobileNetV1(**NARROW)
    bad = dict(flat, **{"Dense_0/kernel": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        model.load_flax_params(bad)
    with pytest.raises(KeyError, match="missing"):
        model.load_flax_params({n: t for n, t in flat.items() if n != "Dense_0/bias"})
    with pytest.raises(KeyError, match="missing"):
        model.functional({n: t for n, t in flat.items() if n != "Dense_0/bias"}, torch.zeros(1, 16, 16, 3))


def _nest(flat):
    out = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _arm_task(steps=4, batch=24, seed=5):
    """The FedAvg MobileNet arms' task at their shapes: class prototypes plus
    noise 2.5 on 32x32x3 images, `steps` local batches of `batch`, and a
    held-out batch (float64)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 32, 32, 3))
    y = rng.integers(0, 10, size=(steps + 1, batch)).astype(np.int32)
    x = protos[y] + 2.5 * rng.normal(size=(steps + 1, batch, 32, 32, 3))
    return (x[:steps], y[:steps]), (x[steps], y[steps])


def test_full_width_gradients_match_flax_and_the_arm_knobs_diverge_in_both():
    """The FedAvg MobileNet arms' model at full width, from the same weights
    (carried from the port to flax) on the arms' task. Gradients: the port's
    equal flax's in float64, and each package's float32 ones lie within 5%
    of the largest gradient of the float64 ones. Local training: one
    client's 4 steps of SGD 0.2 momentum 0.9 on 24 images
    (`FedAvg._local_train` of each package, float32) raise the held-out
    loss by more than half in both packages: these knobs diverge from a
    random start. The two trajectories are not compared with each other:
    a gradient step here amplifies a last-bit difference in the
    parameters by orders of magnitude."""
    model = MobileNetV1(seed=0)
    flat = {n: p.detach().numpy().astype(np.float64) for n, p in model.flax_params().items()}
    bn = {n[: -len("scale")]: a for n, a in flat.items() if n.endswith("scale")}
    stats = _nest({**{k + "mean": np.zeros_like(a) for k, a in bn.items()},
                   **{k + "var": np.ones_like(a) for k, a in bn.items()}})
    (xs, ys), (xh, yh) = _arm_task()
    f32 = lambda a: a.astype(np.float32)

    def jloss_of(jmodel):
        def jloss(p, b):
            logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, b[0], train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean()
        return jloss

    def ploss(p, b):
        return F.cross_entropy(model.functional(p, b[0]), b[1].long())

    pgrads, jgrads = {}, {}
    for dt in (np.float32, np.float64):
        params = {n: torch.from_numpy(a.astype(dt)).requires_grad_(True) for n, a in flat.items()}
        pgrads[dt] = dict(zip(params, torch.autograd.grad(ploss(params, (_t(xs[0].astype(dt)), _t(ys[0]))),
                                                          list(params.values()))))
    with jax.enable_x64(True):
        for dt in (np.float32, np.float64):
            jloss = jloss_of(JMobileNetV1(dtype=jnp.dtype(dt)))
            g = jax.jit(jax.grad(jloss))(_nest({n: a.astype(dt) for n, a in flat.items()}), (xs[0].astype(dt), ys[0]))
            jgrads[dt] = {n: _t(a) for n, a in flatten_flax(jax.device_get(g)).items()}
    truth = jgrads[np.float64]
    scale = max(float(g.abs().max()) for g in truth.values())
    for n, g in truth.items():
        torch.testing.assert_close(pgrads[np.float64][n], g, rtol=1e-6, atol=1e-6 * scale,
                                   msg=lambda m, n=n: f"float64 gradient {n}: {m}")
        for who, g32 in (("port", pgrads[np.float32][n]), ("JAX", jgrads[np.float32][n])):
            err = float((g32.double() - g).abs().max())
            assert err <= 0.05 * scale, f"{who} float32 gradient {n} off float64 by {err / scale:.3g} of the scale"

    fed = dict(num_clients=10, clients_per_round=10, local_steps=4)
    jloss = jloss_of(JMobileNetV1())
    jfa = JFedAvg(jloss, JConfig(compressor="none", memory="none"), JFedConfig(**fed), optax.sgd(0.2, momentum=0.9))
    jstart = _nest({n: f32(a) for n, a in flat.items()})
    jend = jax.jit(lambda w, b: jfa._local_train(w, b, jax.random.PRNGKey(0)))(jstart, (f32(xs), ys))
    jheld = [float(jax.jit(jloss)(p, (f32(xh), yh))) for p in (jstart, jend)]
    pfa = port.FedAvg(ploss, port.DeepReduceConfig(compressor="none", memory="none"), port.FedConfig(**fed),
                      0.2, 0.9, device="cpu")
    start = {n: _t(f32(a)) for n, a in flat.items()}
    end = pfa._local_train(start, (_t(f32(xs)), _t(ys)))
    with torch.no_grad():
        held = [float(ploss(p, (_t(f32(xh)), _t(yh)))) for p in (start, end)]
    assert held[0] == pytest.approx(jheld[0], rel=1e-5)
    assert held[1] > 1.5 * held[0] and jheld[1] > 1.5 * jheld[0], f"held-out loss: port {held}, JAX {jheld}"
