"""Port parity for the sparse_rs count-sketch route (`rs_mode='sketch'`) and
the cost model's route choice (`rs_mode='auto'`) against the JAX package.

The sketch route runs at W = 1, 3 and 4 through the port's in-process group
against the JAX package's `sparse_rs.exchange` under `shard_map` on the CPU
mesh, at d = 70,001, where `topk_sampled` takes its sampled threshold path.
On inputs of integers x 2**-6 every sketch column sum, every sum over the
workers and every median is exact in float32 in any order, so the mean, the
own-transmitted tensor and the wire stats are bitwise equal. On normal
inputs the sums round, and XLA adds the psum's W sketches and a column's
entries in an order of its own: the test then holds the outputs within
1e-6 x max|g|, the same phase-2 selection included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sparse_rs import RS, _grid, _jax_route, _port_route

from deepreduce_tpu import costmodel as jcostmodel
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import costmodel, sparse, sparse_rs

D_SKETCH = 70_001  # above 2 x the 32,768-element sample: the sampled threshold runs
SKETCH_KW = dict(sketch_rows=5, sketch_cols=0, sketch_seed=3)
NORMAL_ATOL = 1e-6


@pytest.mark.parametrize("W", [1, 3, 4])
def test_sketch_route_bitwise_matches_jax_on_the_grid(W):
    rng = np.random.default_rng(30 + W)
    flat_w = [_grid(rng, d=D_SKETCH) for _ in range(W)]
    syncs = sparse.host_branch.syncs
    tout = _port_route(flat_w, "sketch", [None] * W, **SKETCH_KW)
    assert sparse.host_branch.syncs - syncs == W  # the sampled threshold, once a worker
    jout = _jax_route(flat_w, "sketch", None, **SKETCH_KW)
    for w in range(W):
        for f, t, j in zip(["mean", "own", "index_bits", "value_bits", "dense_bits"], tout[w], jout):
            np.testing.assert_array_equal(t, j[w], err_msg=f"sketch W={W} worker {w} {f}")
    mean, own = tout[0][0], tout[0][1]
    assert np.count_nonzero(mean) > 0 and np.count_nonzero(own) > 0
    C = costmodel.sketch_cols(D_SKETCH, 0.1, 5)
    K2 = -(-sparse.num_slots(D_SKETCH, 0.1) // W)
    assert float(tout[0][2]) == K2 * 32.0 and float(tout[0][3]) == (5 * C + K2) * 32.0


def test_sketch_route_matches_jax_on_normal_inputs_within_rounding():
    W = 4
    rng = np.random.default_rng(7)
    flat_w = [rng.standard_normal(D_SKETCH).astype(np.float32) for _ in range(W)]
    tout = _port_route(flat_w, "sketch", [None] * W, **SKETCH_KW)
    jout = _jax_route(flat_w, "sketch", None, **SKETCH_KW)
    atol = NORMAL_ATOL * max(float(np.abs(f).max()) for f in flat_w)
    for w in range(W):
        for f, t, j in zip(["mean", "own"], tout[w][:2], jout[:2]):
            np.testing.assert_array_equal(t != 0, j[w] != 0, err_msg=f"worker {w} {f}: the selection")
            np.testing.assert_allclose(t, j[w], rtol=0, atol=atol, err_msg=f"worker {w} {f}")


def _resolved(shapes, knobs, W, profile=None):
    d = sum(int(np.prod(s)) for s in shapes.values())
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    jex = JExchanger(like, JConfig(**knobs), num_workers=W, profile=profile[0] if profile else None)
    group = port.InProcessGroup(W).member(0)
    tex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu", group=group,
                                 profile=profile[1] if profile else None)
    assert tex.payload_bytes() == jex.payload_bytes(like), (d, W, knobs)
    return tex._rs_mode, jex._rs_mode


@pytest.mark.parametrize("resilience", [False, True])
def test_auto_resolves_to_the_jax_route(resilience):
    knobs = dict(RS, rs_mode="auto", resilience=resilience)
    picks = set()
    fitted = tuple(m.MachineProfile(bw_dcn=2e9, t_enc_s=0.01, routes={"sketch": {"t_enc_s": 0.0, "t_dec_s": 0.0,
                                                                                  "samples": 1}})
                   for m in (jcostmodel, costmodel))
    for shapes in ({"w": (5003,)}, {"a": (400, 500), "b": (3,)}, {"e": (10_004, 96), "k": (766, 2680)}):
        for W in (1, 2, 4, 8):
            for profile in (None, fitted):
                got, want = _resolved(shapes, knobs, W, profile)
                assert got == want, (shapes, W, profile is not None)
                picks.add(got)
    assert len(picks) >= 2
    assert picks <= ({"sparse", "quantized", "oktopk"} if resilience else set(costmodel.RS_MODES[:5]))


def test_auto_needs_the_group_where_jax_needs_the_mesh_size():
    like = {"w": jax.ShapeDtypeStruct((5003,), jnp.float32)}
    with pytest.raises(JConfigError) as je:
        JExchanger(like, JConfig(**RS, rs_mode="auto"))
    with pytest.raises(port.ConfigError) as e:
        port.GradientExchanger({"w": (5003,)}, port.DeepReduceConfig(**RS, rs_mode="auto"), device="cpu")
    assert e.value.reason_code == je.value.reason_code == "build-rs-auto-needs-workers"
    # a one-worker group resolves it, as num_workers=1 does
    assert _resolved({"w": (5003,)}, dict(RS, rs_mode="auto"), 1) == ("sparse", "sparse")


def test_sketch_exchanger_trains_and_refuses_a_mask():
    """The exchanger's sketch route at W = 1: the residual keeps what the
    sketch did not carry, and a participation mask is refused with the JAX
    package's message."""
    g = torch.from_numpy(_grid(np.random.default_rng(5), d=D_SKETCH))
    ex = port.GradientExchanger({"w": (D_SKETCH,)}, port.DeepReduceConfig(**RS, rs_mode="sketch"), device="cpu",
                                group=port.InProcessGroup(1).member(0))
    agg, res, wire = ex.exchange({"w": g}, ex.init_state({"w": g}), step=0)
    carried = agg["w"] != 0
    assert 0 < int(carried.sum()) <= 7000  # at most K2 = k coordinates at W = 1
    assert torch.equal(res["w"][~carried], g[~carried])  # what was not carried stays behind whole
    assert float(wire.value_bits) == (5 * costmodel.sketch_cols(D_SKETCH, 0.1, 5) + 7000) * 32.0
    with pytest.raises(ValueError, match="sketch rows are per-worker wire state"):
        sparse_rs.exchange(g, port.InProcessGroup(1).member(0), ratio=0.1, rs_mode="sketch",
                           mask=torch.ones(1, dtype=torch.bool))
