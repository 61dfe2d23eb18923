"""Port parity for the int8 quantized allreduce (`communicator='qar'`)
against the JAX package on the CPU mesh, at W in {1, 2, 4} through the
port's in-process group of lockstep workers.

Bitwise where the arithmetic allows: the inputs sit on the grid 2**-6 and
every 512-bucket's squares sum to (4 * 127)**2, so each bucket norm is
4 * 127 * 2**-6, exact in float32 in both packages; the dequantized values
(level * norm * fl(1/127) = level / 16) then sit on a grid again, so the
phase-2 norms are exact too. Given the uniforms JAX draws, levels, norms
and the mean are then bitwise equal. On normal inputs the port's own Philox
streams are held to JAX's accuracy bound and to unbiasedness."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P

from deepreduce_tpu import qar as jqar
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import qar
from deepreduce_tpu_torch.models import WordLSTM

QAR = dict(communicator="qar", compressor="none", memory="none", deepreduce=None)
SHAPES = {"a/kernel": (40, 100), "b": (1003,)}  # d = 5,003: an unaligned tail
D = 5003
BUCKET = 512
ANCHOR = 4 * 127  # every bucket's sqrt(sum m**2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _four_squares(r: int):
    """Four non-negative integers whose squares sum to r."""
    for a in range(math.isqrt(r), -1, -1):
        r1 = r - a * a
        for b in range(min(a, math.isqrt(r1)), -1, -1):
            r2 = r1 - b * b
            for c in range(min(b, math.isqrt(r2)), -1, -1):
                e = math.isqrt(r2 - c * c)
                if e * e == r2 - c * c and e <= c:
                    return [a, b, c, e]
    raise AssertionError(r)


def anchored_grid(rng, d: int, bucket: int = BUCKET) -> np.ndarray:
    """f32[d] of integers * 2**-6 (30% zeros) whose every bucket (the tail's
    too) has sum m**2 = ANCHOR**2: four entries of each bucket are set by
    Lagrange's four squares to reach it."""
    m = np.zeros(d, np.int64)
    for lo in range(0, d, bucket):
        n = min(bucket, d - lo)
        x = rng.integers(-30, 31, size=n)
        x[rng.random(n) < 0.3] = 0
        x[-4:] = 0
        rest = ANCHOR * ANCHOR - int((x * x).sum())
        assert rest >= 0
        x[-4:] = np.array(_four_squares(rest)) * rng.choice([-1, 1], size=4)
        m[lo : lo + n] = rng.permutation(x)
    assert np.all(np.abs(m) <= ANCHOR)
    return (m * 2.0**-6).astype(np.float32)


def _split(flat):
    out, lo = {}, 0
    for n in sorted(SHAPES):
        size = math.prod(SHAPES[n])
        out[n] = flat[lo : lo + size].reshape(SHAPES[n])
        lo += size
    return out


def _jax_qar_exchange(grads_w, step, key, seed=0):
    """The JAX package's `GradientExchanger.exchange` (communicator='qar')
    on a W-device mesh: every worker's aggregate."""
    W = len(grads_w)
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in SHAPES.items()}
    jex = JExchanger(like, JConfig(**QAR, seed=seed), num_workers=W)

    def spmd(g):
        agg, _, wire = jex.exchange({n: x[0] for n, x in g.items()}, None, step=step, key=key)
        return {n: x[None] for n, x in agg.items()}, wire.rel_volume()[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"),), out_specs=(P("data"), P("data")),
                   check_vma=False)
    stacked = {n: jnp.stack([jnp.asarray(g[n]) for g in grads_w]) for n in SHAPES}
    return jax.jit(fn)(stacked)


def _jax_uniforms(key, step, W):
    """The draws of JAX's two phases for each worker: {stream name: u}."""
    n = qar.pad_len(D, W, BUCKET)
    skey = jax.random.fold_in(key, jnp.uint32(step))
    out = []
    for w in range(W):
        k1 = jax.random.fold_in(skey, w)
        k2 = jax.random.fold_in(k1, jnp.uint32(0x5EED))
        out.append({qar.STREAM_PHASE1: _t(jax.random.uniform(k1, (n,))),
                    qar.STREAM_PHASE2: _t(jax.random.uniform(k2, (n // W,)))})
    return out


def _port_exchange(grads_w, step, uniforms_w=None, seed=0):
    """Every worker's (aggregate, wire stats) through the port's exchanger:
    W threads of an in-process group, or no group at W = 1."""
    W = len(grads_w)
    cfg = port.DeepReduceConfig(**QAR, seed=seed)

    def work(coll, grads, uniforms):
        ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll if W > 1 else None)
        agg, res, wire = ex.exchange({n: _t(g) for n, g in grads.items()}, None, step=step, uniforms=uniforms)
        assert res is None
        return agg, wire

    return port.InProcessGroup(W).run(work, grads_w, uniforms_w or [None] * W)


def test_pad_len_and_wire_bits_match_jax():
    for d in (1, 511, 512, 5003, 6000, 4_050_748):
        for W in (1, 2, 3, 4, 8):
            for bs in (100, 512):
                assert qar.pad_len(d, W, bs) == jqar.pad_len(d, W, bs)
                assert qar.wire_bits_per_worker(d, W, bs) == jqar.wire_bits_per_worker(d, W, bs)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kind", ["anchored", "grid"])
def test_bucket_quantize_matches_jax(kind, shared):
    """Levels and norms bitwise given JAX's uniforms, with local norms and
    with externally given ones; the dequantize too."""
    rng = np.random.default_rng(1)
    n = 6 * BUCKET
    if kind == "anchored":
        flat = anchored_grid(rng, n)
    else:
        flat = (rng.integers(-100, 101, size=n) * 2.0**-6).astype(np.float32)
        flat[rng.random(n) < 0.3] = 0.0
        flat[-BUCKET:] = 0.0  # a zero bucket: the norm guard
    norms = None
    if shared:
        norms = np.asarray(jnp.linalg.norm(jnp.asarray(flat).reshape(-1, BUCKET), axis=1)) * 2.0
    key = jax.random.PRNGKey(7)
    jl, jn = jqar.bucket_quantize(jnp.asarray(flat), 127, BUCKET, key,
                                  norms=None if norms is None else jnp.asarray(norms))
    tl, tn = qar.bucket_quantize(_t(flat), 127, BUCKET, (0, 0), norms=None if norms is None else _t(norms),
                                 uniforms=_t(jax.random.uniform(key, (n,))))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.abs().max()) <= 127 and int((tl != 0).sum()) > n // 4
    np.testing.assert_array_equal(
        qar.bucket_dequantize(tl, tn, 127, BUCKET).numpy(), np.asarray(jqar.bucket_dequantize(jl, jn, 127, BUCKET))
    )


@pytest.mark.parametrize("W", [1, 2, 4])
def test_exchange_bitwise_matches_jax_on_anchored_grid(W):
    step, key = 3, jax.random.PRNGKey(11)
    rng = np.random.default_rng(2 + W)
    grads_w = [_split(anchored_grid(rng, D)) for _ in range(W)]
    jagg, jrel = _jax_qar_exchange(grads_w, step, key)
    out = _port_exchange(grads_w, step, _jax_uniforms(key, step, W))
    for w, (agg, wire) in enumerate(out):
        for n in SHAPES:
            np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][w]), err_msg=f"worker {w} {n}")
        assert float(wire.rel_volume()) == float(jrel[w])
        assert float(wire.index_bits) == 0.0
    # the quantization did something: the mean is not the exact one
    exact = {n: sum(g[n] for g in grads_w) / W for n in SHAPES}
    assert any(not np.array_equal(out[0][0][n].numpy(), exact[n]) for n in SHAPES)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_exchange_accuracy_and_unbiasedness_on_normal_inputs(W):
    """The port's own Philox streams: every worker gets the same mean,
    within JAX's own relative bound of the exact mean (0.15, tests/test_qar.py),
    and the average over 64 streams (steps) is far closer."""
    rng = np.random.default_rng(5)
    grads_w = [_split(rng.normal(size=D).astype(np.float32)) for _ in range(W)]
    exact = np.concatenate([(sum(g[n] for g in grads_w) / W).reshape(-1) for n in sorted(SHAPES)])
    flat = lambda agg: np.concatenate([agg[n].numpy().reshape(-1) for n in sorted(SHAPES)])
    acc = np.zeros(D, np.float64)
    draws = 64
    for step in range(draws):
        out = _port_exchange(grads_w, step, seed=3)
        for agg, _ in out[1:]:
            for n in SHAPES:
                assert torch.equal(agg[n], out[0][0][n])
        mean = flat(out[0][0])
        rel = np.linalg.norm(mean - exact) / np.linalg.norm(exact)
        assert rel < 0.15, (step, rel)
        acc += mean
    # independent draws: the error of the average shrinks like 1/sqrt(64)
    rel_avg = np.linalg.norm(acc / draws - exact) / np.linalg.norm(exact)
    assert rel_avg < 0.03, rel_avg


def _worker_collectives(W):
    return None if W == 1 else port.InProcessGroup(W).member(0)


@pytest.mark.parametrize("shapes", ["small", "wordlstm"])
def test_payload_bytes_match_jax(shapes):
    if shapes == "small":
        like = SHAPES
    else:
        like = {n: tuple(p.shape) for n, p in WordLSTM(embed_dim=96, hidden_dim=670).flax_params().items()}
        assert sum(math.prod(s) for s in like.values()) == 4_050_748
    jlike = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in like.items()}
    got = {}
    for W in (1, 4, 8):
        ex = port.GradientExchanger(like, port.DeepReduceConfig(**QAR), device="cpu", group=_worker_collectives(W))
        got[W] = ex.payload_bytes()
        assert got[W] == JExchanger(jlike, JConfig(**QAR), num_workers=W).payload_bytes(jlike)
    if shapes == "wordlstm":
        assert got == {1: 0, 4: 6_123_888, 8: 7_144_536}


def test_codec_stack_fence_matches_jax():
    flagship = dict(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom",
                    value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod")
    for knobs in (flagship, dict(QAR, memory="residual"), dict(QAR, compressor="topk")):
        knobs = {**knobs, "communicator": "qar"}
        with pytest.raises(port.ConfigError) as e:
            port.DeepReduceConfig(**knobs)
        assert e.value.knob == "build-qar-codec-stack"
        with pytest.raises(JConfigError) as je:
            JExchanger({"w": jnp.zeros((D,))}, JConfig(**knobs), num_workers=2)
        assert je.value.reason_code == e.value.knob
    assert port.DeepReduceConfig(**QAR).communicator == "qar"


def test_quantize_rejects_wide_levels_and_unpadded_input():
    with pytest.raises(ValueError, match="int8"):
        qar.bucket_quantize(torch.zeros(BUCKET), 200, BUCKET, (0, 0))
    with pytest.raises(ValueError, match="pad_len"):
        qar.quantized_allreduce(torch.zeros(100), port.InProcessGroup(1).member(0), streams=[(0, 0), (0, 1)])
