"""Port parity for the resilience subsystem against the JAX package: the
payload checksum word, `FaultPlan`, the participation mask and the chaos
injector with JAX's draws injected, `owner_permutation` and the masked
sparse_rs routes on the CPU mesh, the reason codes of the fences; the
port's own counter-based draws against their distribution; the residual's
mass conservation under a dropped worker; and the resilience CLI.

Where JAX draws (`jax.random`: dropout, chaos events, byte selection and
noise, the quantized route's uniforms) the test injects its draws, so the
outputs are bitwise equal. The sparse_rs inputs sit on the grid 2**-6, so
every norm and sum is exact in float32 in both packages."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_sparse_rs import BLOCK, RATIO, _grid, _jax_uniforms

from deepreduce_tpu import sparse_rs as jsparse_rs
from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.comm import PayloadLayout as JLayout
from deepreduce_tpu.config import REASON_CODES as JREASON_CODES
from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.resilience import chaos as jchaos
from deepreduce_tpu.resilience import faults as jfaults
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import config as tconfig
from deepreduce_tpu_torch import sparse_rs
from deepreduce_tpu_torch.comm import PayloadLayout, checksum_word
from deepreduce_tpu_torch.resilience import chaos, faults, stream


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the checksum word ------------------------------------------------------- #


@pytest.mark.parametrize("n", [0, 1, 4095, (1 << 23) + 77])
def test_checksum_word_and_verify_match_jax(n):
    """The word of n bytes bitwise JAX's uint32 word (past 2**23 bytes an
    unsplit int64 sum of byte * weight would overflow), the packed buffer
    bitwise JAX's pack, and `verify` JAX's gate on the intact buffer, on a
    buffer with one byte flipped and on an all-zero one."""
    rng = np.random.default_rng(n % 1000)
    body = rng.integers(0, 256, size=n, dtype=np.uint8)
    jl = JLayout(jax.ShapeDtypeStruct((n,), jnp.uint8), checksum=True)
    tl = PayloadLayout([((n,), torch.uint8)], checksum=True)
    assert (tl.nbytes, tl.payload_nbytes) == (jl.nbytes, jl.payload_nbytes) == (n + 4, n)
    jword = int(JLayout._checksum_word(jnp.asarray(body)))
    assert int(checksum_word(_t(body))) == jword
    packed = tl.pack([_t(body)])
    jpacked = np.asarray(jl.pack(jnp.asarray(body)))
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    bad = jpacked.copy()
    bad[n // 2 if n else n] ^= 0x10
    for buf in (jpacked, bad, np.zeros_like(jpacked)):
        assert float(tl.verify(_t(buf)[None])[0]) == float(jl.verify(jnp.asarray(buf)))
    assert float(tl.verify(packed[None])[0]) == 1.0
    assert float(tl.verify(_t(bad)[None])[0]) == 0.0
    # a dropped (all-zero) payload always fails: the salt
    assert float(tl.verify(torch.zeros(1, n + 4, dtype=torch.uint8))[0]) == 0.0


def test_checksum_rows_verify_in_one_batch():
    """`verify` over [R, nbytes] rows gives each row's gate."""
    rng = np.random.default_rng(5)
    tl = PayloadLayout([((300,), torch.float32), ((7,), torch.int32)], checksum=True)
    rows = torch.stack([tl.pack([_t(rng.normal(size=300).astype(np.float32)),
                                 _t(rng.integers(0, 9, 7).astype(np.int32))]) for _ in range(4)])
    rows[2, 17] ^= 1
    assert tl.verify(rows).tolist() == [1.0, 1.0, 0.0, 1.0]
    assert PayloadLayout([((3,), torch.float32)]).verify(rows[:, :12]).tolist() == [1.0] * 4


# -- FaultPlan and the participation mask ------------------------------------ #


BAD_PLANS = ["", "   ", "2@", "x@3", "1@5:5", "1@7:3", "2@5;9"]


def test_fault_plan_matches_jax():
    for spec in ("2@5:9, 0@12", "1@0", "3@2:4,3@3:6,9@1:3"):
        assert faults.FaultPlan.parse(spec).entries == jfaults.FaultPlan.parse(spec).entries
        for W in (1, 4, 8):
            for step in range(15):
                got = faults.FaultPlan.parse(spec).mask(step, W, device="cpu")
                np.testing.assert_array_equal(got.numpy(), np.asarray(jfaults.FaultPlan.parse(spec).mask(step, W)))
    for bad in BAD_PLANS:
        with pytest.raises(ValueError) as e:
            faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError) as je:
            jfaults.FaultPlan.parse(bad)
        assert str(e.value).split(" ")[:3] == str(je.value).split(" ")[:3]


def _jax_dropout_draws(key, step, W, drop_rate):
    k = jax.random.fold_in(jax.random.fold_in(key, jfaults._DROPOUT_TAG), jnp.asarray(step, jnp.uint32))
    return np.asarray(jax.random.bernoulli(k, 1.0 - drop_rate, (W,))).tolist()


def test_participation_mask_matches_jax_given_its_draws():
    key = jax.random.PRNGKey(3)
    assert faults.participation_mask(4, 0, 0, device="cpu") is None
    assert jfaults.participation_mask(4, 0, key) is None
    for step in range(6):
        for plan, rate in (("1@2:4", 0.0), (None, 0.3), ("0@1:5,3@4", 0.5)):
            W = 8
            draws = _jax_dropout_draws(key, step, W, rate) if rate > 0 else None
            got = faults.participation_mask(W, step, 0, drop_rate=rate, fault_plan=plan, device="cpu", draws=draws)
            want = jfaults.participation_mask(W, step, key, drop_rate=rate, fault_plan=plan)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{step} {plan} {rate}")


# -- the chaos injector ------------------------------------------------------ #


def _jax_chaos_draws(inj, B, step, worker, salt):
    """The events and byte draws JAX's `ChaosInjector.perturb` makes."""
    key = jax.random.PRNGKey(inj.seed)
    for word in (jchaos._CHAOS_TAG, salt, jnp.asarray(step, jnp.uint32), worker):
        key = jax.random.fold_in(key, word)
    kd, kc, kt, ksel, kbytes = jax.random.split(key, 5)
    return {
        "corrupt": inj.corrupt_rate > 0 and bool(jax.random.bernoulli(kc, inj.corrupt_rate)),
        "truncate": inj.truncate_rate > 0 and bool(jax.random.bernoulli(kt, inj.truncate_rate)),
        "drop": inj.drop_rate > 0 and bool(jax.random.bernoulli(kd, inj.drop_rate)),
        "sel": _t(jax.random.bernoulli(ksel, inj.corrupt_frac, (B,))),
        "noise": _t(jax.random.randint(kbytes, (B,), 1, 256, jnp.uint8)),
    }


def test_chaos_perturb_matches_jax_given_its_draws():
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, size=777, dtype=np.uint8)
    fired = set()
    for rates in ((0.5, 0.0, 0.0), (0.0, 0.6, 0.0), (0.0, 0.0, 0.6), (0.3, 0.5, 0.4)):
        kw = dict(drop_rate=rates[0], corrupt_rate=rates[1], truncate_rate=rates[2], seed=4)
        jinj, tinj = jchaos.ChaosInjector(**kw), chaos.ChaosInjector(**kw)
        for step, worker, salt in ((0, 0, 0), (3, 1, 0), (3, 2, 1), (7, 3, 2), (9, 0, 5)):
            draws = _jax_chaos_draws(jinj, buf.size, step, worker, salt)
            fired |= {k for k in ("corrupt", "truncate", "drop") if draws[k]}
            got = tinj.perturb(_t(buf), step=step, worker=worker, salt=salt, draws=draws)
            want = jinj.perturb(jnp.asarray(buf), step=step, worker=worker, salt=salt)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{rates} {step} {worker} {salt}")
    assert fired == {"corrupt", "truncate", "drop"}


def test_chaos_from_config_matches_jax():
    for kw in (dict(), dict(resilience=True), dict(resilience=True, payload_checksum=True, chaos_corrupt_rate=0.2),
               dict(resilience=True, payload_checksum=True, chaos_drop_rate=0.1, seed=9)):
        j = jchaos.ChaosInjector.from_config(JConfig(**kw))
        t = chaos.ChaosInjector.from_config(port.DeepReduceConfig(**kw))
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.drop_rate, t.corrupt_rate, t.truncate_rate, t.seed, t.corrupt_frac) == (
                j.drop_rate, j.corrupt_rate, j.truncate_rate, j.seed, j.corrupt_frac)


def test_port_stream_meets_its_distribution():
    """The port's own draws: event rates within 4 sigma of their binomial
    over 4,800 (step, worker, salt) keys, byte selection near 0.05 and noise
    never 0, truncate zeroes exactly the tail half and drop everything, the
    same key the same bytes, and a dropped buffer always fails its
    checksum."""
    inj = chaos.ChaosInjector(drop_rate=0.1, corrupt_rate=0.3, truncate_rate=0.5, seed=2)
    keys = [(s, w, salt) for s in range(300) for w in range(8) for salt in range(2)]
    counts = {"corrupt": 0, "truncate": 0, "drop": 0}
    for s, w, salt in keys:
        for k, v in inj.events(step=s, worker=w, salt=salt).items():
            counts[k] += v
    n = len(keys)
    for name, p in (("corrupt", 0.3), ("truncate", 0.5), ("drop", 0.1)):
        assert abs(counts[name] - n * p) <= 4 * math.sqrt(n * p * (1 - p)), (name, counts[name], n)
    d = inj.byte_draws(200_000, "cpu", step=3, worker=1, salt=0)
    share = float(d["sel"].float().mean())
    assert abs(share - 0.05) <= 4 * math.sqrt(0.05 * 0.95 / 200_000)
    assert int(d["noise"].min()) >= 1 and int(d["noise"].max()) == 255
    assert torch.equal(d["noise"], inj.byte_draws(200_000, "cpu", step=3, worker=1, salt=0)["noise"])
    assert not torch.equal(d["noise"], inj.byte_draws(200_000, "cpu", step=3, worker=2, salt=0)["noise"])
    # the CPU words are the host words (the card's are held equal in test_torch_cuda)
    k = stream.key(2, 0x0C405, 0, 3, 1)
    assert stream.words(k, 5, "cpu").tolist() == [stream.word(k, i) for i in range(5)]

    layout = PayloadLayout([((101,), torch.uint8)], checksum=True)
    buf = layout.pack([torch.arange(1, 102, dtype=torch.uint8)])
    one = {"sel": torch.ones(105, dtype=torch.bool), "noise": torch.ones(105, dtype=torch.uint8)}
    trunc = inj.perturb(buf, step=0, worker=0, draws=dict(one, corrupt=False, truncate=True, drop=False))
    assert torch.equal(trunc[:52], buf[:52]) and int(trunc[52:].abs().sum()) == 0
    drop = inj.perturb(buf, step=0, worker=0, draws=dict(one, corrupt=True, truncate=True, drop=True))
    assert int(drop.abs().sum()) == 0 and float(layout.verify(drop[None])[0]) == 0.0
    same = [inj.perturb(buf, step=s, worker=0) for s in range(40)]
    assert all(torch.equal(a, inj.perturb(buf, step=s, worker=0)) for s, a in enumerate(same))
    assert any(not torch.equal(a, buf) for a in same)


# -- owner_permutation and the masked sparse_rs routes ----------------------- #


def test_owner_permutation_matches_jax_for_every_mask():
    for bits in range(16):
        mask = np.array([(bits >> w) & 1 for w in range(4)], bool)
        got = sparse_rs.owner_permutation(_t(mask), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsparse_rs.owner_permutation(jnp.asarray(mask), 4)))
        if mask.any():
            assert mask[got.numpy()].all()  # every shard has a live owner


ROUTES = ("sparse", "quantized", "oktopk")
D = 5003


def _jax_masked(flat_w, mode, key, mask):
    W = len(flat_w)

    def spmd(g, m):
        collect = {}
        mean, own, st = jsparse_rs.exchange(g[0], "data", W, ratio=RATIO, rs_mode=mode, block_size=BLOCK,
                                            key=key if mode == "quantized" else None, collect=collect, mask=m)
        return mean[None], own[None], st.value_bits[None]

    fn = shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P()), out_specs=(P("data"),) * 3,
                   check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(jnp.asarray(np.stack(flat_w)), jnp.asarray(mask))]


def _port_masked(flat_w, mode, uniforms_w, mask):
    def work(coll, flat, u):
        m = None if mask is None else _t(mask)
        mean, own, st = sparse_rs.exchange(_t(flat), coll, ratio=RATIO, rs_mode=mode, block_size=BLOCK,
                                           stream=(5, 0), uniforms=u, mask=m)
        return mean.numpy(), own.numpy(), float(st.value_bits)

    return port.InProcessGroup(len(flat_w)).run(work, flat_w, uniforms_w)


@pytest.mark.parametrize("mode", ROUTES)
def test_masked_sparse_rs_route_matches_jax(mode):
    """W = 4 with worker 2 dropped: the mean (divided by the live count 3),
    the own-transmitted tensor and the wire bits bitwise JAX's; the dropped
    worker transmits nothing; an all-ones mask is bitwise the mask-free
    route."""
    W = 4
    rng = np.random.default_rng(40 + ROUTES.index(mode))
    flat_w = [_grid(rng) for _ in range(W)]
    key = jax.random.PRNGKey(21)
    u = _jax_uniforms(mode, key, W)
    drop = np.array([True, True, False, True])
    jmean, jown, jbits = _jax_masked(flat_w, mode, key, drop)
    out = _port_masked(flat_w, mode, u, drop)
    for w, (mean, own, bits) in enumerate(out):
        np.testing.assert_array_equal(mean, jmean[w], err_msg=f"{mode} worker {w} mean")
        np.testing.assert_array_equal(own, jown[w], err_msg=f"{mode} worker {w} own")
        assert bits == float(jbits[w])
    assert np.count_nonzero(out[0][0]) > 0 and not np.any(out[2][1])
    ones = _port_masked(flat_w, mode, u, np.ones(W, bool))
    free = _port_masked(flat_w, mode, u, None)
    for w in range(W):
        np.testing.assert_array_equal(ones[w][0], free[w][0])
        if mode != "quantized":  # the masked quantized route counts its extra all_gather
            assert ones[w][2] == free[w][2]
        np.testing.assert_array_equal(ones[w][1], free[w][1])


def test_masked_wire_bytes_match_jax():
    from deepreduce_tpu import costmodel as jcostmodel

    from deepreduce_tpu_torch import costmodel

    for mode in ROUTES:
        for W in (1, 4):
            kw = dict(masked=True)
            assert costmodel.rs_wire_bytes(mode, 4_050_748, W, 0.1, **kw) == jcostmodel.rs_wire_bytes(
                mode, 4_050_748, W, 0.1, **kw)
    cfg = dict(communicator="sparse_rs", compressor="topk", deepreduce=None, rs_mode="quantized", resilience=True)
    like = {"w": jnp.zeros((D,))}
    ex = port.GradientExchanger({"w": (D,)}, port.DeepReduceConfig(**cfg), device="cpu")
    assert ex.payload_bytes() == JExchanger(like, JConfig(**cfg), num_workers=1).payload_bytes(like)


# -- the dropped worker's residual ------------------------------------------ #


def test_dropped_worker_keeps_its_compensated_gradient():
    """A dropped worker's residual is its compensated gradient (bitwise: its
    own decode is an exact zero), the live workers' equal the unmasked
    exchange's, the mean divides by the live count, and the next all-live
    step delivers the held mass."""
    W = 3
    shapes = {"a": (1500,), "b": (80,)}
    knobs = dict(compressor="topk", compress_ratio=1.0, deepreduce=None, memory="residual", min_compress_size=1,
                 resilience=True, fault_plan="0@0")
    rng = np.random.default_rng(8)
    grads = [{n: _t(_grid(rng, math.prod(s)).reshape(s)) for n, s in shapes.items()} for _ in range(W)]
    res = [{n: _t(_grid(rng, math.prod(s)).reshape(s)) for n, s in shapes.items()} for _ in range(W)]
    cfg = port.DeepReduceConfig(**knobs)

    def work(coll, g, r):
        ex = port.GradientExchanger(shapes, cfg, device="cpu", group=coll)
        mask = faults.participation_mask(W, 0, 0, fault_plan=cfg.fault_plan, device="cpu")
        agg, new_r, _ = ex.exchange(g, r, step=0, mask=mask)
        agg2, new_r2, _ = ex.exchange({n: torch.zeros_like(t) for n, t in g.items()}, new_r, step=1)
        return agg, new_r, agg2, new_r2

    out = port.InProcessGroup(W).run(work, grads, res)
    for n in shapes:
        comp = [grads[w][n] + res[w][n] for w in range(W)]
        assert torch.equal(out[0][1][n], comp[0])  # the dropped worker's mass stays
        assert not out[1][1][n].any() and not out[2][1][n].any()  # lossless: nothing left
        np.testing.assert_array_equal(out[1][0][n].numpy(), ((comp[1] + comp[2]) / 2.0).numpy())
        # rejoin: worker 0's held mass reaches every worker's aggregate
        np.testing.assert_allclose(out[1][2][n].numpy(), (comp[0] / 3.0).numpy(), rtol=0, atol=1e-7)


# -- the fences -------------------------------------------------------------- #

FLAGSHIP = dict(compressor="topk", compress_ratio=0.1, memory="residual", deepreduce="both", index="bloom",
                value="qsgd", fpr=0.02, policy="p0", bloom_blocked="mod")
RS = dict(communicator="sparse_rs", compressor="topk", deepreduce=None)
R = dict(resilience=True)
CONFIG_FENCES = [
    (dict(FLAGSHIP, decode_strategy="tree"), "enum-decode_strategy"),
    (dict(FLAGSHIP, decode_batch=0), "decode-batch-range"),
    (dict(FLAGSHIP, bucket_bytes=4096, stream_exchange=True, resilience=True), "stream-vs-resilience"),
    (dict(FLAGSHIP, resilience=True, drop_rate=1.5), "resilience-rate-range"),
    (dict(FLAGSHIP, resilience=True, chaos_truncate_rate=-0.1, payload_checksum=True), "resilience-rate-range"),
    (dict(FLAGSHIP, payload_checksum=True), "resilience-knobs-disengaged"),
    (dict(FLAGSHIP, fault_plan="1@2"), "resilience-knobs-disengaged"),
    (dict(communicator="qar", compressor="none", memory="none", resilience=True), "resilience-vs-owner-communicator"),
    (dict(RS, rs_mode="adaptive", resilience=True), "resilience-vs-owner-communicator"),
    (dict(RS, bucket_bytes=4096, resilience=True), "resilience-vs-owner-communicator"),
    (dict(FLAGSHIP, resilience=True, chaos_corrupt_rate=0.2), "chaos-needs-checksum"),
    (dict(FLAGSHIP, resilience=True, payload_checksum=True, fused=False), "checksum-needs-fused-allgather"),
    (dict(FLAGSHIP, resilience=True, payload_checksum=True, communicator="allreduce"),
     "checksum-needs-fused-allgather"),
    (dict(FLAGSHIP, resilience=True, fault_plan="2@5;9"), "fault-plan-syntax"),
]
BUILD_FENCES = [
    (dict(FLAGSHIP, bucket_bytes=4096, decode_strategy="ring"), "build-buckets-vs-ring"),
    (dict(FLAGSHIP, fused=False, decode_strategy="vmap"), "build-decode-strategy-needs-fused-allgather"),
    (dict(FLAGSHIP, communicator="allreduce", decode_strategy="ring"), "build-decode-strategy-needs-fused-allgather"),
]


@pytest.mark.parametrize("knobs,code", CONFIG_FENCES + BUILD_FENCES,
                         ids=[f"{c}-{i}" for i, (_, c) in enumerate(CONFIG_FENCES + BUILD_FENCES)])
def test_fences_give_jax_reason_codes(knobs, code):
    like = {"w": jnp.zeros((3000,))}
    with pytest.raises(JConfigError) as je:
        JExchanger(like, JConfig(**knobs), num_workers=2)
    assert je.value.reason_code == code
    with pytest.raises(port.ConfigError) as e:
        port.GradientExchanger({"w": (3000,)}, port.DeepReduceConfig(**knobs), device="cpu")
    assert e.value.reason_code == code and tconfig.reason_code_of(e.value) == code
    assert isinstance(e.value, ValueError)


def test_reason_codes_are_jax_registry_plus_the_ports_own():
    assert {k: v for k, v in tconfig.REASON_CODES.items() if k not in tconfig.PORT_REASON_CODES} == JREASON_CODES
    assert not set(tconfig.PORT_REASON_CODES) & set(JREASON_CODES)
    with pytest.raises(AssertionError, match="unregistered"):
        port.ConfigError("no-such-code", "x")
    # `.knob` names the field where the code does not, else it is the code
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(compress_ratio=2.0)
    assert (e.value.reason_code, e.value.knob) == ("knob-range", "compress_ratio")
    with pytest.raises(port.ConfigError) as e:
        port.DeepReduceConfig(**FLAGSHIP, decode_batch=0)
    assert e.value.knob == e.value.reason_code == "decode-batch-range"
    # what the resilience surface accepts, as JAX does
    for knobs in (dict(FLAGSHIP, fused=False), dict(FLAGSHIP, decode_strategy="ring"),
                  dict(FLAGSHIP, decode_strategy="vmap", decode_batch=3),
                  dict(FLAGSHIP, resilience=True, fault_plan="0@1:2", drop_rate=0.25, payload_checksum=True,
                       chaos_drop_rate=0.1, chaos_corrupt_rate=0.2, chaos_truncate_rate=0.3),
                  dict(RS, resilience=True, rs_mode="oktopk"), dict(FLAGSHIP, resilience=True, fused=False),
                  dict(FLAGSHIP, resilience=True, payload_checksum=True, bucket_bytes=4096, decode_strategy="vmap")):
        assert port.DeepReduceConfig(**knobs) is not None and JConfig(**knobs) is not None


# -- the CLI ----------------------------------------------------------------- #


def test_cli_check_passes_its_four_checks(capsys):
    """`python -m deepreduce_tpu_torch.resilience check --device cpu
    --num_workers 8`, over 14 steps (the plan's drops fall at steps 5-8 and
    12-13)."""
    import json

    from deepreduce_tpu_torch.resilience.__main__ import main

    assert main(["--device", "cpu", "check", "--num_workers", "8", "--steps", "14"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and all(report["checks"].values()), report
    assert report["dropped_steps"] == 6.0 and report["live_workers_per_step"] == (14 * 8 - 6) / 14


@functools.lru_cache(maxsize=None)
def _jax_cli_run(steps):
    """The JAX CLI's FaultPlan-only training (no chaos), its initial MLP
    weights and its losses, on the 8-device CPU mesh."""
    import optax
    from jax.sharding import Mesh

    from deepreduce_tpu.resilience.__main__ import _build_cfg
    from deepreduce_tpu.train import Trainer

    import flax.linen as nn

    class _MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Dense(64)(x))
            x = nn.relu(nn.Dense(64)(x))
            return nn.Dense(8)(x)

    cfg = _build_cfg(resilience=True, fault_plan="2@1:3,0@4")
    trainer = Trainer(_MLP(), cfg, optax.sgd(0.1, momentum=0.9), shared_mesh(8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(512, 32)), jnp.float32)
    w_true = rng.normal(size=(32, 8))
    y = jnp.asarray(np.argmax(rng.normal(size=(512, 8)) * 0.1 + x @ w_true, axis=1), jnp.int32)
    state = trainer.init_state(jax.random.PRNGKey(0), (x[:64], y[:64]))
    params = {"/".join(str(p.key) for p in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    key = jax.random.PRNGKey(1)
    losses = []
    for step in range(steps):
        lo = (step * 64) % 448
        state, loss, _ = trainer.step(state, (x[lo : lo + 64], y[lo : lo + 64]), jax.random.fold_in(key, step))
        losses.append(float(loss))
    return params, losses


def test_cli_training_follows_jax_under_a_fault_plan():
    """The CLI's training with JAX's initial MLP weights carried across,
    under a FaultPlan alone, 6 steps on 8 workers: every loss within 1e-5
    relative of JAX's. Not bitwise: the 8 workers' float32 losses, gradients
    and momentum updates round in other orders in XLA's fused programs."""
    from deepreduce_tpu_torch.resilience.__main__ import build_cfg, run_train

    params, jlosses = _jax_cli_run(6)
    losses, summary = run_train(build_cfg(resilience=True, fault_plan="2@1:3,0@4"), steps=6, num_workers=8,
                                device="cpu", params=params)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    assert summary["dropped_steps"] == 3.0


def test_masked_quantized_own_counts_a_repeated_pick_twice_as_jax(monkeypatch):
    """A fault of the reference, mirrored: the masked quantized route adds
    this worker's dequantized value once per gathered index, and a dropped
    worker's row (which owns nothing) picks indices 0..K2-1 with value 0,
    so where a live worker picked one of them too the own-transmitted
    estimate is doubled (JAX's `.at[gi].add(my_deq[gi])`,
    `deepreduce_tpu/sparse_rs.py:1052`), and the residual loses that mass
    twice. The port equals JAX here (test_masked_sparse_rs_route_matches_jax)."""
    import threading

    W = 4
    rng = np.random.default_rng(3)
    flat_w = [_grid(rng) for _ in range(W)]
    seen = {}
    phase2, dequantize = sparse_rs._masked_phase2, sparse_rs.qar.bucket_dequantize

    def phase2_spy(est, owned, coll, K2, mask_f):
        gi, dense = phase2(est, owned, coll, K2, mask_f)
        seen[(threading.get_ident(), "gi")] = gi
        return gi, dense

    def dequantize_spy(levels, norms, q, block):
        out = dequantize(levels, norms, q, block)
        seen[(threading.get_ident(), "deq")] = out  # the last call is this worker's own levels
        return out

    monkeypatch.setattr(sparse_rs, "_masked_phase2", phase2_spy)
    monkeypatch.setattr(sparse_rs.qar, "bucket_dequantize", dequantize_spy)

    def work(coll, flat, u):
        _, own, _ = sparse_rs.exchange(_t(flat), coll, ratio=RATIO, rs_mode="quantized", block_size=BLOCK,
                                       stream=(5, 0), uniforms=u, mask=_t(np.array([True, True, False, True])))
        me = threading.get_ident()
        return own, seen[(me, "gi")], seen[(me, "deq")]

    own, gi, deq = port.InProcessGroup(W).run(work, flat_w, _jax_uniforms("quantized", jax.random.PRNGKey(21), W))[0]
    idx, counts = torch.unique(gi, return_counts=True)
    twice = idx[(counts > 1) & (deq[idx] != 0)]
    assert len(twice) > 0
    np.testing.assert_array_equal(own[twice].numpy(), (2 * deq[twice]).numpy())


def test_cli_sweep_prints_a_row_a_cell(capsys):
    """`sweep` over a 2 x 2 grid of drop and corrupt rates, 2 workers, 3
    steps: one JSON row a cell, finite losses, and a closing summary."""
    import json

    from deepreduce_tpu_torch.resilience.__main__ import main

    assert main(["--device", "cpu", "sweep", "--num_workers", "2", "--steps", "3", "--drop_rates", "0.0,0.5",
                 "--corrupt_rates", "0.0,0.5"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert rows[-1] == {"ok": True, "cells": 4}
    cells = rows[:-1]
    assert [(r["drop_rate"], r["chaos_corrupt_rate"]) for r in cells] == [(0.0, 0.0), (0.0, 0.5), (0.5, 0.0),
                                                                          (0.5, 0.5)]
    assert all(r["losses_finite"] for r in cells) and cells[0]["checksum_failures"] == 0.0


def test_launch_counts_survive_concurrent_workers():
    """In-process workers launch kernels from several threads, and a launch
    releases the interpreter lock: 16 threads counting 500 launches each
    lose no count (the count is added after the launch returns, under a
    lock; `launches += launch()` read the count before the launch)."""
    import threading
    import time

    from deepreduce_tpu_torch.ops.qsgd_kernel import count_launches

    class Wrapper:
        launches = 0

    def launch():
        time.sleep(0)  # as a ctypes launch does, let another thread run
        return 1

    def work():
        for _ in range(500):
            count_launches(Wrapper, launch())

    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert Wrapper.launches == 16 * 500
