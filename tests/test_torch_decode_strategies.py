"""Port parity for the fused exchange's decode strategies (`loop`, `vmap`
at every `decode_batch`, `ring`), the unfused exchange (`fused=False`) and
the bucketed exchange, with and without the resilience seams (payload
checksums, chaos at the wire boundary, a participation mask that drops a
worker), against the JAX package's exchange on the CPU mesh at W in
{1, 3, 4}; the full-width payload bytes; and one real three-rank gloo ring.

Inputs sit on the grid 2**-6, so the QSGD norms agree bitwise with JAX's
float32 sums; given JAX's QSGD uniforms and its chaos draws, the
aggregates, residuals and checksum failure counts are bitwise equal,
whichever order each strategy sums in (loop: worker order; vmap: groups of
`decode_batch` rows summed in order, then added; ring: own, me - 1, ...).
One JAX compile per (W, config) is shared through a module-scoped cache."""

import functools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import shared_mesh
from jax.sharding import PartitionSpec as P
from test_torch_bucketed import FLAGSHIP, MIB4, _bucket_uniforms, _grid, _model_shapes
from test_torch_resilience import _jax_chaos_draws
from torch_ranks import run_rank

from deepreduce_tpu.comm import GradientExchanger as JExchanger
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.utils.compat import shard_map
import deepreduce_tpu_torch as port

SHAPES = {"emb": (3000,), "w1": (900,), "b1": (300,), "b3": (50,), "s": (2,)}
QSGD = dict(deepreduce="both", index="bloom", value="qsgd", policy="p0", compress_ratio=0.05, fpr=0.05,
            bloom_blocked="mod", min_compress_size=100, memory="residual", seed=7)
CHAOS = dict(resilience=True, payload_checksum=True, chaos_corrupt_rate=0.6, chaos_truncate_rate=0.3,
             chaos_drop_rate=0.2)
STEP = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(W, shapes=SHAPES):
    rng = np.random.default_rng(100 + W)
    grads = [{n: _grid(rng, s) for n, s in shapes.items()} for _ in range(W)]
    res = [{n: _grid(rng, s) for n, s in shapes.items()} for _ in range(W)]
    return grads, res


def _like(shapes=SHAPES):
    return {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _jax_exchange(W, knobs_items, masked):
    """The JAX exchange on a W-device mesh, compiled once: a function of the
    mask (ignored unless `masked`) giving every worker's aggregate,
    residuals and checksum failures, and the exchanger."""
    knobs = dict(knobs_items)
    jex = JExchanger(_like(), JConfig(**knobs), num_workers=W)

    def spmd(g, r, m):
        collect = {}
        agg, new_r, _ = jex.exchange({n: x[0] for n, x in g.items()}, {n: x[0] for n, x in r.items()}, step=STEP,
                                     collect=collect, mask=m if masked else None)
        fails = collect.get("checksum_failures", jnp.zeros((), jnp.float32))
        return {n: x[None] for n, x in agg.items()}, {n: x[None] for n, x in new_r.items()}, fails[None]

    fn = jax.jit(shard_map(spmd, mesh=shared_mesh(W), in_specs=(P("data"), P("data"), P()),
                           out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    grads, res = _inputs(W)
    stack = lambda trees: {n: jnp.stack([jnp.asarray(t[n]) for t in trees]) for n in SHAPES}
    return (lambda mask: fn(stack(grads), stack(res), jnp.asarray(mask))), jex


def _qsgd_uniforms(jex, W, seed):
    """The QSGD draws JAX's codecs make at STEP on each worker, by tensor (or
    bucket label)."""
    if jex._bucketed is not None:
        return _bucket_uniforms(jex, W, seed, jex._bucketed.codecs)
    out = []
    for w in range(W):
        keys = jex._keys(jax.random.fold_in(jax.random.PRNGKey(seed), w), jnp.asarray(STEP, jnp.int32))
        out.append({n: _t(jax.random.uniform(keys[n], (c.val_codec.meta.num_buckets * c.val_codec.meta.bucket_size,)))
                    for n, c in jex.codecs.items() if c.val_codec is not None})
    return out


def _chaos_draws(jex, W):
    """JAX's chaos draws on each worker, by salt (the bucket index; 0 for
    the fused buffer)."""
    if jex._chaos is None:
        return [None] * W
    if jex._bucketed is not None:
        sizes = [jex._bucketed.layouts[s.label].nbytes for s in jex._bucketed.specs]
    else:
        sizes = [jex._fused_nbytes]
    return [{b: _jax_chaos_draws(jex._chaos, B, STEP, w, b) for b, B in enumerate(sizes)} for w in range(W)]


def _port_exchange(W, knobs, mask, jex):
    cfg = port.DeepReduceConfig(**knobs)
    grads, res = _inputs(W)

    def work(coll, g, r, u, cd):
        ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll if W > 1 else None)
        collect = {}
        agg, new_r, _ = ex.exchange({n: _t(x) for n, x in g.items()}, {n: _t(x) for n, x in r.items()}, step=STEP,
                                    uniforms=u, collect=collect, chaos_draws=cd,
                                    mask=None if mask is None else _t(mask))
        return agg, new_r, collect.get("checksum_failures"), ex.payload_bytes()

    return port.InProcessGroup(W).run(work, grads, res, _qsgd_uniforms(jex, W, knobs["seed"]), _chaos_draws(jex, W))


def _check(W, knobs, mask):
    run, jex = _jax_exchange(W, tuple(sorted(knobs.items())), mask is not None)
    jagg, jres, jfails = run(np.ones(W, bool) if mask is None else mask)
    out = _port_exchange(W, knobs, mask, jex)
    fails = []
    for r, (agg, new_r, f, nbytes) in enumerate(out):
        for n in SHAPES:
            np.testing.assert_array_equal(agg[n].numpy(), np.asarray(jagg[n][r]), err_msg=f"agg {r} {n}")
            np.testing.assert_array_equal(new_r[n].numpy(), np.asarray(jres[n][r]), err_msg=f"residual {r} {n}")
            assert np.isfinite(agg[n].numpy()).all() and np.isfinite(new_r[n].numpy()).all()
        if knobs.get("payload_checksum"):
            assert float(f) == float(jfails[r])
            fails.append(float(f))
        assert nbytes == jex.payload_bytes(_like())
    return out, fails


def _drop_last(W):
    mask = np.ones(W, bool)
    mask[W - 1] = False
    return mask


STRATEGIES = {"loop": {}, "ring": dict(decode_strategy="ring")}
STRATEGIES.update({f"vmap{b}": dict(decode_strategy="vmap", decode_batch=b) for b in (1, 2, 3, 4)})
# (W, strategy, variant): plain = no resilience; chaos = checksum + chaos;
# masked = checksum + chaos + the last worker dropped
CASES = [
    (1, "vmap1", "plain"), (1, "ring", "plain"), (1, "loop", "masked"), (1, "ring", "masked"),
    (3, "vmap2", "plain"), (3, "ring", "plain"), (3, "loop", "chaos"), (3, "loop", "masked"),
    (3, "vmap3", "masked"), (3, "ring", "masked"),
    (4, "vmap1", "plain"), (4, "vmap2", "plain"), (4, "vmap3", "plain"), (4, "vmap4", "plain"),
    (4, "ring", "plain"), (4, "loop", "masked"), (4, "vmap2", "masked"), (4, "vmap4", "masked"),
    (4, "ring", "masked"),
]


@pytest.mark.parametrize("W,strategy,variant", CASES, ids=[f"W{w}-{s}-{v}" for w, s, v in CASES])
def test_exchange_bitwise_matches_jax(W, strategy, variant):
    knobs = dict(QSGD, **STRATEGIES[strategy], **({} if variant == "plain" else CHAOS))
    mask = _drop_last(W) if variant == "masked" else None
    out, fails = _check(W, knobs, mask)
    if mask is not None:
        dropped = out[W - 1][1]
        for n in SHAPES:
            # the dropped worker's own decode is zero: its residual keeps
            # its compensated gradient
            g, r = _inputs(W)
            np.testing.assert_array_equal(dropped[n].numpy(), g[W - 1][n] + r[W - 1][n])
    if variant != "plain":
        assert len(set(fails)) == 1  # every worker counts the same failures


def test_chaos_cases_fire():
    """The injected chaos of the cases above is not idle: some payload of
    the W = 4 masked exchange fails its checksum (a dropped row's failures
    are not counted)."""
    run, jex = _jax_exchange(4, tuple(sorted(dict(QSGD, **CHAOS).items())), True)
    assert float(run(_drop_last(4))[2][0]) > 0
    draws = _chaos_draws(jex, 4)
    assert any(d[0][k] for d in draws for k in ("corrupt", "truncate", "drop"))


@pytest.mark.parametrize("masked", [False, True])
def test_unfused_exchange_matches_jax(masked):
    """`fused=False`: one all_gather per tensor, the own decode outside the
    loop; at W = 3 with and without the last worker dropped."""
    knobs = dict(QSGD, fused=False, **(dict(resilience=True) if masked else {}))
    _check(3, knobs, _drop_last(3) if masked else None)


def test_bucketed_resilient_vmap_matches_jax():
    """The bucketed exchange with checksum, chaos salted by bucket, the last
    worker dropped and the vmap decode, at W = 3."""
    knobs = dict(QSGD, **CHAOS, bucket_bytes=4800, decode_strategy="vmap", decode_batch=2)
    _check(3, knobs, _drop_last(3))


@pytest.mark.parametrize("strategy", ["loop", "vmap2", "ring"])
def test_resilience_on_nothing_firing_is_the_plain_step(strategy):
    """Resilience on with the checksum and no fault: the aggregate and the
    residuals bitwise the resilience-off exchange's, no failure counted."""
    W = 3
    plain = dict(QSGD, **STRATEGIES[strategy])
    run, jex = _jax_exchange(W, tuple(sorted(plain.items())), False)
    base = _port_exchange(W, plain, None, jex)
    on = _port_exchange(W, dict(plain, resilience=True, payload_checksum=True), None, jex)
    for (a0, r0, _, b0), (a1, r1, f1, b1) in zip(base, on):
        assert all(torch.equal(a0[n], a1[n]) and torch.equal(r0[n], r1[n]) for n in SHAPES)
        assert float(f1) == 0.0 and b1 == b0 + (4 * len(SHAPES) * (1 if strategy != "ring" else W - 1))


@pytest.mark.parametrize("variant", ["fused", "bucketed", "ring4", "unfused"])
def test_full_width_payload_bytes_match_jax(variant):
    """The full-width WordLSTM flagship with the checksum: fused (1,189,616 B
    + 4 B a tensor), bucketed at 4 MiB, the ring at W = 4 ((W - 1) B) and
    unfused, each JAX's `payload_bytes`."""
    jn, shapes = _model_shapes("wordlstm")
    knobs = dict(FLAGSHIP, resilience=True, payload_checksum=variant != "unfused")
    W = 1
    if variant == "bucketed":
        knobs["bucket_bytes"] = MIB4
    elif variant == "ring4":
        knobs["decode_strategy"], W = "ring", 4
    elif variant == "unfused":
        knobs["fused"] = False
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in jn.items()}
    jex = JExchanger(like, JConfig(**knobs), num_workers=W)
    group = port.InProcessGroup(W).member(0) if W > 1 else None
    tex = port.GradientExchanger(shapes, port.DeepReduceConfig(**knobs), device="cpu", group=group)
    assert tex.payload_bytes() == jex.payload_bytes(like)
    if variant == "fused":
        assert tex.payload_bytes() == 1_189_616 + 4 * len(shapes)
    if variant == "ring4":
        assert tex.payload_bytes() == 3 * (1_189_616 + 4 * len(shapes))


def test_three_rank_gloo_ring_equals_in_process_ring(tmp_path):
    """Three processes run the ring decode over gloo (`batch_isend_irecv`
    hops): each rank's aggregate and residuals bitwise the in-process
    group's, with and without the checksum and a mask."""
    world = 3
    shapes = {"a": (1200,), "b": (300,), "c": (40,)}
    arms = [("ring", dict(QSGD, decode_strategy="ring"), STEP),
            ("ring_checksum", dict(QSGD, decode_strategy="ring", resilience=True, payload_checksum=True,
                                   chaos_corrupt_rate=0.5), STEP + 1)]
    rng = np.random.default_rng(17)
    inputs = {arm: [({n: _t(_grid(rng, s)) for n, s in shapes.items()},
                     {n: _t(_grid(rng, s)) for n, s in shapes.items()}) for _ in range(world)] for arm, _, _ in arms}
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=run_rank, args=(r, world, store, outs[r], arms, shapes, inputs)) for r in range(world)]
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
    for arm, knobs, st in arms:
        cfg = port.DeepReduceConfig(**knobs)

        def work(coll, g, r, cfg=cfg, st=st):
            ex = port.GradientExchanger(shapes, cfg, device="cpu", group=coll)
            return ex.exchange(g, r, step=st)[:2]

        want = port.InProcessGroup(world).run(work, *zip(*inputs[arm]))
        for r in range(world):
            for n in shapes:
                assert torch.equal(got[r][arm][0][n], want[r][0][n]), (arm, r, n)
                assert torch.equal(got[r][arm][1][n], want[r][1][n]), (arm, r, n)


def test_ring_vs_loop_within_the_reordering_bound():
    """The ring sums in ring order, the loop in worker order: on inputs off
    the grid the aggregates differ by at most 2 (W - 1) W 2**-24 M
    elementwise, M the largest |compensated| + |new residual| (a bound on
    every row's decode), and the residuals are bitwise equal (each worker's
    own decode is the same). chip_smoke phase 16 holds the card to this
    bound."""
    W = 4
    rng = np.random.default_rng(31)
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()} for _ in range(W)]
    res = [{n: (rng.normal(size=s) * 0.1).astype(np.float32) for n, s in SHAPES.items()} for _ in range(W)]
    out = {}
    for strategy in ("loop", "ring"):
        # at ratio 0.5 three live rows share many positions: the order shows
        cfg = port.DeepReduceConfig(**dict(QSGD, compress_ratio=0.5), **STRATEGIES[strategy], resilience=True,
                                    payload_checksum=True)

        def work(coll, g, r, cfg=cfg):
            ex = port.GradientExchanger(SHAPES, cfg, device="cpu", group=coll)
            return ex.exchange({n: _t(x) for n, x in g.items()}, {n: _t(x) for n, x in r.items()}, step=STEP,
                               mask=_t(_drop_last(W)))[:2]

        out[strategy] = port.InProcessGroup(W).run(work, grads, res)
    m = max(float(np.abs(grads[w][n] + res[w][n]).max() + out["loop"][w][1][n].abs().max())
            for w in range(W) for n in SHAPES)
    bound = 2 * (W - 1) * W * 2.0**-24 * m
    differs = False
    for w in range(W):
        for n in SHAPES:
            assert torch.equal(out["ring"][w][1][n], out["loop"][w][1][n])
            err = float((out["ring"][w][0][n] - out["loop"][w][0][n]).abs().max())
            assert err <= bound, (w, n, err, bound)
            differs |= err > 0
    assert differs, "the two summation orders should differ somewhere off the grid"


def test_phase16_wire_constants_match_jax():
    """chip_smoke phase 16's payload bytes at W = 1 on the full-width
    WordLSTM, each the JAX package's `payload_bytes` for the arm's config."""
    import dataclasses

    import chip_smoke

    jn, _ = _model_shapes("wordlstm")
    like = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in jn.items()}
    for arm in ("drqsgd_bloom_checksum", "drqsgd_bloom_ring", "drqsgd_bloom_unfused", "rs_quantized_masked",
                "rs_sparse_masked", "rs_oktopk_masked"):
        knobs, _ = chip_smoke.PHASE16[arm]
        cfg = dataclasses.asdict(chip_smoke._flagship_cfg(0, **knobs))
        assert JExchanger(like, JConfig(**cfg), num_workers=1).payload_bytes(like) == chip_smoke.PAYLOAD16[arm], arm
