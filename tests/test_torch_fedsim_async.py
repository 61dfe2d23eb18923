"""Port parity for the asynchronous (FedBuff-style) and multi-tenant ticks
of `fedsim.FedSim` against the JAX package on a one-device CPU mesh, given
JAX's draws (the cohort, churn, chaos and the staleness levels): the
parameters, `w_ref`, the bank and every field of the `AsyncBuffer` (its
`w_hist` ring of depth 3 included) within JAX's rtol 1e-5, atol 1e-6, the
counts, histograms and wire bytes exactly. Then the port against itself:
the exact degeneracies (K = cohort, zero latency and alpha 0 is the
synchronous round; one tenant is the single-tenant tick; `stream` is the
`step` loop), one all_reduce a tick with the JAX package's operand-byte
laws, the latency stream against its probabilities, mid-buffer and
mid-fill checkpoints, and tenants leaving and rejoining."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fedsim import (
    ASYNC,
    BASE,
    BATCH,
    C,
    CHURN,
    DIM,
    LOCAL,
    LR,
    JaxRun,
    assert_close,
    assert_metrics,
    assert_state,
    assert_tree_close,
    loss_fn,
    params0,
)

from deepreduce_tpu.fedsim.round import draw_latency as jdraw_latency
from deepreduce_tpu_torch import checkpoint, collectives
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.fedsim import FedSim, synthetic_linear_problem
from deepreduce_tpu_torch.fedsim import __main__ as cli
from deepreduce_tpu_torch.fedsim.round import draw_latency
from deepreduce_tpu_torch.weights import multitenant_state_from_jax

MT = dict(fed_tenants=2, fed_mt_k="17,5", fed_mt_alpha="0.5,0", fed_mt_latency="0.5,0.3,0.2;0.6,0.4",
          fed_mt_cohort="8,4")


def assert_buffer(buf, jbuf, what):
    assert_tree_close(buf.delta_sum, jbuf.delta_sum, f"{what} delta_sum")
    for f in ("weight", "count", "k", "version", "stale_sum", "stale_max", "pending"):
        assert_close(getattr(buf, f), np.asarray(getattr(jbuf, f)), f"{what} {f}")
    assert (buf.hist is None) == (jbuf.hist is None)
    if buf.hist is not None:
        assert_tree_close(buf.hist, jbuf.hist, f"{what} hist")


def _sim(knobs, **kw):
    cfg = DeepReduceConfig(**knobs)
    _, data_fn, _ = synthetic_linear_problem(DIM, BATCH, LOCAL, device="cpu")
    return FedSim(loss_fn, cfg, cfg.fed_config(), LR, data_fn, client_chunk=kw.pop("chunk", 2), device="cpu", **kw)


def _bitwise(a, b):
    return cli._equal(a, b)


@pytest.fixture(scope="module")
def async_run():
    return JaxRun({**BASE, **CHURN, **ASYNC}, 6)


@pytest.fixture(scope="module")
def mt_run():
    return JaxRun({**BASE, **CHURN, **ASYNC, **MT}, 4)


def test_async_ticks_match_jax_given_its_draws(async_run):
    """Six churn + chaos ticks at K = 2.2 cohorts, alpha 0.5 and latency
    "0.5,0.3,0.2": the buffer fills across ticks, applies, and pays the
    broadcast after an apply."""
    ps = async_run.sim()
    st = ps.init(params0())
    applied = 0.0
    for r in range(async_run.rounds):
        st, m = ps.step(st, r)
        assert_metrics(m, async_run.metrics[r], r)
        assert_state(st, async_run.states[r], r)
        assert_buffer(st.buffer, async_run.states[r].buffer, f"tick {r}")
        applied += float(m["applied"])
    assert applied >= 1 and any(float(x["staleness_mean"]) > 0 for x in async_run.metrics)


def test_multitenant_ticks_match_jax_given_its_draws(mt_run):
    """Two heterogeneous tenants (K 17 and 5, alpha 0.5 and 0, latency depth
    3 and 2 padded to 3, cohorts 8 and 4) through the one tick."""
    rows = mt_run.js.mt_latency
    draws = mt_run.draws(taus=lambda r, t: np.asarray(jdraw_latency(mt_run.round_key(r, t),
                                                                    jnp.asarray(rows[t], jnp.float32), C)))
    ps = mt_run.sim(draws=draws)
    st = ps.init(params0())
    for r in range(mt_run.rounds):
        st, m = ps.step(st, r)
        assert_metrics(m, mt_run.metrics[r], r)
        jst = mt_run.states[r]
        assert_state(st, jst, r)
        assert_buffer(st.buffer, jst.buffer, f"tick {r}")
        assert st.round == tuple(np.asarray(jst.round).tolist()) and st.tick == int(jst.tick)
    carried = multitenant_state_from_jax(mt_run.states[-1])
    assert _bitwise(carried, multitenant_state_from_jax(mt_run.states[-1]))
    assert carried.round == st.round and carried.alpha == (0.5, 0.0)


def test_async_at_k_cohort_zero_latency_alpha_zero_is_bitwise_sync():
    """No churn: every tick applies, so params, w_ref and the bank follow
    the synchronous rounds bit for bit."""
    sync = _sim({**BASE})
    asyn = _sim({**BASE, "fed_async": True, "fed_async_k": C})
    s0, a0 = sync.init(params0()), asyn.init(params0())
    for r in range(3):
        s0, ms = sync.step(s0, r)
        a0, ma = asyn.step(a0, r)
        assert float(ma["applied"]) == 1.0
        for k in ("clients", "uplink_bytes", "downlink_bytes", "rel_volume"):
            assert torch.equal(ms[k], ma[k]), k
    for n in s0.params:
        assert torch.equal(s0.params[n], a0.params[n]) and torch.equal(s0.w_ref[n], a0.w_ref[n])
        assert torch.equal(s0.residuals[n], a0.residuals[n])


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_one_tenant_is_bitwise_the_single_tenant_driver(asynchronous):
    knobs = {**BASE, **CHURN, **(ASYNC if asynchronous else {})}
    one, mt = _sim(knobs), _sim({**knobs, "fed_tenants": 1})
    s1, sm = one.init(params0()), mt.init(params0())
    for r in range(3):
        s1, m1 = one.step(s1, r)
        sm, mm = mt.step(sm, r)
        for k in m1:
            assert torch.equal(m1[k], mm[k][0]), k
    for n in s1.params:
        assert torch.equal(s1.params[n], sm.params[n][0]) and torch.equal(s1.residuals[n], sm.residuals[n][0])
    if asynchronous:
        for n in s1.buffer.delta_sum:
            assert torch.equal(s1.buffer.delta_sum[n], sm.buffer.delta_sum[n][0])
            assert torch.equal(s1.buffer.hist[n], sm.buffer.hist[n][0])


@pytest.mark.parametrize("mt", [False, True], ids=["single", "tenants"])
def test_stream_is_bitwise_the_step_loop(mt):
    from deepreduce_tpu_torch.resilience import stream

    knobs = {**BASE, **CHURN, **ASYNC, **(MT if mt else {})}
    a, b = _sim(knobs), _sim(knobs)
    sa, sb = a.init(params0()), b.init(params0())
    sa, hist, _ = a.stream(sa, 7, 4)
    for r in range(4):
        sb, mb = b.step(sb, stream.key(7, r))
        assert all(torch.equal(hist[r][k], mb[k]) for k in mb)
    assert _bitwise(sa, sb)


@pytest.mark.parametrize("knobs,law", [
    (ASYNC, lambda n, T, D: 4 * (n + 7 + D)),
    ({**ASYNC, **MT}, lambda n, T, D: 4 * T * (n + 7 + D)),
    ({**ASYNC, "pop_spec": '{"classes": [{"name": "a", "latency": "0.2,0.8"}, {"name": "b", "weight": 3.0}]}'},
     lambda n, T, D: 4 * (n + 7 + D + 2 + D)),
], ids=["async", "tenants", "class-latency"])
def test_one_all_reduce_a_tick_with_the_byte_law(knobs, law):
    """Async 4(n+7+D); per-class latency rows add the K-class histogram and
    the transmit histogram, 4(n+7+D+K+D); T tenants 4T(n+7+D): every
    tenant's wire scalars are reduced, where the JAX package's vmap leaves
    the tenant-invariant ones unbatched, 4(T(n+3+D)+4)."""
    ps = _sim({**BASE, **CHURN, **knobs})
    st = ps.init(params0())
    collectives.reset_reduce_counts()
    for r in range(3):
        st, _ = ps.step(st, r)
    T = max(ps.tenants, 1)
    assert collectives.reduce_counts() == {"all_reduce": 3, "all_reduce_bytes": 3 * law(DIM + 1, T, 3)}


def test_latency_stream_holds_its_probabilities():
    """200 ticks of 512 positions: each level's frequency within a binomial
    5-sigma bound of its probability, the draw independent of the tick."""
    probs = (0.5, 0.3, 0.2)
    n = 200 * 512
    taus = torch.cat([draw_latency(r, probs, 512, device="cpu") for r in range(200)])
    for d, p in enumerate(probs):
        assert abs(float((taus == d).float().mean()) - p) <= 5 * np.sqrt(p * (1 - p) / n), d
    assert not torch.equal(draw_latency(0, probs, 512, device="cpu"), draw_latency(1, probs, 512, device="cpu"))
    assert torch.equal(draw_latency(3, (1.0,), 16, device="cpu"), torch.zeros(16, dtype=torch.int64))
    padded = torch.tensor([0.5, 0.5, 0.0, 0.0])
    assert torch.equal(draw_latency(5, padded, 64, device="cpu"), draw_latency(5, (0.5, 0.5), 64, device="cpu"))


def test_mid_buffer_checkpoint_resumes_bitwise(tmp_path):
    knobs = {**BASE, **CHURN, **ASYNC}
    cfg = DeepReduceConfig(**knobs)
    ps = _sim(knobs)
    st = ps.init(params0())
    saved = None
    for r in range(6):
        st, _ = ps.step(st, r)
        if saved is None and float(st.buffer.count) > 0 and float(st.buffer.stale_sum) > 0:
            saved = r + 1
            checkpoint.save(str(tmp_path / "ck"), st, config=cfg)
    assert saved is not None and saved < 6
    ps2 = _sim(knobs)
    st2 = checkpoint.restore(str(tmp_path / "ck"), ps2.init(params0()), config=cfg)
    assert float(st2.buffer.count) > 0
    for r in range(saved, 6):
        st2, _ = ps2.step(st2, r)
    assert _bitwise(st, st2)


def test_tenants_leave_and_rejoin_and_resume_bitwise(tmp_path):
    """Tenant 1 leaves for two ticks (its state and round counter frozen,
    its metrics zero) and rejoins; a mid-fill checkpoint resumes bitwise
    under the same mask schedule; a restore under another tenant count
    fails fast."""
    knobs = {**BASE, **CHURN, **ASYNC, **MT}
    cfg = DeepReduceConfig(**knobs)
    ps = _sim(knobs)
    st = ps.init(params0())
    masks = [(True, True), (True, True), (True, False), (True, False), (True, True), (True, True)]
    frozen = None
    for r, mask in enumerate(masks):
        st = ps.set_active(st, mask)
        if not mask[1] and frozen is None:
            frozen = ({n: p[1].clone() for n, p in st.params.items()}, st.round[1])
        st, m = ps.step(st, r)
        if not mask[1]:
            assert all(torch.equal(st.params[n][1], frozen[0][n]) for n in frozen[0]) and st.round[1] == frozen[1]
            assert float(m["clients"][1]) == 0.0
        if r == 1:
            checkpoint.save(str(tmp_path / "ck"), st, config=cfg)
    assert st.round == (6, 4) and st.tick == 6
    ps2 = _sim(knobs)
    template = ps2.init(params0())
    st2 = checkpoint.restore(str(tmp_path / "ck"), template, config=cfg)
    for r in range(2, 6):
        st2 = ps2.set_active(st2, masks[r])
        st2, _ = ps2.step(st2, r)
    assert _bitwise(st, st2)
    bad = DeepReduceConfig(**{**knobs, "fed_tenants": 3, "fed_mt_k": "", "fed_mt_alpha": "", "fed_mt_latency": "",
                              "fed_mt_cohort": ""})
    with pytest.raises(ValueError, match="tenant-geometry"):
        checkpoint.restore(str(tmp_path / "ck"), template, config=bad)
