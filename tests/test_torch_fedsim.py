"""Port parity for the population-scale federated simulator
(`fedsim.FedSim`, the batched cohort of `fedsim.round`) against the JAX
package's `FedSim` on a one-device (and a two-device) CPU mesh.

The JAX package draws with `jax.random`; the port's own draws come from its
counter-based streams. Given JAX's draws (`FedDraws`: the cohort, churn,
chaos events and byte draws, latency; the clients' batches through the
data function), the port's rounds follow JAX's: parameters, `w_ref` and the
residual bank within JAX's own rtol 1e-5, atol 1e-6 (local training sums in
another order than XLA), and the wire accounting, live counts and checksum
failures exactly. The port's streams are held to their distributions.

Small sizes throughout: a population of 64, a cohort of 8, dimension 16,
two local steps; the codec is the JAX CLI check's top-k 25% with a
mod-blocked bloom index and per-client residuals. One JAX build a
configuration, shared through module-scoped fixtures."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from conftest import shared_mesh

from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.config import DeepReduceConfig as JConfig
from deepreduce_tpu.fedsim import FedSim as JFedSim
from deepreduce_tpu.fedsim import synthetic_linear_problem as jlinear
from deepreduce_tpu.fedsim.round import draw_latency as jdraw_latency
from deepreduce_tpu.resilience import chaos as jchaos
from deepreduce_tpu.resilience import faults as jfaults
import deepreduce_tpu_torch as port
from deepreduce_tpu_torch import checkpoint, collectives
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.fedsim import FedDraws, FedSim, synthetic_linear_problem
from deepreduce_tpu_torch.fedsim import __main__ as cli
from deepreduce_tpu_torch.fedsim.round import cohort_updates, make_client_step
from deepreduce_tpu_torch.weights import fedsim_state_from_jax
from torch_ranks import run_fedsim_rank

DIM, BATCH, LOCAL, N, C, LR = 16, 4, 2, 64, 8, 0.1
RTOL, ATOL = 1e-5, 1e-6
BASE = dict(deepreduce="index", index="bloom", bloom_blocked="mod", compress_ratio=0.25, fpr=0.01,
            memory="residual", min_compress_size=8, fed=True, fed_num_clients=N, fed_clients_per_round=C,
            fed_local_steps=LOCAL)
CHURN = dict(resilience=True, fault_plan="3@1,5@2:4", drop_rate=0.05, payload_checksum=True, chaos_corrupt_rate=0.2)
ASYNC = dict(fed_async=True, fed_async_k=int(2.2 * C), fed_async_alpha=0.5, fed_async_latency="0.5,0.3,0.2")


def _t(a):
    return torch.from_numpy(np.array(a))


def loss_fn(p, b):
    x, y = b
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def params0():
    return {"b": torch.zeros(()), "w": torch.zeros(DIM)}


class JaxRun:
    """A JAX `FedSim` run of `rounds` steps under `PRNGKey(seed)` (tick r's
    key `fold_in(key, r)`), its states and metrics on the host, and the
    draws it made, as the port's `FedDraws` and data function take them."""

    def __init__(self, knobs, rounds, *, W=1, seed=0, chunk=2, stream_ticks=False):
        self.knobs, self.W, self.rounds = knobs, W, rounds
        self.jcfg = JConfig(**knobs)
        self.fed = self.jcfg.fed_config()
        self.key = jax.random.PRNGKey(seed)
        p0, self.jdata, jloss = jlinear(DIM, BATCH, LOCAL)
        mesh = None if W == 1 else shared_mesh(W)
        self.js = JFedSim(jloss, self.jcfg, self.fed, optax.sgd(LR), self.jdata, mesh=mesh, client_chunk=chunk)
        st = self.js.init(p0)
        self.init = jax.device_get(st)
        self.states, self.metrics = [], []
        for r in range(rounds):
            st, m = self.js.step(st, jax.random.fold_in(self.key, r))
            self.states.append(jax.device_get(st))
            self.metrics.append({k: np.asarray(v) for k, v in m.items()})
        self.inj = jchaos.ChaosInjector.from_config(self.jcfg)
        self.nbytes = None if self.js._layout is None else self.js._layout.nbytes
        self.n_local, self.c_local = N // W, C // W
        self._batch = jax.jit(jax.vmap(lambda g, k: self.jdata(g, 0, k)))

    def round_key(self, r, t=0):
        k = jax.random.fold_in(self.key, r)
        return k if t == 0 else jax.random.fold_in(k, t)

    def split(self, r, t=0):
        return jax.random.split(self.round_key(r, t), 5)

    def cohort(self, r, w, t=0):
        return np.asarray(jax.random.choice(jax.random.fold_in(self.split(r, t)[2], w), self.n_local,
                                            (self.c_local,), replace=False))

    def participation(self, r, t=0):
        cfg = self.jcfg
        return np.asarray(jfaults.participation_mask(C, r, self.split(r, t)[3], drop_rate=cfg.drop_rate,
                                                     fault_plan=cfg.fault_plan))

    def chaos(self, r, t=0):
        out = {}
        for pos in range(C):
            k = jax.random.PRNGKey(self.inj.seed)
            for word in (jchaos._CHAOS_TAG, 0, jnp.asarray(r, jnp.uint32), pos):
                k = jax.random.fold_in(k, word)
            kd, kc, kt, ksel, kb = jax.random.split(k, 5)
            out[pos] = {"corrupt": bool(jax.random.bernoulli(kc, self.inj.corrupt_rate)), "truncate": False,
                        "drop": False, "sel": _t(jax.random.bernoulli(ksel, self.inj.corrupt_frac, (self.nbytes,))),
                        "noise": _t(jax.random.randint(kb, (self.nbytes,), 1, 256, jnp.uint8))}
        return out

    def taus(self, r, t=0, probs=None):
        probs = self.js.latency_probs if probs is None else probs
        return np.asarray(jdraw_latency(self.round_key(r, t), probs, C))

    def batches(self, gids, r, t=0):
        kd = self.split(r, t)[4]
        g = jnp.asarray(np.asarray(gids), jnp.int32)
        x, y = self._batch(g, jax.vmap(lambda i: jax.random.fold_in(kd, i))(g))
        return _t(x), _t(y)

    def draws(self, **extra):
        d = FedDraws(cohort=self.cohort, participation=self.participation if self.jcfg.resilience else None,
                     chaos=self.chaos if self.inj is not None else None,
                     taus=self.taus if self.jcfg.fed_async else None)
        return dataclasses.replace(d, **extra)

    def sim(self, *, impl="vmap", chunk=2, tenants=False, **kw):
        """A port FedSim on the same config, drawing JAX's draws; its data
        function maps the port's data key back to JAX's round (and tenant)."""
        cfg = DeepReduceConfig(**self.knobs)
        box = {}

        def data_fn(gids, rnd, key):
            return self.batches(gids.tolist(), *box["keys"][key])

        ps = FedSim(loss_fn, cfg, self.fed, LR, data_fn, client_chunk=chunk, impl=impl, device="cpu",
                    draws=kw.pop("draws", None) or self.draws(), **kw)
        T = max(cfg.fed_tenants, 1)
        box["keys"] = {ps._keys(r, t)["data"]: (r, t) for r in range(self.rounds + 4) for t in range(T)}
        return ps


def assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def assert_tree_close(got, want, what):
    flat = {n: v for n, v in _flatten(want).items()}
    assert sorted(got) == sorted(flat), what
    for n, v in got.items():
        assert_close(v, flat[n], f"{what} {n}")


def _flatten(tree, prefix=""):
    if not hasattr(tree, "items"):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def assert_metrics(got, want, r):
    """Every metric of the round: the counts and wire bytes exactly, the
    rest within the tolerance."""
    assert sorted(got) == sorted(want), r
    for k, v in got.items():
        exact = k in ("clients", "checksum_failures", "uplink_bytes", "downlink_bytes", "staleness_hist",
                      "pop_hist", "applied", "version", "buffer_fill", "staleness_max")
        if exact:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=f"round {r} {k}")
        else:
            assert_close(v, want[k], f"round {r} {k}")


def assert_state(ps_state, jstate, r):
    assert_tree_close(ps_state.params, jstate.params, f"round {r} params")
    assert_tree_close(ps_state.w_ref, jstate.w_ref, f"round {r} w_ref")
    assert_tree_close(ps_state.residuals, jstate.residuals, f"round {r} bank")


@pytest.fixture(scope="module")
def sync_run():
    return JaxRun({**BASE, **CHURN}, 4)


@pytest.mark.parametrize("impl", ["vmap", "scan"])
def test_sync_rounds_match_jax_given_its_draws(sync_run, impl):
    """Four churn + chaos rounds under checksums: parameters, w_ref, the
    bank and every metric, round by round, batched and one by one."""
    ps = sync_run.sim(impl=impl)
    st = ps.init(params0())
    fails = 0.0
    for r in range(sync_run.rounds):
        st, m = ps.step(st, r)
        assert_metrics(m, sync_run.metrics[r], r)
        assert_state(st, sync_run.states[r], r)
        fails += float(m["checksum_failures"])
    assert fails > 0 and any(float(x["clients"]) < C for x in sync_run.metrics)


def test_batched_equals_scan_and_chunked_equals_flat(sync_run):
    """The batched cohort (chunk 2, and one block of 8) against the clients
    one by one, over four rounds of the port's own draws."""
    cfg = DeepReduceConfig(**BASE, **CHURN)
    fed = cfg.fed_config()
    _, data_fn, _ = synthetic_linear_problem(DIM, BATCH, LOCAL, device="cpu")
    runs = {}
    for impl, chunk in (("scan", 0), ("vmap", 2), ("vmap", 0)):
        ps = FedSim(loss_fn, cfg, fed, LR, data_fn, client_chunk=chunk, impl=impl, device="cpu")
        st = ps.init(params0())
        for r in range(4):
            st, _ = ps.step(st, 50 + r)
        runs[impl, chunk] = st
    for key in (("vmap", 2), ("vmap", 0)):
        for n in ("b", "w"):
            assert_close(runs[key].params[n], runs["scan", 0].params[n], f"{key} {n}")
            assert_close(runs[key].residuals[n], runs["scan", 0].residuals[n], f"{key} bank {n}")


def _given_outputs(C_, masked_nan=False):
    """A client body whose local training returns its batch, the tree of
    the linear problem, and C clients' (outputs, residuals)."""
    rng = np.random.default_rng(4)
    w_ref = {"b": torch.zeros(()), "w": torch.zeros(DIM)}
    outs = {"b": _t(rng.normal(size=C_).astype(np.float32)), "w": _t(rng.normal(size=(C_, DIM)).astype(np.float32))}
    if masked_nan:
        outs["w"][1, 3] = float("nan")
    res = {"b": _t(rng.normal(size=C_).astype(np.float32) / 8), "w": _t(rng.normal(size=(C_, DIM)).astype(np.float32) / 8)}
    return w_ref, outs, res


def test_all_alive_mask_is_bitwise_the_mask_free_round():
    cfg = DeepReduceConfig(**BASE)
    tc = port.TreeCodec("c2s", cfg, device="cpu")
    w_ref, outs, res = _given_outputs(C)
    got = []
    for part in (None, torch.ones(C)):
        bank = {n: r.clone() for n, r in res.items()}
        step = make_client_step(tc, lambda w, b: b, w_ref, 3)
        got.append(cohort_updates(step, outs, bank, list(range(C)), update_template=w_ref, participation=part,
                                  impl="vmap", chunk=4))
    (s0, b0, w0, l0), (s1, b1, w1, l1) = got
    for n in s0:
        assert torch.equal(s0[n], s1[n]) and torch.equal(b0[n], b1[n])
    assert all(torch.equal(a, b) for a, b in zip(w0, w1)) and torch.equal(l0, l1)


def test_chaos_round_is_the_clean_round_minus_its_failed_clients():
    """Under checksums and corruption, the update sum is the clean round's
    sum over the clients whose checksum held; the residuals advance from
    the clean decode for every client; the failed clients' wire counts."""
    cfg = DeepReduceConfig(**BASE, resilience=True, payload_checksum=True, chaos_corrupt_rate=0.5)
    tc = port.TreeCodec("c2s", cfg, device="cpu")
    w_ref, outs, res = _given_outputs(C)
    spec = tc.spec(w_ref)
    layout = port.comm.PayloadLayout(tc.payload_specs(spec), checksum=True)
    chaos = port.resilience.chaos.ChaosInjector.from_config(cfg)
    fired = [any(chaos.events(step=3, worker=p).values()) for p in range(C)]
    assert 0 < sum(fired) < C
    runs = {}
    for name, kw in (("chaos", dict(layout=layout, chaos=chaos)), ("clean", {})):
        bank = {n: r.clone() for n, r in res.items()}
        step = make_client_step(tc, lambda w, b: b, w_ref, 3, **kw)
        runs[name] = cohort_updates(step, outs, bank, list(range(C)), update_template=w_ref,
                                    checksum=name == "chaos", impl="vmap", chunk=4)
    cs, cb, cw, cl = runs["chaos"]
    # a fired corrupt event may select no byte: a failed client had an event
    failed = [bool(x == 0.0) for x in cl.numpy()]
    assert 0 < sum(failed) and all(f <= e for f, e in zip(failed, fired))
    # the clean round's per-client updates, summed over the live ones
    for n in cs:
        per_client = []
        for c in range(C):
            bank = {k: r[c : c + 1].clone() for k, r in res.items()}
            step = make_client_step(tc, lambda w, b: b, w_ref, 3)
            s, _, _, _ = cohort_updates(step, {k: o[c : c + 1] for k, o in outs.items()}, bank, [c],
                                        update_template=w_ref, impl="scan")
            per_client.append(s[n])
        want = sum(p for p, f in zip(per_client, failed) if not f)
        assert_close(cs[n], want, n)
        assert torch.equal(cb[n], runs["clean"][1][n]), n
    assert all(torch.equal(a, b) for a, b in zip(cw, runs["clean"][2]))


@pytest.mark.parametrize("extra,law", [
    ({}, lambda n, K, D: 4 * (n + 6)),
    (dict(pop_spec='{"classes": [{"name": "a"}, {"name": "b", "weight": 3.0}]}'), lambda n, K, D: 4 * (n + 6 + K)),
])
def test_one_all_reduce_a_round_with_the_byte_law(extra, law):
    cfg = DeepReduceConfig(**BASE, **CHURN, **extra)
    _, data_fn, _ = synthetic_linear_problem(DIM, BATCH, LOCAL, device="cpu")
    ps = FedSim(loss_fn, cfg, cfg.fed_config(), LR, data_fn, client_chunk=2, device="cpu")
    st = ps.init(params0())
    collectives.reset_reduce_counts()
    for r in range(3):
        st, _ = ps.step(st, r)
    K = ps.pop.num_classes if ps.pop is not None else 0
    assert collectives.reduce_counts() == {"all_reduce": 3, "all_reduce_bytes": 3 * law(DIM + 1, K, 1)}


def test_the_cohort_stream_samples_without_repeats_within_the_stratum():
    """Over 200 rounds of 4 workers: each worker's C/W ids distinct and in
    its stratum, and every client's sampling frequency C/N within a
    binomial 5-sigma bound."""
    cfg = DeepReduceConfig(**BASE)
    counts = np.zeros(N)
    for w in range(4):
        coll = collectives.InProcessGroup(4).member(w)
        ps = FedSim(loss_fn, cfg, cfg.fed_config(), LR, lambda *a: None, group=coll, device="cpu")
        for r in range(200):
            ids = ps._sample(r, ps._keys(r, 0), 0).numpy()
            assert len(set(ids.tolist())) == C // 4 and ids.min() >= 0 and ids.max() < N // 4
            counts[w * (N // 4) + ids] += 1
    p = C / N
    assert np.all(np.abs(counts / 200 - p) <= 5 * np.sqrt(p * (1 - p) / 200))


FENCES = [
    dict(fed_num_clients=10),
    dict(fed=True, fed_num_clients=0, fed_clients_per_round=2),
    dict(fed=True, fed_num_clients=4, fed_clients_per_round=0),
    dict(fed=True, fed_num_clients=4, fed_clients_per_round=8),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_local_steps=0),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_server_lr=0.0),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_client_chunk=-1),
    dict(fed=True, fed_num_clients=64, fed_clients_per_round=10, fed_client_chunk=3),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, hier=True),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, communicator="allreduce"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, bucket_bytes=4096),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, decode_strategy="vmap"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, bucket_bytes=4096, stream_exchange=True),
    dict(fed_async_k=4),
    dict(fed_async=True),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True, fed_async_k=2, fed_async_alpha=-1.0),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True, fed_async_k=2,
         fed_async_latency="0.5,x"),
    dict(fed_tenants=-1),
    dict(fed_mt_k="2"),
    dict(fed_tenants=2),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_tenants=2, fed_mt_alpha="0.5"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True, fed_async_k=2, fed_tenants=2,
         fed_mt_k="1,2,3"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True, fed_async_k=2, fed_tenants=2,
         fed_mt_alpha="-1"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_async=True, fed_async_k=2, fed_tenants=2,
         fed_mt_latency="0.5;"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_tenants=2, fed_mt_cohort="5"),
    dict(pop_labels=4),
    dict(pop_spec='{"classes": [{"name": "a"}]}'),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, fed_tenants=1,
         pop_spec='{"classes": [{"name": "a"}]}'),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, pop_labels=1, pop_spec='{"classes": [{"name": "a"}]}'),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4,
         pop_spec='{"classes": [{"name": "a", "latency": "0.5,0.5"}]}'),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, pop_spec='{"classes": [{"name": "a", "weight": 0}]}'),
    dict(slo_window=4),
    dict(slo_spec="slo.json"),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, slo_spec="slo.json", slo_window=-1),
    dict(fed=True, fed_num_clients=8, fed_clients_per_round=4, slo_spec="slo.json", slo_hysteresis=-2),
]


@pytest.mark.parametrize("knobs", FENCES, ids=range(len(FENCES)))
def test_fed_knob_rejections_carry_jax_reason_codes(knobs):
    with pytest.raises(JConfigError) as jerr:
        JConfig(**knobs)
    with pytest.raises(port.ConfigError) as perr:
        DeepReduceConfig(**knobs)
    assert perr.value.reason_code == jerr.value.reason_code


def test_fed_config_and_trainer_fence_match_jax():
    knobs = dict(fed=True, fed_num_clients=64, fed_clients_per_round=16, fed_local_steps=3, fed_server_lr=0.5)
    assert DeepReduceConfig(**knobs).fed_config() == port.FedConfig(64, 16, 3, 0.5)
    assert dataclasses.asdict(JConfig(**knobs).fed_config()) == dataclasses.asdict(DeepReduceConfig(**knobs).fed_config())
    with pytest.raises(port.ConfigError) as e:
        port.Trainer(torch.nn.Linear(2, 2), DeepReduceConfig(**knobs), lr=0.1, device="cpu")
    assert e.value.reason_code == "fed-vs-trainer"


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Save after round 2 of 4, restore into a fresh driver, replay: the
    state bitwise the uninterrupted run's (the port's own draws)."""
    cfg = DeepReduceConfig(**BASE, **CHURN)
    _, data_fn, _ = synthetic_linear_problem(DIM, BATCH, LOCAL, device="cpu")

    def sim():
        ps = FedSim(loss_fn, cfg, cfg.fed_config(), LR, data_fn, client_chunk=2, device="cpu")
        return ps, ps.init(params0())

    ps, st = sim()
    for r in range(4):
        st, _ = ps.step(st, r)
        if r == 1:
            checkpoint.save(str(tmp_path / "ck"), st, config=cfg)
    ps2, template = sim()
    st2 = checkpoint.restore(str(tmp_path / "ck"), template, config=cfg)
    assert st2.round == 2
    for r in range(2, 4):
        st2, _ = ps2.step(st2, r)
    assert cli._equal(st, st2)


def test_jax_state_carries_over(sync_run):
    """A JAX state (numpy leaves) becomes the port's, and the port's next
    round from it follows JAX's."""
    st = fedsim_state_from_jax(sync_run.states[1])
    assert st.round == 2 and st.residuals["w"].shape == (N, DIM)
    ps = sync_run.sim()
    st, m = ps.step(st, 2)
    assert_metrics(m, sync_run.metrics[2], 2)
    assert_state(st, sync_run.states[2], 2)
    stratum = fedsim_state_from_jax(sync_run.states[1], num_workers=2, rank=1)
    assert torch.equal(stratum.residuals["w"], _t(sync_run.states[1].residuals["w"][N // 2 :]))


@pytest.mark.parametrize("flags", [[], ["--async", "--slo"], ["--population", "--slo"], ["--tenants", "2", "--slo"]],
                         ids=["sync", "async-slo", "population-slo", "tenants-slo"])
def test_cli_check_on_the_cpu(tmp_path, capsys, flags):
    rc = cli.main(["check", "--device", "cpu", "--num_clients", "64", "--clients_per_round", "8",
                   "--num_workers", "2", "--track_dir", str(tmp_path), *flags])
    out = capsys.readouterr().out
    report = json.loads(out)
    assert rc == 0 and report["ok"], report["checks"]
    run = pathlib.Path(report["run_dir"])
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 6
    # health.jsonl holds transitions only: a healthy run may write none
    assert ("slo" in report) == ("--slo" in flags)


def test_two_rank_gloo_round_matches_a_two_device_jax_mesh(tmp_path):
    """Three churn + chaos rounds over two spawned gloo ranks, each holding
    its half of the bank, against the JAX FedSim on a two-device mesh."""
    W, R = 2, 3
    jr = JaxRun({**BASE, **CHURN}, R, W=W)
    gids = {(r, w): [w * (N // W) + int(i) for i in jr.cohort(r, w)] for r in range(R) for w in range(W)}
    tables = {
        "cohort": {(r, w): jr.cohort(r, w).tolist() for r in range(R) for w in range(W)},
        "participation": {r: jr.participation(r).tolist() for r in range(R)},
        "chaos": {r: jr.chaos(r) for r in range(R)},
        "batches": {(r, g): tuple(t[0] for t in jr.batches([g], r)) for (r, w), gs in gids.items() for g in gs},
    }
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(W)]
    procs = [ctx.Process(target=run_fedsim_rank, args=(r, W, store, outs[r], {**BASE, **CHURN}, R, tables))
             for r in range(W)]
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
    assert [p.exitcode for p in procs] == [0] * W
    got = [torch.load(o) for o in outs]
    jst = jr.states[-1]
    for w, (st, metrics, counts) in enumerate(got):
        assert_tree_close(st["params"], jst.params, f"rank {w} params")
        bank = {n: np.asarray(v)[w * (N // W) : (w + 1) * (N // W)] for n, v in _flatten(jst.residuals).items()}
        for n, v in st["residuals"].items():
            assert_close(v, bank[n], f"rank {w} bank {n}")
        for r in range(R):
            assert_metrics(metrics[r], jr.metrics[r], r)
        assert counts == {"all_reduce": R, "all_reduce_bytes": R * 4 * (DIM + 1 + 6)}
