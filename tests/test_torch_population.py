"""Port parity for the heterogeneous population (`population/`) against the
JAX package: `PopulationSpec`'s rejections under its reason codes, the
exact largest-remainder class counts, the concentration table and label
means bitwise; the port's own streams against their distributions (class
counts exact, label mixtures and sampled labels about their analytic
marginals); an async population round given JAX's draws (class ids,
per-class staleness, labels) within rtol 1e-5, atol 1e-6; and the uniform
one-class population bitwise the population-free round, sync and async."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fedsim import ASYNC, BASE, C, CHURN, LOCAL, BATCH, N, JaxRun, assert_metrics, assert_state, params0
from test_torch_fedsim_async import _bitwise, _sim, assert_buffer

from deepreduce_tpu.config import ConfigError as JConfigError
from deepreduce_tpu.fedsim.round import _LATENCY_TAG
from deepreduce_tpu.population import sampler as jsampler
from deepreduce_tpu.population.spec import PopulationSpec as JSpec
from deepreduce_tpu_torch.config import ConfigError
from deepreduce_tpu_torch.population import sampler
from deepreduce_tpu_torch.population.spec import PopulationSpec

SKEW = ('{"version": 1, "num_labels": 4, "label_shift": 0.05, "classes": ['
        '{"name": "fast", "weight": 3.0, "data_alpha": 2.0, "latency": "0.6,0.3,0.1"}, '
        '{"name": "slow", "weight": 1.0, "data_alpha": 0.2, "data_bias": 4.0, "latency": "0.2,0.5,0.3", '
        '"local_steps_mult": 2.0}]}')


def _cls(**kw):
    return {"name": "c0", **kw}


REJECTS = [
    ["not", "an", "object"],
    {"bogus_key": 1, "classes": [_cls()]},
    {"version": 2, "classes": [_cls()]},
    {"classes": "nope"},
    {"classes": ["nope"]},
    {"classes": [{"weight": 1.0}]},
    {"classes": [_cls(bogus=1)]},
    {"classes": [_cls(weight="3")]},
    {"classes": [_cls(), _cls()]},
    {"classes": []},
    {"classes": [{"name": f"c{i}"} for i in range(65)]},
    {"classes": [_cls(weight=0.0)]},
    {"classes": [_cls(data_alpha=-0.5)]},
    {"classes": [_cls(data_bias=-1.0)]},
    {"classes": [_cls(data_bias=2.0)]},
    {"classes": [_cls(local_steps_mult=0.5)]},
    {"classes": [_cls(latency=7)]},
    {"classes": [_cls(latency="0.5,x")]},
    {"classes": [_cls()], "num_labels": 1},
    {"classes": [_cls()], "num_labels": "many"},
    {"classes": [_cls()], "label_shift": -0.1},
    {"classes": [_cls()], "seed": -1},
]


@pytest.mark.parametrize("raw", REJECTS, ids=range(len(REJECTS)))
def test_spec_rejections_carry_jax_reason_codes(raw):
    with pytest.raises(JConfigError) as jerr:
        JSpec.from_dict(raw)
    with pytest.raises(ConfigError) as perr:
        PopulationSpec.from_dict(raw)
    assert perr.value.reason_code == jerr.value.reason_code


def test_spec_loads_views_and_tables_match_jax(tmp_path):
    for raw in ("{bad json", str(tmp_path / "missing.json"), ""):
        with pytest.raises(ConfigError) as perr:
            PopulationSpec.load_any(raw)
        with pytest.raises(JConfigError) as jerr:
            JSpec.load_any(raw)
        assert perr.value.reason_code == jerr.value.reason_code
    for raw in (SKEW, '{"classes": [{"name": "u"}]}', '{"num_labels": 5, "classes": [{"name": "a", "weight": 2},'
                '{"name": "b", "data_alpha": 0.5, "data_bias": 1}, {"name": "c", "weight": 0.3}]}'):
        p, j = PopulationSpec.load_any(raw), JSpec.load_any(raw)
        assert p.to_dict() == j.to_dict() and p.is_uniform == j.is_uniform
        assert (p.weights, p.skew_on, p.latency_on) == (j.weights, j.skew_on, j.latency_on)
        np.testing.assert_array_equal(sampler.concentration_table(p), jsampler.concentration_table(j))
        np.testing.assert_array_equal(sampler.expected_marginals(p), jsampler.expected_marginals(j))
        np.testing.assert_array_equal(sampler.label_means(p), jsampler.label_means(j))
        for n in (1, 7, 64, 1000, 131072):
            assert sampler.class_counts(p, n) == jsampler.class_counts(j, n)


def test_class_assignments_are_quota_exact_and_shuffled():
    spec = PopulationSpec.load_any(SKEW)
    for n in (64, 1001):
        ids = sampler.class_assignments(spec, n)
        assert ids.dtype == torch.int32
        assert tuple(torch.bincount(ids.long(), minlength=2).tolist()) == sampler.class_counts(spec, n)
        assert torch.equal(ids, sampler.class_assignments(spec, n))
    ids = sampler.class_assignments(spec, 1001)
    assert ids[:250].sum() > 0 and ids[:250].sum() < 250  # not the sorted base


def test_mixtures_and_labels_hold_their_marginals():
    """4,000 clients per class: the mean mixture within 5 sigma of the
    analytic marginal c / sum(c) (a Dirichlet component's variance is
    m (1 - m) / (sum(c) + 1)); one round's sampled labels likewise, with the
    sampling variance of the labels added; an alpha-0 class uniform."""
    spec = PopulationSpec.load_any(SKEW)
    want = sampler.expected_marginals(spec)
    conc = sampler.concentration_table(spec)
    n = 4000
    for k in range(spec.num_classes):
        gids = torch.arange(k * n, (k + 1) * n)
        cls = torch.full((n,), k, dtype=torch.int32)
        pi = sampler.label_mixtures(spec, gids, cls)
        assert torch.allclose(pi.sum(dim=1), torch.ones(n), atol=1e-5) and bool((pi >= 0).all())
        var_pi = want[k] * (1 - want[k]) / (conc[k].sum() + 1)
        np.testing.assert_array_less(np.abs(pi.mean(0).numpy() - want[k]), 5 * np.sqrt(var_pi / n) + 1e-6)
        labels = sampler.draw_labels(12345, gids, pi, (LOCAL, BATCH))
        freq = np.bincount(labels.reshape(-1).numpy(), minlength=spec.num_labels) / labels.numel()
        var = var_pi / n + want[k] * (1 - want[k]) / labels.numel()
        np.testing.assert_array_less(np.abs(freq - want[k]), 5 * np.sqrt(var) + 1e-6)
    flat = PopulationSpec.load_any('{"classes": [{"name": "u"}]}')
    pi = sampler.label_mixtures(flat, torch.arange(8), torch.zeros(8, dtype=torch.int32))
    assert torch.equal(pi, torch.full((8, 8), 1 / 8))


def _pop_draws(run):
    """JAX's class ids, per-class staleness and labels for `run`."""
    js = run.js
    classes = np.asarray(jsampler.class_assignments(js.pop, N))
    rows = jnp.asarray(js.pop_latency_rows, jnp.float32)
    mix_base = jax.random.fold_in(jax.random.PRNGKey(js.pop.seed), jsampler._POP_MIX_TAG)
    safe = jnp.where(jnp.asarray(jsampler.concentration_table(js.pop)) > 0,
                     jnp.asarray(jsampler.concentration_table(js.pop)), 1.0)

    def taus(r, t=0):
        cls = jnp.asarray(classes)[jnp.asarray(run.cohort(r, 0))]
        u = jax.random.uniform(jax.random.fold_in(run.round_key(r), _LATENCY_TAG), (C,))
        cdf = jnp.cumsum(rows, axis=1)[cls]
        return np.asarray(jnp.sum((u[:, None] > cdf[:, :-1]).astype(jnp.int32), axis=1))

    @jax.jit
    @jax.vmap
    def jlabels(g, k, key):
        pi = jax.random.dirichlet(jax.random.fold_in(mix_base, g), safe[k])
        return jax.random.categorical(jax.random.fold_in(key, jsampler._POP_LABEL_TAG), jnp.log(pi),
                                      shape=(LOCAL, BATCH))

    def labels(r, gids, t=0):
        kd = run.split(r)[4]
        g = jnp.asarray(gids.numpy(), jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(kd, i))(g)
        return torch.from_numpy(np.array(jlabels(g, jnp.asarray(classes)[g], keys)))

    return run.draws(taus=taus, labels=labels, classes=classes.tolist())


@pytest.fixture(scope="module")
def pop_run():
    return JaxRun({**BASE, **CHURN, **ASYNC, "pop_spec": SKEW}, 4)


def test_population_ticks_match_jax_given_its_draws(pop_run):
    """Four async ticks of the skewed two-class population with per-class
    latency rows: the per-class histogram exact, the state within the
    tolerance."""
    ps = pop_run.sim(draws=_pop_draws(pop_run))
    st = ps.init(params0())
    for r in range(pop_run.rounds):
        st, m = ps.step(st, r)
        assert_metrics(m, pop_run.metrics[r], r)
        assert_state(st, pop_run.states[r], r)
        assert_buffer(st.buffer, pop_run.states[r].buffer, f"tick {r}")
        assert float(m["pop_hist"].sum()) == float(m["clients"])
    np.testing.assert_array_equal(st.classes.numpy(), np.asarray(pop_run.states[-1].classes))


@pytest.mark.parametrize("extra", [{}, ASYNC], ids=["sync", "async"])
def test_uniform_population_is_bitwise_population_free(extra):
    knobs = {**BASE, **CHURN, **extra}
    free, uni = _sim(knobs), _sim({**knobs, "pop_spec": '{"classes": [{"name": "uniform"}]}'})
    sf, su = free.init(params0()), uni.init(params0())
    for r in range(3):
        sf, mf = free.step(sf, r)
        su, mu = uni.step(su, r)
        assert torch.equal(mu["pop_hist"], mf["clients"].reshape(1))
    for n in sf.params:
        assert torch.equal(sf.params[n], su.params[n]) and torch.equal(sf.residuals[n], su.residuals[n])
    if extra:
        assert _bitwise(sf.buffer, su.buffer)


def test_alpha_zero_class_batches_are_the_base_generator_bitwise():
    spec = PopulationSpec.load_any('{"num_labels": 4, "classes": [{"name": "iid"}, {"name": "skew", '
                                   '"data_alpha": 1.0}]}')
    from deepreduce_tpu_torch.fedsim import synthetic_linear_problem

    _, data_fn, _ = synthetic_linear_problem(16, BATCH, LOCAL, device="cpu")
    pop_fn = sampler.make_population_data_fn(spec, data_fn)
    gids, cls = torch.arange(6), torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32)
    (x, y), (bx, by) = pop_fn(gids, cls, 2, 99), data_fn(gids, 2, 99)
    assert torch.equal(x[0::2], bx[0::2]) and torch.equal(y[0::2], by[0::2])
    assert not torch.equal(x[1::2], bx[1::2])
