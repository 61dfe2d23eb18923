"""Deterministic population sampling: everything derives from the spec,
ported from `deepreduce_tpu/population/sampler.py`.

Three stream domains, all rooted at the spec's seed (never the round key)
and separated by the JAX package's tags, on the counter-based stream of
`resilience.stream` (`jax.random`'s draws cannot be reproduced in torch;
the parity tests inject them, and the port's own draws are held to their
distributions):

- ``_POP_ASSIGN_TAG``: the class-assignment permutation. Class COUNTS are
  exact largest-remainder quotas of the normalized weights (no sampling
  noise in the population composition); the permutation (an argsort of
  hashed keys) only shuffles which client id gets which class.
- ``_POP_MIX_TAG``: per-client persistent label mixtures
  ``pi_g ~ Dirichlet(c_class(g))``, keyed by the global client id, so a
  client keeps its mixture for life. The gamma draws are Marsaglia–Tsang
  over the stream's normals and uniforms, with a fixed number of proposals
  per draw (the first accepted one is kept), so no draw waits on the host.
- ``_POP_LABEL_TAG``: per-round per-sample labels, keyed by the round's
  data key and the global client id, an inverse CDF of the mixture.

The skew transform is a per-sample mean shift ``mu[label]`` (centered
over the label universe, scaled by ``label_shift``) applied by an exact
``torch.where`` SELECT per class gate: an alpha=0 class's batch is the base
generator's output BITWISE, and a spec with no skewed class returns the
base ``data_fn`` untouched.

A `data_fn` here is batched over clients: ``data_fn(gids, rnd, key)`` with
``gids`` an int64 tensor of global client ids gives the clients' batches,
each leaf ``[B, local_steps, batch, ...]``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.population.spec import PopulationSpec
from deepreduce_tpu_torch.resilience import stream

# domain tags (the JAX package's fold_in tags)
_POP_ASSIGN_TAG = 0xA551
_POP_MIX_TAG = 0x314D
_POP_LABEL_TAG = 0x1ABE1
# Marsaglia–Tsang proposals per gamma draw: each is accepted with
# probability above 0.95, so all of them fail with probability below 1e-20
_GAMMA_PROPOSALS = 16


def class_counts(spec: PopulationSpec, num_clients: int) -> Tuple[int, ...]:
    """Exact largest-remainder quotas of the normalized class weights —
    deterministic, sums to num_clients, ties broken by class order."""
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    raw = [w * num_clients for w in spec.weights]
    counts = [int(math.floor(r)) for r in raw]
    rem = num_clients - sum(counts)
    order = sorted(
        range(spec.num_classes),
        key=lambda k: (-(raw[k] - counts[k]), k),
    )
    for k in order[:rem]:
        counts[k] += 1
    return tuple(counts)


def class_assignments(spec: PopulationSpec, num_clients: int, *, device="cpu") -> torch.Tensor:
    """The int32[num_clients] class-id vector on `device`: quota-exact
    composition, shuffled by the spec-seeded permutation. Reproducible from
    (spec, N) alone."""
    counts = class_counts(spec, num_clients)
    base = torch.repeat_interleave(
        torch.arange(spec.num_classes, dtype=torch.int32, device=device),
        torch.tensor(counts, dtype=torch.int64).to(device),
        output_size=num_clients,
    )
    keys = stream.words_at(stream.key(spec.seed, _POP_ASSIGN_TAG), torch.arange(num_clients, device=device))
    perm = torch.sort(keys, stable=True).indices
    return base[perm]


def concentration_table(spec: PopulationSpec) -> np.ndarray:
    """f32[K, L] Dirichlet concentration rows: ``c[k, l] = data_alpha_k +
    data_bias_k·[l == k % L]``. An alpha=0 (IID-sentinel) class's row is
    all zeros — callers must gate it out, or use the mixture helpers
    below which substitute the uniform mixture for those rows."""
    K, L = spec.num_classes, spec.num_labels
    c = np.zeros((K, L), dtype=np.float32)
    for k, cls in enumerate(spec.classes):
        c[k, :] = cls.data_alpha
        if cls.data_bias > 0.0:
            c[k, k % L] += cls.data_bias
    return c


def expected_marginals(spec: PopulationSpec) -> np.ndarray:
    """f32[K, L] analytic per-class label marginals ``E[pi | class k] =
    c_k / sum(c_k)`` (uniform for alpha=0 rows) — what the planted-skew
    test pins the empirical mixtures against."""
    c = concentration_table(spec)
    out = np.full_like(c, 1.0 / spec.num_labels)
    for k in range(spec.num_classes):
        s = c[k].sum()
        if s > 0:
            out[k] = c[k] / s
    return out


def label_means(spec: PopulationSpec) -> np.ndarray:
    """f32[L] centered per-label mean shifts spanning
    [-label_shift, +label_shift] with exact zero mean over the universe."""
    L = spec.num_labels
    levels = 2.0 * np.arange(L, dtype=np.float32) - (L - 1)
    return (spec.label_shift * levels / (L - 1)).astype(np.float32)


def gamma_draws(k: int, positions: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws at the int64 `positions` of stream `k`, one per
    position (`alpha` broadcast against them, every alpha > 0):
    Marsaglia–Tsang at alpha + 1 (`_GAMMA_PROPOSALS` proposals, the first
    accepted one kept), times U^(1/alpha) where alpha < 1."""
    a = alpha.to(torch.float32)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    base = positions[..., None] * (_GAMMA_PROPOSALS + 1) + torch.arange(_GAMMA_PROPOSALS, device=positions.device)
    x = stream.normals(stream.key(k, 1), base)
    u = stream.to_uniform(stream.words_at(stream.key(k, 2), base))
    d, c = d[..., None], c[..., None]
    v = (1.0 + c * x) ** 3
    safe_v = torch.clamp(v, min=1e-30)
    accept = (v > 0) & (torch.log1p(-u) < 0.5 * x * x + d - d * safe_v + d * torch.log(safe_v))
    # the first accepted proposal (the last one if, improbably, none is)
    first = torch.where(accept.any(dim=-1), accept.to(torch.int8).argmax(dim=-1), _GAMMA_PROPOSALS - 1)
    g = (d * safe_v).gather(-1, first[..., None])[..., 0]
    ub = stream.to_uniform(stream.words_at(stream.key(k, 3), positions))
    return torch.where(boost, g * torch.exp(torch.log1p(-ub) / a), g)


def tables_on(spec: PopulationSpec, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(safe concentrations f32[K, L], skew gates bool[K], label means
    f32[L]) on `device`, copied there once: FedSim asks for them when it is
    built, so that no round copies them ("cuda" and "cuda:0" are one
    device here)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _tables(spec, str(dev))


@functools.lru_cache(maxsize=None)
def _tables(spec: PopulationSpec, device: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    conc = torch.from_numpy(concentration_table(spec))
    safe = torch.where(conc > 0, conc, torch.ones_like(conc))
    on = torch.tensor([c.data_alpha > 0.0 for c in spec.classes])
    mu = torch.from_numpy(label_means(spec))
    return safe.to(device), on.to(device), mu.to(device)


def label_mixtures(spec: PopulationSpec, client_ids: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """f32[n, L] persistent per-client label mixtures for the given global
    client ids (int64) and class ids, on their device: Dirichlet draws keyed
    by the client id, so a client keeps its mixture. Alpha=0 classes get the
    uniform mixture."""
    dev = client_ids.device
    L = spec.num_labels
    safe, on, _ = tables_on(spec, dev)
    cls = classes.long()
    pos = client_ids.long()[:, None] * L + torch.arange(L, device=dev)
    g = gamma_draws(stream.key(spec.seed, _POP_MIX_TAG), pos, safe[cls])
    pi = g / g.sum(dim=-1, keepdim=True)
    return torch.where(on[cls][:, None], pi, torch.full_like(pi, 1.0 / L))


def draw_labels(key: int, client_ids: torch.Tensor, pi: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """int64[n, *lead] per-sample labels of a round: the inverse CDF of each
    client's mixture at the uniforms keyed by the round's data key and the
    client id."""
    dev = client_ids.device
    m = math.prod(lead)
    pos = client_ids.long()[:, None] * m + torch.arange(m, device=dev)
    u = stream.to_uniform(stream.words_at(stream.key(key, _POP_LABEL_TAG), pos))
    cdf = torch.cumsum(pi, dim=-1)
    labels = (u[:, :, None] > cdf[:, None, :-1]).sum(dim=-1)
    return labels.reshape((client_ids.shape[0],) + tuple(lead))


def make_population_data_fn(spec: PopulationSpec, data_fn: Callable) -> Callable:
    """Wrap a batched ``data_fn(gids, rnd, key) -> batch`` into
    ``pop_data_fn(gids, class_ids, rnd, key, labels=None) -> batch``
    applying the class-conditioned non-IID transform. With no skewed class
    the base generator's batch is returned untouched, the bitwise-degeneracy
    anchor. `labels` (int [B, local_steps, batch]) replaces the label draws
    (the parity tests inject `jax.random`'s).

    The transform assumes the batch's leaves lead with the
    ``[B, local_steps, batch]`` sample dims (the `synthetic_linear_problem`
    shape); leaves with other leading dims pass through unshifted."""
    if not spec.skew_on:
        def iid_data_fn(gids, class_ids, rnd, key, labels=None):
            return data_fn(gids, rnd, key)

        return iid_data_fn

    def pop_data_fn(gids, class_ids, rnd, key, labels: Optional[torch.Tensor] = None):
        batch = data_fn(gids, rnd, key)
        leaves, treedef = torch.utils._pytree.tree_flatten(batch)
        dev = leaves[0].device
        lead = tuple(leaves[0].shape[1:3])
        if labels is None:
            pi = label_mixtures(spec, gids, class_ids)
            labels = draw_labels(key, gids, pi, lead)
        _, gates, mu = tables_on(spec, dev)
        shift = mu[labels.long()]
        on = gates[class_ids.long()]
        full = (gids.shape[0],) + lead

        def shifted(v):
            if v.dim() >= len(full) and tuple(v.shape[: len(full)]) == full:
                s = shift.reshape(full + (1,) * (v.dim() - len(full)))
                o = on.reshape((-1,) + (1,) * (v.dim() - 1))
                return torch.where(o, v + s, v)
            return v

        return torch.utils._pytree.tree_unflatten([shifted(v) for v in leaves], treedef)

    return pop_data_fn
