"""Federated round bodies: one client's uplink, and a cohort's worth of
them, ported from `deepreduce_tpu/fedsim/round.py`.

The round body shared by the two federated drivers:

- `fedavg.FedAvg.run_round`, the paper's harness, runs the cohort one
  client after another (`impl="scan"`, the JAX package's reference scan);
- `fedsim.sim.FedSim`, the population-scale driver, runs it as batched
  blocks of clients (`impl="vmap"`, `chunk` clients a block): local training
  under `torch.func.vmap`, each leaf's index stage vmapped over the block,
  and the QSGD rows of the whole block in one grouped kernel call
  (`TreeCodec.encode_batched`).

Both run the same client body (`ClientStep`): local training from the
client's reference model, the update's compression through the real
`TensorCodec` stack with per-client error feedback, and, when a payload
layout is given, the wire-image uplink: the payload packed into its byte
image (`comm.PayloadLayout`), perturbed by the `ChaosInjector`, verified by
its checksum word and decoded from what arrived. The sender's error
feedback advances from its clean decode: it cannot see the wire.

Degradation semantics (as in the JAX package): a *non-participating*
client (churn) never trained: its update, wire bits and residual write are
all suppressed, and its pending error-feedback mass waits for the next time
it is sampled. A client whose payload *fails the checksum* did train and
transmit: its wire bits count and its residual advances, but its decoded
update leaves the sum through a select (`torch.where`), never a multiply:
a corrupt payload can decode to Inf or NaN, and NaN * 0 is NaN. No mask
reads a value on the host.

The asynchronous half: a client with staleness tau trains from the model
as of tau server versions ago (a slot of the `w_hist` ring) and its decoded
update is weighted 1/(1+tau)^alpha (`staleness_weights`). The latency,
per-tenant and per-class knob parsers are the JAX package's. Staleness is
drawn from the counter-based stream (`resilience.stream`) keyed by the
round key and `_LATENCY_TAG`, as an inverse CDF over the row's
probabilities; `jax.random`'s draws cannot be reproduced, and the parity
tests inject them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from deepreduce_tpu_torch.fedsim.codec_tree import TreeCodec
from deepreduce_tpu_torch.resilience import stream

Tree = Dict[str, torch.Tensor]
WIRE_FIELDS = ("index_bits", "value_bits", "dense_bits", "saturated")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Round geometry (paper §6.2: 56 clients sampled from 57 VMs;
    Table 5: 10 clients, 800 rounds)."""

    num_clients: int
    clients_per_round: int
    local_steps: int = 1
    server_lr: float = 1.0

    def __post_init__(self):
        if self.num_clients <= 0:
            raise ValueError(f"num_clients must be positive, got {self.num_clients}")
        if self.clients_per_round <= 0:
            raise ValueError(
                f"clients_per_round must be positive, got {self.clients_per_round}"
            )
        if self.clients_per_round > self.num_clients:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} exceeds the "
                f"population num_clients={self.num_clients} — sampling is "
                "without replacement (Algorithm 2), so a round cannot draw "
                "more clients than exist"
            )
        if self.local_steps <= 0:
            raise ValueError(f"local_steps must be positive, got {self.local_steps}")
        if self.server_lr <= 0:
            raise ValueError(f"server_lr must be positive, got {self.server_lr}")


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {n: x - b[n] for n, x in a.items()}


def tree_add(a: Tree, b: Tree) -> Tree:
    return {n: x + b[n] for n, x in a.items()}


def index_batch(batch: Any, i: int) -> Any:
    """Row `i` of every tensor of a batch (a tensor, or a tuple, list or dict
    of them), as JAX's scan slices its `xs`."""
    return tree_map(lambda x: x[i], batch)


def slice_batch(batch: Any, lo: int, hi: int) -> Any:
    """Rows lo..hi-1 of every tensor of a batch (one block of clients)."""
    return tree_map(lambda x: x[lo:hi], batch)


def _wire4(wire) -> Tuple[torch.Tensor, ...]:
    return tuple(getattr(wire, f).to(torch.float32) for f in WIRE_FIELDS)


def position_index(positions: Sequence[int], device) -> torch.Tensor:
    """int64 tensor of cohort positions on `device`. A run of consecutive
    positions (every cohort's, and every block's) is made on the device,
    with no host copy."""
    positions = [int(p) for p in positions]
    if positions == list(range(positions[0], positions[0] + len(positions))):
        return torch.arange(positions[0], positions[0] + len(positions), device=device)
    return torch.as_tensor(positions, dtype=torch.int64).to(device)


def _bcast(gate: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return gate.reshape(gate.shape + (1,) * (like.dim() - gate.dim()))


class ClientStep:
    """The per-client body of a round, for one client (`__call__`) or a
    block of clients (`batched`).

    `local_train(ref, batches) -> params` trains one client from its
    reference model on its [local_steps, ...] batches; the block form runs
    it under `torch.func.vmap`, so it must be functional (`torch.func.grad`,
    no in-place update of a captured tensor). `ref(positions)` gives the
    clients' reference models: the shared `w_ref` (then the block broadcasts
    it) or a tree of [B, ...] rows. `weight(positions)` gives the clients'
    update weights ([B] float32) or None. `uniforms[pos]` (path -> f32, CPU
    only) injects client pos's QSGD draws; `chaos_draws[pos]` its chaos
    events and byte draws (see `ChaosInjector.perturb`).

    Returns `(dec_update_tree, new_residual_tree_or_None, wire4, ok)`:
    `wire4` the (index, value, dense, saturated) bits as float32 and `ok`
    the checksum gate (1.0 without a layout); each 0-d, or [B] for a
    block. After a block, `segments` holds its grouped QSGD segment
    table."""

    def __init__(
        self,
        tree_codec: TreeCodec,
        local_train: Callable[[Tree, Any], Tree],
        ref: Callable[[Sequence[int]], Tuple[Tree, bool]],
        step: int,
        *,
        weight: Optional[Callable[[Sequence[int]], torch.Tensor]] = None,
        uniforms: Optional[Any] = None,
        layout=None,
        chaos=None,
        chaos_draws: Optional[Dict[int, Dict[str, Any]]] = None,
    ):
        self.tree_codec = tree_codec
        self.local_train = local_train
        self.ref = ref
        self.step = int(step)
        self.weight = weight
        self.uniforms = uniforms
        self.layout = layout
        self.chaos = chaos
        self.chaos_draws = chaos_draws

    def _perturb(self, buf: torch.Tensor, pos: int) -> torch.Tensor:
        draws = None if self.chaos_draws is None else self.chaos_draws.get(int(pos))
        return self.chaos.perturb(buf, step=self.step, worker=int(pos), draws=draws)

    def __call__(self, batch_c: Any, res_c: Optional[Tree], pos: int):
        tc = self.tree_codec
        ref, shared = self.ref([pos])
        ref = ref if shared else {n: r[0] for n, r in ref.items()}
        update = tree_sub(self.local_train(ref, batch_c), ref)
        u = None if self.uniforms is None else self.uniforms[pos]
        payloads, comps, spec = tc.encode_tree(update, res_c, step=self.step, worker=int(pos), uniforms=u)
        dec_clean = tc.decode_tree(payloads, spec, step=self.step)
        dev = comps[0].device
        if self.layout is not None:
            buf = self.layout.pack([leaf for p in payloads for leaf in p.leaves()])
            if self.chaos is not None:
                buf = self._perturb(buf, pos)
                # the wire image changed: the receiver decodes what arrived
                recv = tc.payloads_from_leaves(self.layout.unpack(buf), spec)
                dec_recv = tc.decode_tree(recv, spec, step=self.step)
            else:
                dec_recv = dec_clean
            ok = self.layout.verify(buf)
        else:
            dec_recv = dec_clean
            ok = torch.ones((), dtype=torch.float32, device=dev)
        if self.weight is not None:
            w = self.weight([pos])[0]
            dec_recv = {n: d * w for n, d in dec_recv.items()}
        # sender-side error feedback: against what IT encoded, the clean decode
        new_res = None if res_c is None else {n: c - dec_clean[n] for n, c in zip(spec.names, comps)}
        return dec_recv, new_res, _wire4(tc.wire_tree(payloads, spec)), ok

    def batched(self, batch_b: Any, res_b: Optional[Tree], positions: Sequence[int]):
        """The block form: `batch_b` tensors [B, local_steps, ...], `res_b`
        [B, ...] or None, B cohort positions."""
        tc = self.tree_codec
        ref, shared = self.ref(positions)
        p_end = vmap(self.local_train, in_dims=(None if shared else 0, 0))(ref, batch_b)
        update = tree_sub(p_end, ref)
        parts, comps, spec, self.segments = tc.encode_batched(
            update, res_b, step=self.step, workers=[int(p) for p in positions],
            uniforms=None if self.uniforms is None else [self.uniforms[p] for p in positions],
        )
        dec_clean = tc.decode_batched(parts, spec, step=self.step)
        B = len(positions)
        dev = comps[0].device
        if self.layout is not None:
            flat = [leaf for leaves in parts for leaf in leaves]
            buf = self.layout.pack_rows(flat)
            if self.chaos is not None:
                if self.chaos_draws is None:
                    buf = self.chaos.perturb_rows(buf, step=self.step, workers=position_index(positions, dev))
                else:
                    for c, pos in enumerate(positions):
                        buf[c] = self._perturb(buf[c], pos)
                recv = tc.split_leaves(self.layout.unpack_rows(buf), spec)
                dec_recv = tc.decode_batched(recv, spec, step=self.step)
            else:
                dec_recv = dec_clean
            ok = self.layout.verify(buf)
        else:
            dec_recv = dec_clean
            ok = torch.ones(B, dtype=torch.float32, device=dev)
        if self.weight is not None:
            w = self.weight(positions)
            dec_recv = {n: d * _bcast(w, d) for n, d in dec_recv.items()}
        new_res = None if res_b is None else {n: c - dec_clean[n] for n, c in zip(spec.names, comps)}
        return dec_recv, new_res, _wire4(tc.wire_batched(parts, spec)), ok


def make_client_step(
    tree_codec: TreeCodec,
    local_train: Callable[[Tree, Any], Tree],
    w_ref: Tree,
    step: int,
    *,
    uniforms: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    layout=None,
    chaos=None,
    chaos_draws: Optional[Dict[int, Dict[str, Any]]] = None,
) -> ClientStep:
    """The synchronous client body: every client trains from `w_ref`. `pos`
    is the client's cohort position: the `worker` of its leaves' streams
    and of its chaos draws (`step` is the round). `uniforms[pos]` (path ->
    f32, CPU only) injects the QSGD draws. `layout` (a `comm.PayloadLayout`
    over the tree's payload leaves, `TreeCodec.payload_specs`) engages the
    wire-image uplink, `chaos` its perturbation."""
    return ClientStep(tree_codec, local_train, lambda positions: (w_ref, True), step, uniforms=uniforms,
                      layout=layout, chaos=chaos, chaos_draws=chaos_draws)


def _mask_tree(tree: Tree, gate: torch.Tensor) -> Tree:
    """Zero a client's contribution via SELECT (gate a 0-d float32, or [B]
    against [B, ...] tensors)."""
    return {n: torch.where(_bcast(gate, u) > 0, u, torch.zeros_like(u)) for n, u in tree.items()}


def _mask_where(gate: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(_bcast(gate, new) > 0, new, old)


def cohort_updates(
    client_step: ClientStep,
    client_batches: Any,
    res_stack: Optional[Tree],
    positions: Sequence[int],
    *,
    update_template: Tree,
    rows: Optional[torch.Tensor] = None,
    participation: Optional[torch.Tensor] = None,
    checksum: bool = False,
    impl: str = "scan",
    chunk: int = 0,
) -> Tuple[Tree, Optional[Tree], Tuple[torch.Tensor, ...], torch.Tensor]:
    """Run `client_step` over a cohort and aggregate. `update_template` is
    any tree with the model's names, shapes and dtypes (e.g. `w_ref`); it
    seeds the sum.

    `client_batches` tensors are [C, local_steps, ...]; `positions` are the
    C cohort positions (ints). `res_stack` (or None) holds the residuals:
    client c's are its row `rows[c]` (int64[C] on the device; default c, a
    [C, ...] stack), read and written in place, so `res_stack` may be the
    whole population's bank and the rows distinct. `participation` is an
    optional float32 / bool [C] churn mask on the device; `checksum`
    declares that the client body's `ok` is a real gate.

    impl="scan": one client after another, their decoded updates summed
    from zeros in cohort order, as the JAX package's scan does. impl="vmap":
    the cohort as batched blocks of `chunk` clients (0: one block of C;
    chunk must divide C), each block's updates summed over its clients (in
    float64, rounded once to float32) and the blocks' sums added in order,
    as the JAX package's chunked vmap.

    Returns (upd_sum_tree, res_stack_or_None, wire4_sums, live_f32[C]) where
    `live[c] = participation[c] * ok[c]` is the effective contribution gate
    (all ones when nothing is engaged)."""
    if impl not in ("scan", "vmap"):
        raise ValueError(f"impl must be 'scan' or 'vmap', got {impl!r}")
    some = next(iter(update_template.values()))
    dev = some.device
    C = len(positions)
    has_part = participation is not None
    has_live = has_part or checksum
    part = participation.to(torch.float32) if has_part else None
    if res_stack is not None and rows is None:
        rows = torch.arange(C, device=dev)

    def gate(dec, new_res, wire4, ok, res, m):
        live = ok * m if has_part else ok
        if has_live:
            dec = _mask_tree(dec, live)
        if has_part:
            if new_res is not None:
                # a churned client never compressed: it keeps its old residual
                new_res = {n: _mask_where(m, new, res[n]) for n, new in new_res.items()}
            # a churned client transmitted nothing; a checksum-failed one did
            wire4 = tuple(w * m for w in wire4)
        return dec, new_res, wire4, live

    upd_sum = {n: torch.zeros_like(t) for n, t in update_template.items()}
    wire_acc = tuple(torch.zeros((), dtype=torch.float32, device=dev) for _ in WIRE_FIELDS)
    lives: List[torch.Tensor] = []
    if impl == "scan":
        for c, pos in enumerate(positions):
            row = None if res_stack is None else rows[c : c + 1]
            res_c = None if row is None else {n: r.index_select(0, row)[0] for n, r in res_stack.items()}
            out = client_step(index_batch(client_batches, c), res_c, pos)
            dec, new_res_c, wire4, live = gate(*out, res_c, None if part is None else part[c])
            upd_sum = tree_add(upd_sum, dec)
            wire_acc = tuple(a + w for a, w in zip(wire_acc, wire4))
            lives.append(live.reshape(1))
            if row is not None:
                for n, r in res_stack.items():
                    r.index_copy_(0, row, new_res_c[n][None])
        return upd_sum, res_stack, wire_acc, torch.cat(lives)

    block = C if not chunk or chunk >= C else int(chunk)
    if C % block:
        raise ValueError(f"chunk={chunk} must divide the cohort size {C}")
    for lo in range(0, C, block):
        hi = lo + block
        rows_b = None if res_stack is None else rows[lo:hi]
        res_b = None if rows_b is None else {n: r.index_select(0, rows_b) for n, r in res_stack.items()}
        out = client_step.batched(slice_batch(client_batches, lo, hi), res_b, positions[lo:hi])
        dec, new_res_b, wire4, live = gate(*out, res_b, None if part is None else part[lo:hi])
        # the block's sum in float64, rounded once: the same float32 on the
        # card and the CPU (a float32 reduction's order differs between them)
        blk = {n: u.sum(dim=0, dtype=torch.float64).to(u.dtype) for n, u in dec.items()}
        # one block is the whole sum; blocks add to it in order from zeros
        upd_sum = blk if block == C else tree_add(upd_sum, blk)
        wire_acc = tuple(w.sum() for w in wire4) if block == C else tuple(
            a + w.sum() for a, w in zip(wire_acc, wire4))
        lives.append(live)
        if rows_b is not None:
            for n, r in res_stack.items():
                r.index_copy_(0, rows_b, new_res_b[n])
    return upd_sum, res_stack, wire_acc, torch.cat(lives)


# --------------------------------------------------------------------------- #
# Asynchronous buffered mode (FedBuff-style): stragglers as a deterministic
# per-client latency distribution instead of binary churn. A client drawn
# with latency tau trained from the model as of tau server versions ago;
# the server down-weights its delta by 1/(1+tau)^alpha and buffers it until
# K contributions have arrived.
# --------------------------------------------------------------------------- #

# domain tag of the latency draw (the JAX package's fold_in tag)
_LATENCY_TAG = 0x57A1E


def parse_latency(spec: str, name: str = "fed_async_latency") -> Tuple[float, ...]:
    """Parse a latency distribution spec: comma-separated non-negative
    weights over staleness tau = 0, 1, 2, ..., normalized to probabilities.
    "" (the default) is zero latency: (1.0,). The tuple length is the
    overlap depth D — the number of past model versions kept in the w_hist
    ring, so tau is bounded by D-1 *by construction* (no runtime clamp).

    This is THE latency row parser: the global `fed_async_latency` knob,
    the per-tenant rows (`parse_tenant_latency`), and the per-class rows
    (`parse_class_latency`) all route through it — `name` labels the
    failing knob in the message."""
    if not spec:
        return (1.0,)
    try:
        weights = [float(tok) for tok in spec.split(",")]
    except ValueError as e:
        raise ValueError(
            f"{name}={spec!r}: every comma-separated token must "
            f"be a float weight ({e})"
        ) from None
    if any(not math.isfinite(w) for w in weights):
        raise ValueError(
            f"{name}={spec!r}: weights must be finite — nan/inf cannot "
            "normalize to a probability row"
        )
    if any(w < 0 for w in weights):
        raise ValueError(
            f"{name}={spec!r}: weights are unnormalized "
            "probabilities and must be >= 0"
        )
    total = sum(weights)
    if total <= 0:
        raise ValueError(
            f"{name}={spec!r}: weights must not all be zero"
        )
    if len(weights) > 64:
        raise ValueError(
            f"{name}={spec!r}: {len(weights)} staleness levels — "
            "the w_hist ring keeps one full model copy per level; cap is 64"
        )
    return tuple(w / total for w in weights)


def latency_uniforms(key: int, n: int, device) -> torch.Tensor:
    """f32[n] uniforms in [0, 1) of the round's latency stream (position =
    global cohort position), on `device` without a host sync."""
    return stream.uniforms(stream.key(key, _LATENCY_TAG), n, device)


def _cdf(probs: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(probs.to(torch.float32), dim=-1)


def draw_latency(key: int, probs: Union[Tuple[float, ...], torch.Tensor], C: int, *, device) -> torch.Tensor:
    """int64[C] per-client staleness over GLOBAL cohort positions from the
    round key (every worker computes the same replicated vector, no
    collective): the inverse CDF of the row `probs` at the latency stream's
    uniforms. Zero latency (D == 1) draws nothing. `probs` is the parsed
    tuple or an f32[D] tensor row (a tenant's); a row zero-padded to a
    deeper D keeps its CDF, and so its draws."""
    D = len(probs) if isinstance(probs, tuple) else int(probs.shape[0])
    if D == 1:
        return torch.zeros(C, dtype=torch.int64, device=device)
    row = torch.tensor(probs, dtype=torch.float32, device="cpu").to(device) if isinstance(probs, tuple) else probs
    u = latency_uniforms(key, C, device)
    return (u[:, None] > _cdf(row)[None, :-1]).sum(dim=1)


def class_latency(u: torch.Tensor, rows: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """int64 staleness of clients by class: the inverse CDF of each client's
    class row (`rows` f32[K, D]) at its uniform, as the JAX package's
    per-class path draws it."""
    cdf = _cdf(rows)[classes]
    return (u[:, None] > cdf[:, :-1]).sum(dim=1)


def _alpha_is_static_zero(alpha) -> bool:
    """True iff alpha is a host 0.0 (the identity-weighting fast path). A
    tensor alpha (a tenant's) always stages the power."""
    return isinstance(alpha, (int, float)) and float(alpha) == 0.0


def staleness_weights(taus_f: torch.Tensor, alpha) -> torch.Tensor:
    """`1/(1+tau)^alpha` down-weighting. A host alpha of 0.0 returns exact
    ones without a power (the bitwise-identity contract); a tensor alpha
    always computes the power, and at 0.0 that is `pow(1+tau, -0.0) == 1.0`
    exactly (IEEE-754)."""
    if _alpha_is_static_zero(alpha):
        return torch.ones_like(taus_f)
    # in float64, rounded once: the same float32 on the card and the CPU
    a = alpha if torch.is_tensor(alpha) else torch.full((), float(alpha), dtype=torch.float32, device=taus_f.device)
    return torch.pow(1.0 + taus_f.double(), -a.double()).to(taus_f.dtype)


# --------------------------------------------------------------------------- #
# Multi-tenant knob parsing: per-tenant K / alpha / latency / cohort specs.
# Shared by config validation (syntax at construction) and the FedSim
# driver (concrete stacked tensors at build).
# --------------------------------------------------------------------------- #


def parse_tenant_floats(
    spec: str, tenants: int, name: str, default: float
) -> Tuple[float, ...]:
    """Parse a comma-separated per-tenant float list. '' broadcasts
    `default` to every tenant; a single value broadcasts to the fleet;
    otherwise the list length must equal `tenants`."""
    if not spec:
        return (float(default),) * tenants
    try:
        vals = [float(tok) for tok in spec.split(",")]
    except ValueError as e:
        raise ValueError(
            f"{name}={spec!r}: every comma-separated token must be a "
            f"float ({e})"
        ) from None
    if len(vals) == 1:
        vals = vals * tenants
    if len(vals) != tenants:
        raise ValueError(
            f"{name}={spec!r}: got {len(vals)} per-tenant values for a "
            f"{tenants}-tenant fleet — give 1 (broadcast) or exactly "
            f"{tenants}"
        )
    return tuple(vals)


def _pad_latency_rows(
    rows: Sequence[Tuple[float, ...]]
) -> Tuple[Tuple[float, ...], ...]:
    """Zero-pad parsed latency rows to their common overlap depth D = max
    over rows. Padding is draw-preserving: the padded tail adds no
    probability mass, so a row's staleness draws match the ones its
    unpadded spec would produce. Shared by the per-tenant and per-class
    row parsers (one padding rule, two row families)."""
    depth = max(len(r) for r in rows)
    return tuple(r + (0.0,) * (depth - len(r)) for r in rows)


def parse_tenant_latency(
    spec: str, tenants: int, default: str
) -> Tuple[Tuple[float, ...], ...]:
    """Parse a semicolon-separated list of per-tenant latency specs (each
    one a `parse_latency` comma list), zero-padded to the fleet's common
    overlap depth D = max over tenants. '' broadcasts `default`; a single
    spec broadcasts. An EMPTY row inside a multi-row spec is rejected —
    it would silently read as zero latency for that tenant."""
    src = spec if spec else (default or "")
    if src:
        toks = src.split(";")
        if len(toks) > 1 and any(not t for t in toks):
            raise ValueError(
                f"fed_mt_latency={spec!r}: empty per-tenant row — every "
                "semicolon-separated row needs at least one weight (an "
                "empty row would silently mean zero latency)"
            )
        rows = [parse_latency(tok, name="fed_mt_latency") for tok in toks]
    else:
        rows = [(1.0,)]
    if len(rows) == 1:
        rows = rows * tenants
    if len(rows) != tenants:
        raise ValueError(
            f"fed_mt_latency={spec!r}: got {len(rows)} per-tenant latency "
            f"specs for a {tenants}-tenant fleet — give 1 (broadcast) or "
            f"exactly {tenants}"
        )
    return _pad_latency_rows(rows)


def parse_class_latency(
    class_specs: Sequence[str], default: str = ""
) -> Tuple[Tuple[float, ...], ...]:
    """Parse per-CLASS latency rows for the heterogeneous population
    plane: one `parse_latency` comma list per class, '' inheriting the
    global `default` (the fed_async_latency knob), all zero-padded to the
    population's common overlap depth D = max over classes. The rows are
    the per-class CDF table the async tick draws each client's staleness
    from (by the client's class)."""
    base = parse_latency(default or "")
    rows = [
        parse_latency(s, name=f"population class[{i}] latency") if s else base
        for i, s in enumerate(class_specs)
    ]
    return _pad_latency_rows(rows)


def make_async_client_step(
    tree_codec: TreeCodec,
    local_train: Callable[[Tree, Any], Tree],
    w_ref: Tree,
    w_hist: Optional[Tree],
    version: torch.Tensor,
    taus: torch.Tensor,
    alpha,
    step: int,
    *,
    uniforms: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
    layout=None,
    chaos=None,
    chaos_draws: Optional[Dict[int, Dict[str, Any]]] = None,
) -> ClientStep:
    """The async client body: the client at cohort position `pos` (global)
    with staleness `taus[pos]` trains from the model as of `version - tau`,
    read from the `w_hist` ring ([D, ...] tensors; None when D == 1, and
    then every client reads `w_ref`, as the synchronous step does), and its
    decoded update is weighted `1/(1+tau)^alpha` before the live-gate
    select of `cohort_updates` (the weights are finite and positive, so a
    corrupt Inf/NaN decode stays non-finite and the select removes it).
    `taus` is the GLOBAL int64[C] staleness vector on the device; the ring
    slot is gathered on the device, with no host sync."""
    if w_hist is None:
        ref = lambda positions: (w_ref, True)  # noqa: E731
    else:
        depth = next(iter(w_hist.values())).shape[0]

        def ref(positions):
            idx = position_index(positions, taus.device)
            slots = torch.remainder(version - taus[idx], depth)
            return {n: h.index_select(0, slots) for n, h in w_hist.items()}, False

    weight = None
    if not _alpha_is_static_zero(alpha):
        def weight(positions):
            idx = position_index(positions, taus.device)
            return staleness_weights(taus[idx].to(torch.float32), alpha)

    return ClientStep(tree_codec, local_train, ref, step, weight=weight, uniforms=uniforms, layout=layout,
                      chaos=chaos, chaos_draws=chaos_draws)
