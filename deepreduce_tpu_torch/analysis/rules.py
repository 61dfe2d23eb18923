"""The rule table of the port's analysis gate, ported from
`deepreduce_tpu/analysis/rules.py`.

The JAX package checks its invariants on traced programs (jaxprs): static
collective inventories, operand bytes, dtypes, sub-jaxpr structure. The
port is eager PyTorch and has no traced program, so its gate checks the same
contracts on what one run of the program does: every collective call, in
order (`recorder.Recorder`), and every aten op with its output dtypes and
shapes (`census.Census`). A traced program's static count is the run's
count with every loop's trips applied (the ring decode's one `ppermute` in
a loop of W - 2 trips is W - 2 hops in a run).

Every JAX rule id keeps its id here and has a port status (`PORT_STATUS`):
`ported` as a run-time check with the description given, `report`
(measured and printed, not gated) or `not applicable` with the reason.
`python -m deepreduce_tpu_torch.analysis list` prints the table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------- #
# rule ids: the JAX package's, one per invariant
# ---------------------------------------------------------------------- #

R_F64 = "jx-f64"
R_DYNAMIC_SHAPE = "jx-dynamic-shape"
R_UNSORTED_BUDGET_GATHER = "jx-unsorted-budget-gather"
R_GATHER_IN_MOD_QUERY = "jx-gather-in-mod-query"
R_COLLECTIVE_COUNT = "jx-collective-count"
R_WIRE_ACCOUNTING = "jx-wire-accounting"
R_CALLBACK = "jx-callback"
R_CODEC_COUNT = "jx-codec-count"
R_RETRACE = "jx-retrace"
R_RESILIENCE_OFF = "jx-resilience-off-identical"
R_CTRL_LADDER = "jx-ctrl-ladder"
R_CALIB_RESELECT = "jx-calib-reselect"
R_COLLECTIVE_SCHEDULE = "jx-collective-schedule"
R_TOKEN_DOMINANCE = "jx-token-dominance"
R_DONATION = "jx-donation-soundness"
R_KEY_LINEAGE = "jx-key-lineage"
R_PEAK_BYTES = "jx-peak-bytes"
R_DTYPE_FLOW = "jx-dtype-flow"

ALL_RULE_IDS = (
    R_F64,
    R_DYNAMIC_SHAPE,
    R_UNSORTED_BUDGET_GATHER,
    R_GATHER_IN_MOD_QUERY,
    R_COLLECTIVE_COUNT,
    R_WIRE_ACCOUNTING,
    R_CALLBACK,
    R_CODEC_COUNT,
    R_RETRACE,
    R_RESILIENCE_OFF,
    R_CTRL_LADDER,
    R_CALIB_RESELECT,
    R_COLLECTIVE_SCHEDULE,
    R_TOKEN_DOMINANCE,
    R_DONATION,
    R_KEY_LINEAGE,
    R_PEAK_BYTES,
    R_DTYPE_FLOW,
)

# the JAX package's one-line contracts, for `list`
RULE_DESCRIPTIONS = {
    R_F64: "no float64/complex128 aval anywhere in the traced hot path",
    R_DYNAMIC_SHAPE: "every aval dim is a concrete int (no per-step recompiles)",
    R_UNSORTED_BUDGET_GATHER: "budget-scale gathers/scatters declare sorted/unique indices",
    R_GATHER_IN_MOD_QUERY: "the mod-blocked bloom universe query is gather-free",
    R_COLLECTIVE_COUNT: "exact static collective inventory (flat and per mesh axis)",
    R_WIRE_ACCOUNTING: "collective operand bytes equal payload_bytes() exactly",
    R_CALLBACK: "host callbacks only inside the whitelisted host codecs",
    R_CODEC_COUNT: "exact sparsifier-selection count: O(leaves) vs O(buckets) encode",
    R_RETRACE: "two traces of the same step hash identically (no retrace drift)",
    R_RESILIENCE_OFF: "resilience=off traces byte-identical to the no-seam program",
    R_CTRL_LADDER: "controller ladder: one distinct executable per rung, host-side only",
    R_CALIB_RESELECT: "a constants-restating profile changes no selector pick or trace",
    R_COLLECTIVE_SCHEDULE: "no collective nested under data-dependent cond/while",
    R_TOKEN_DOMINANCE: "streaming barrier token chain orders encode -> all_gather -> decode",
    R_DONATION: "no equation reads a donated input after its aliased output is live",
    R_KEY_LINEAGE: "every PRNG draw's key folds from the step key; no key reuse",
    R_PEAK_BYTES: "per-trace peak live bytes match the committed budget; collective operands resident",
    R_DTYPE_FLOW: "no f64 promotion, no out-of-site payload widening, f32 output round-trip",
}

PORTED, REPORT, NOT_APPLICABLE = "ported", "report", "not applicable"

# rule -> (status, what the port checks at run time, or why it cannot)
PORT_STATUS: Dict[str, Tuple[str, str]] = {
    R_F64: (PORTED, "census: float64 ops only at the listed sites (F64_SITES); not parity, JAX's rule is red"),
    R_DYNAMIC_SHAPE: (PORTED, "census: two steps on other gradient values give the same ops, dtypes and shapes"),
    R_UNSORTED_BUDGET_GATHER: (
        NOT_APPLICABLE,
        "aten gather/scatter/index ops carry no sortedness or uniqueness flag to check; the census lists them",
    ),
    R_GATHER_IN_MOD_QUERY: (PORTED, "census: the mod-blocked bloom universe query runs no gather or index op"),
    R_COLLECTIVE_COUNT: (PORTED, "recorder: calls by op, flat and by axis, equal JAX's with loop trips applied"),
    R_WIRE_ACCOUNTING: (PORTED, "recorder: operand bytes equal payload_bytes() (allgather, ring, collective modes)"),
    R_CALLBACK: (
        PORTED,
        "census: host reads (item, nonzero, ...) only in the host codecs; on the card (census.SyncWatch) no "
        "sync under torch.cuda.set_sync_debug_mode at a package site outside them",
    ),
    R_CODEC_COUNT: (PORTED, "census: selections (aten.topk) per exchange: O(leaves), O(buckets), 2 a FedSim round"),
    R_RETRACE: (PORTED, "census: two steps with other gradient values hash the same"),
    R_RESILIENCE_OFF: (PORTED, "census: resilience off equals the run with the seams patched out"),
    R_CTRL_LADDER: (PORTED, "census: one distinct hash per rung, each a fresh exchanger's; ctrl off identical"),
    R_CALIB_RESELECT: (PORTED, "a constants-restating profile changes no costmodel pick nor the census hash"),
    R_COLLECTIVE_SCHEDULE: (
        PORTED,
        "recorder: the collective sequence (ops and bytes) is the same over gradient values and masks",
    ),
    R_TOKEN_DOMINANCE: (PORTED, "recorder + census: each streamed bucket's encode -> all_gather -> decode, in order"),
    R_DONATION: (NOT_APPLICABLE, "eager PyTorch donates no buffers: no input is aliased to an output"),
    R_KEY_LINEAGE: (
        PORTED,
        "streams: draws are a function of (seed, step, label): replay bitwise, next step differs, no shared stream",
    ),
    R_PEAK_BYTES: (
        REPORT,
        "mem on the card: the caching allocator's peak and largest blocks, printed; XLA's buffer model is not it",
    ),
    R_DTYPE_FLOW: (PORTED, "census: float64 ops only at the listed sites (F64_SITES)"),
}

# where the port computes in float64 on purpose: (module path under the
# package, function, '*' any). The exact float32 FMA of XLA's contraction,
# the QSGD bucket norms (squares summed and rooted in float64, so that the
# kernel and its plain version agree bitwise), Fit-DExp's 2x2 least squares
# and the federated round's block sums and staleness weights.
F64_SITES = (
    ("numerics.py", "fma_f32"),
    ("ops/qsgd_encode.py", "bucket_sq_sums_ordered"),
    ("ops/qsgd_encode.py", "bucket_norms_ordered"),
    ("codecs/doubleexp.py", "_lstsq2"),
    ("fedsim/round.py", "*"),
)

# where a host read (a device sync on the card) is the design
HOST_SYNC_SITES = (
    ("codecs/host.py", "*"),
    ("codecs/bloom_native.py", "*"),
    ("codecs/huffman.py", "*"),
    ("codecs/gzip_codec.py", "*"),
    ("codecs/polyfit_host.py", "*"),
    ("native/__init__.py", "*"),
)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: the rule id, the trace it broke in, and a
    detail."""

    rule: str
    where: str
    detail: str

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "where": self.where, "detail": self.detail}


@dataclasses.dataclass
class AuditContext:
    """What one trace contracts, the knobs of `AuditContext` in the JAX
    package. `expect_collectives` maps an op (the JAX primitive's name) to
    its exact count in one run; `expect_collectives_by_axis` the same per
    axis, every axis named and nothing on another. `wire_mode`
    ('allgather' | 'ring' | 'collective') and `expected_wire_bytes` hold the
    recorded operand bytes to `payload_bytes()` (on `wire_axis` only, where
    given). `expect_codec_invocations` arms the selection count,
    `expect_stream_buckets` the streamed order, `forbid_gather` the mod
    query's, `allow_host_syncs` lifts the host-read and card-sync rule
    (host codecs) and `require_key_lineage` arms the stream checks."""

    label: str
    expect_collectives: Optional[Dict[str, int]] = None
    expect_collectives_by_axis: Optional[Dict[str, Dict[str, int]]] = None
    wire_mode: Optional[str] = None
    expected_wire_bytes: Optional[int] = None
    wire_axis: Optional[str] = None
    num_workers: Optional[int] = None
    expect_codec_invocations: Optional[int] = None
    expect_stream_buckets: Optional[int] = None
    forbid_gather: bool = False
    allow_host_syncs: bool = False
    require_key_lineage: bool = False


def status_lines():
    """(rule, status, detail) for every JAX rule id, in `ALL_RULE_IDS`
    order."""
    return [(r, *PORT_STATUS[r]) for r in ALL_RULE_IDS]
