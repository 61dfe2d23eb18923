"""The port's AST lint, ported from `deepreduce_tpu/analysis/ast_lint.py`:
five rules, each scoped to the modules where its hazard is real.

- ``ast-compat-route`` (the package and `chip_smoke.py`): no `jax` and no
  `deepreduce_tpu` import. The port keeps its own copy of what it needs; the
  JAX package's rule (route `shard_map` through its compat shim) has no
  object here.
- ``ast-host-entropy`` (device-path modules): no `np.random.*`, no global
  `random.*`, no `time.time()`, and no torch draw without `generator=`.
  A draw must be a function of its stream (seed, label, step), or a run
  cannot be replayed.
- ``ast-traced-branch`` (codec modules): no Python `if`/`while` whose test
  calls into torch or reads a tensor (`.item()`, `.any()`, `.all()`,
  `.tolist()`). On the card that is a hidden host sync in the codec's hot
  path. The host codecs (`HOST_MODULES`) are out of its scope, and the
  sampled threshold's designed sync goes through `sparse.host_branch`,
  which takes the predicate as an argument.
- ``ast-span-outside-host`` (codecs/): no `telemetry.span` / `spans.span`
  and no `DumpLogger` inside a codec: spans belong to the communicator and
  driver layers.
- ``ast-mask-host-branch`` (device-path modules, train and fedavg): no
  Python `if`/`while` on a participation-mask value; `is None` presence
  gates are the one allowed branch.

Pure stdlib `ast`; it imports nothing of the package it reads.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from deepreduce_tpu_torch.analysis.rules import Violation

R_AST_COMPAT = "ast-compat-route"
R_AST_ENTROPY = "ast-host-entropy"
R_AST_BRANCH = "ast-traced-branch"
R_AST_SPAN = "ast-span-outside-host"
R_AST_MASK = "ast-mask-host-branch"

ALL_AST_RULES = (R_AST_COMPAT, R_AST_ENTROPY, R_AST_BRANCH, R_AST_SPAN, R_AST_MASK)

AST_RULE_DESCRIPTIONS = {
    R_AST_COMPAT: "the port imports no jax and nothing of deepreduce_tpu",
    R_AST_ENTROPY: "no np.random / global random / time.time() / unseeded torch draw on the device path",
    R_AST_BRANCH: "no Python branch on a torch value in a codec module (a hidden host sync)",
    R_AST_SPAN: "no telemetry span or DumpLogger inside a codec module",
    R_AST_MASK: "no Python branch on a participation-mask value (only `is None` gates)",
}

PACKAGE = "deepreduce_tpu_torch/"

# modules on the device path of a step (the drivers, CLIs, telemetry,
# tracking and the analysis itself are host-side tooling)
DEVICE_MODULES = (
    PACKAGE + "codecs/",
    PACKAGE + "ops/",
    PACKAGE + "sparse.py",
    PACKAGE + "comm.py",
    PACKAGE + "comm_bucket.py",
    PACKAGE + "comm_ring.py",
    PACKAGE + "comm_stream.py",
    PACKAGE + "memory.py",
    PACKAGE + "qar.py",
    PACKAGE + "sparse_rs.py",
    PACKAGE + "wrappers.py",
    PACKAGE + "numerics.py",
    PACKAGE + "u32.py",
    PACKAGE + "resilience/chaos.py",
    PACKAGE + "resilience/faults.py",
    PACKAGE + "resilience/stream.py",
    PACKAGE + "parallel/",
    PACKAGE + "fedsim/round.py",
    PACKAGE + "fedsim/codec_tree.py",
    PACKAGE + "fedsim/sim.py",
)

MASK_SCOPED_MODULES = DEVICE_MODULES + (PACKAGE + "train.py", PACKAGE + "fedavg.py")

CODEC_MODULES = (PACKAGE + "codecs/", PACKAGE + "sparse.py", PACKAGE + "wrappers.py")

SPAN_BANNED_MODULES = (PACKAGE + "codecs/",)

# host codecs: their payloads live on the host
HOST_MODULES = (
    PACKAGE + "codecs/host.py",
    PACKAGE + "codecs/bloom_native.py",
    PACKAGE + "codecs/huffman.py",
    PACKAGE + "codecs/gzip_codec.py",
    PACKAGE + "codecs/polyfit_host.py",
)

_SPAN_HEADS = ("telemetry", "spans")

_ENTROPY_CHAINS = (
    ("time", "time"),
    ("np", "random"),
    ("numpy", "random"),
    ("random", "seed"),
    ("random", "random"),
    ("random", "randint"),
    ("random", "uniform"),
    ("random", "choice"),
    ("random", "shuffle"),
)

# torch's draws: each must be given its generator
_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal", "poisson",
                "rand_like", "randn_like", "randint_like")
_TENSOR_DRAWS = ("uniform_", "normal_", "random_", "exponential_", "bernoulli_", "geometric_", "log_normal_",
                 "cauchy_")

# method calls that read a tensor's value on the host
_HOST_READS = ("item", "any", "all", "tolist")
# torch calls that read no tensor value
_TORCH_STATIC = ("device", "Size", "is_tensor", "is_floating_point", "is_complex", "finfo", "iinfo", "numel",
                 "get_default_dtype", "is_grad_enabled", "cuda")

_MASK_NAMES = ("mask", "masks", "participation", "row_weights")


def _attr_chain(node: ast.AST) -> List[str]:
    """`np.random.seed` -> ["np", "random", "seed"]; [] if not a pure chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _in_scope(relpath: str, scopes) -> bool:
    return any(relpath == s or relpath.startswith(s) for s in scopes)


def _import_violations(tree: ast.AST, relpath: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        elif isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "deepreduce_tpu"):
                out.append(Violation(R_AST_COMPAT, f"{relpath}:{node.lineno}",
                                     f"imports `{mod}`: the port imports no jax and nothing of the JAX package"))
    return out


def _entropy_violations(tree: ast.AST, relpath: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        bad = None
        if len(chain) >= 2 and any(chain[0] == h and chain[1] == s for h, s in _ENTROPY_CHAINS):
            bad = "host entropy"
        elif len(chain) == 2 and chain[0] == "torch" and chain[1] in _TORCH_DRAWS or (
                len(chain) >= 2 and chain[-1] in _TENSOR_DRAWS):
            if not any(k.arg == "generator" for k in node.keywords):
                bad = "a torch draw without generator="
        if bad:
            out.append(Violation(R_AST_ENTROPY, f"{relpath}:{node.lineno}",
                                 f"{bad} `{'.'.join(chain)}(...)` on the device path: draw from a stream keyed by "
                                 "(seed, label, step)"))
    return out


def _reads_torch(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain and chain[0] == "torch" and len(chain) >= 2 and chain[1] not in _TORCH_STATIC:
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_READS and not node.args:
                return True
    return False


def _branch_violations(tree: ast.AST, relpath: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While)) and _reads_torch(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append(Violation(R_AST_BRANCH, f"{relpath}:{node.lineno}",
                                 f"Python `{kind}` on a torch value in a codec module: a hidden host sync; use "
                                 "torch.where / arithmetic"))
    return out


def _span_violations(tree: ast.AST, relpath: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain:
            continue
        span_call = chain[-1] == "span" and (len(chain) == 1 or chain[0] in _SPAN_HEADS)
        if span_call or "DumpLogger" in chain:
            out.append(Violation(R_AST_SPAN, f"{relpath}:{node.lineno}",
                                 f"host-side telemetry `{'.'.join(chain)}(...)` inside a codec module: instrument "
                                 "the communicator or driver layer instead"))
    return out


def _mentions_mask(expr: ast.AST) -> bool:
    """True when `expr` reads a mask name, outside `len(...)` and the
    `.shape` / `.dtype` / `.device` of one (static properties)."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) and expr.func.id == "len":
        return False
    if isinstance(expr, ast.Attribute) and expr.attr in ("shape", "dtype", "device", "ndim"):
        return False
    if isinstance(expr, ast.Name) and expr.id in _MASK_NAMES:
        return True
    if isinstance(expr, ast.Attribute) and expr.attr in _MASK_NAMES:
        return True
    return any(_mentions_mask(child) for child in ast.iter_child_nodes(expr))


def _branches_on_mask_value(expr: ast.AST) -> bool:
    """True when the test reads a mask value, not only its presence."""
    if isinstance(expr, ast.BoolOp):
        return any(_branches_on_mask_value(v) for v in expr.values)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
        return _branches_on_mask_value(expr.operand)
    if isinstance(expr, ast.Compare) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
        return False
    return _mentions_mask(expr)


def _mask_branch_violations(tree: ast.AST, relpath: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While)) and _branches_on_mask_value(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append(Violation(R_AST_MASK, f"{relpath}:{node.lineno}",
                                 f"Python `{kind}` on a participation-mask value: the mask is per-step data; "
                                 "weight with it (only `is None` presence gates may branch)"))
    return out


def lint_source(src: str, relpath: str) -> List[Violation]:
    """Lint one module's source; `relpath` (repo-relative, forward
    slashes) selects the rules that apply."""
    tree = ast.parse(src, filename=relpath)
    out: List[Violation] = []
    if relpath.startswith(PACKAGE) or relpath == "chip_smoke.py":
        out.extend(_import_violations(tree, relpath))
    if _in_scope(relpath, DEVICE_MODULES):
        out.extend(_entropy_violations(tree, relpath))
    if _in_scope(relpath, CODEC_MODULES) and not _in_scope(relpath, HOST_MODULES):
        out.extend(_branch_violations(tree, relpath))
    if _in_scope(relpath, SPAN_BANNED_MODULES):
        out.extend(_span_violations(tree, relpath))
    if _in_scope(relpath, MASK_SCOPED_MODULES):
        out.extend(_mask_branch_violations(tree, relpath))
    return out


def lint_repo(root: Optional[Path] = None) -> List[Violation]:
    """Lint every module of the package, and `chip_smoke.py`."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    paths = sorted((root / PACKAGE).rglob("*.py"))
    if (root / "chip_smoke.py").is_file():
        paths.append(root / "chip_smoke.py")
    out: List[Violation] = []
    for path in paths:
        out.extend(lint_source(path.read_text(), path.relative_to(root).as_posix()))
    return out
