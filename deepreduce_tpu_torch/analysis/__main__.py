"""CLI gate: `python -m deepreduce_tpu_torch.analysis [COMMAND] [flags]`,
ported from `python -m deepreduce_tpu.analysis`.

Commands:

- ``audit`` (default): the AST lint over the package and the run-time audit
  of every traced label with a port counterpart (``--quick``: the tier-1
  subset), each run's collectives and bytes also held to the JAX package's
  ANALYSIS.json (read as data). Exits 1 on any violation or difference.
- ``matrix``: the composition lattice through the port (config stage, build
  stage, one run of each distinct legal program), held to MATRIX.json.
  Exits 1 on a violation or a difference outside the stated deviations.
- ``mem``: the card's peak memory of the flagship fused, bucketed,
  streamed and federated traces, with the three largest tensors at the
  peak. Reported, not gated.
- ``list``: every JAX rule id with its port status, and the AST rules.

``--device`` is ``cuda`` (the default; an error without a card) or ``cpu``.
``--only RULE[,RULE]`` gates the exit code on those rules alone. ``--out
PATH`` writes the port's report there; the JAX package's ANALYSIS.json and
MATRIX.json are never written.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_BASELINES = ("ANALYSIS.json", "MATRIX.json")


def _parse_only(spec, parser):
    from deepreduce_tpu_torch.analysis.ast_lint import ALL_AST_RULES
    from deepreduce_tpu_torch.analysis.rules import ALL_RULE_IDS

    if spec is None:
        return None
    rules = [r.strip() for r in spec.split(",") if r.strip()]
    unknown = [r for r in rules if r not in ALL_RULE_IDS + ALL_AST_RULES]
    if unknown:
        parser.error(f"unknown rule(s) {', '.join(unknown)}; run `list` for the rule table")
    return set(rules)


def _gate(violations, only):
    return list(violations) if only is None else [v for v in violations if v.get("rule") in only]


def _write(report, out) -> None:
    if out is None:
        return
    Path(out).write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    print(f"wrote {out}")


def _cmd_list() -> int:
    from deepreduce_tpu_torch.analysis import lattice
    from deepreduce_tpu_torch.analysis.ast_lint import ALL_AST_RULES, AST_RULE_DESCRIPTIONS
    from deepreduce_tpu_torch.analysis.rules import RULE_DESCRIPTIONS, status_lines

    width = max(len(r) for r, *_ in status_lines())
    print("JAX rule ids and their port status:")
    for rule, status, detail in status_lines():
        print(f"  {rule:<{width}}  {status:<14}  {RULE_DESCRIPTIONS[rule]}")
        print(f"  {'':<{width}}  {'':<14}  port: {detail}")
    print("AST rules:")
    for rule in ALL_AST_RULES:
        print(f"  {rule:<{width}}  {'ported':<14}  {AST_RULE_DESCRIPTIONS[rule]}")
    print("stated deviations (a run of the port against JAX's traced program):")
    for name, text in {**lattice.TRIPS, **lattice.DEVIATIONS}.items():
        print(f"  {name:<{width}}  {text}")
    return 0


def _cmd_audit(args, only) -> int:
    from deepreduce_tpu_torch.analysis import lattice
    from deepreduce_tpu_torch.analysis.ast_lint import lint_repo
    from deepreduce_tpu_torch.analysis.audit import audit_all

    t0 = time.perf_counter()
    ast_violations = [v.to_dict() for v in lint_repo(ROOT)]
    records, violations = audit_all(quick=args.quick, device=args.device)
    violations = [v.to_dict() for v in violations]
    diffs, used = lattice.compare_analysis(lattice.load_report(ROOT / "ANALYSIS.json"), records)
    violations += [{"rule": "analysis-drift", "where": "ANALYSIS.json", "detail": d} for d in diffs]
    for r in records:
        print(f"  {r.label}: {r.collectives_by_axis or r.collectives or '-'} payload {r.payload_bytes} "
              f"selections {r.selections} ops {r.ops} census {r.census_hash}"
              + ("" if r.extra.get("card_syncs") is None else f" card syncs {r.extra['card_syncs']}"))
    _write({
        "schema": "deepreduce_tpu_torch/analysis-report/v1",
        "quick": args.quick,
        "device": args.device,
        "ast_lint": {"violations": ast_violations},
        "audit": {"traces": [r.to_dict() for r in records], "violations": violations},
        "deviations": used,
    }, args.out)
    gate = _gate(ast_violations + violations, only)
    print(f"analysis: {len(records)} traces audited on {args.device}, {len(ast_violations)} lint + "
          f"{len(violations)} audit violations" + (f" ({len(gate)} gated by --only)" if only is not None else "")
          + f", stated deviations {used}, {time.perf_counter() - t0:.1f} s")
    for v in gate:
        print(f"  [{v['rule']}] {v['where']}: {v['detail']}", file=sys.stderr)
    return 1 if gate else 0


def _cmd_matrix(args, only) -> int:
    from deepreduce_tpu_torch.analysis import lattice

    stats = {}
    t0 = time.perf_counter()
    report = lattice.build_matrix(progress=lambda m: print(f"  {m}", flush=True), stats=stats,
                                  device=args.device)
    s = report["summary"]
    print(f"matrix: {s['cells']} cells -> {s['legal']} legal / {s['rejected']} rejected "
          f"({len(s['reason_codes'])} reason codes, {s['distinct_traces']} distinct traces run), "
          f"{stats.get('cache_hits', 0)} fingerprint cache hits, {time.perf_counter() - t0:.1f} s")
    diffs, used = lattice.compare_matrix(lattice.load_report(ROOT / "MATRIX.json"), report)
    report["comparison"] = {"differences": diffs, "deviations": used}
    _write(report, args.out)
    print(f"against MATRIX.json: {len(diffs)} differences; stated deviations {used}")
    gate = _gate(report["violations"], only)
    for v in gate:
        print(f"  [{v['rule']}] {v['where']}: {v['detail']}", file=sys.stderr)
    for d in diffs:
        print(f"  [matrix-drift] {d}", file=sys.stderr)
    return 1 if (gate or diffs) else 0


def _human(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n} B" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n} B"


def _cmd_mem(args) -> int:
    from deepreduce_tpu_torch.analysis.memory import mem_report

    rows = mem_report(args.device)
    for row in rows:
        print(f"{row['label']}: peak {row['peak_bytes']} B ({_human(row['peak_bytes'])}) above "
              f"{_human(row['base_bytes'])} allocated before")
        for buf in row["top"]:
            print(f"    {_human(buf['bytes']):>10}  {buf['dtype']}{buf['shape']}  <- {buf['op']} @ {buf['site']}")
    _write({"schema": "deepreduce_tpu_torch/mem-report/v1", "device": args.device, "traces": rows}, args.out)
    print(f"memcheck: {len(rows)} flagship traces, reported (not gated)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepreduce_tpu_torch.analysis",
        description="the port's run-time audit, AST lint and composition-lattice replay",
    )
    parser.add_argument("command", nargs="?", default="audit", choices=("audit", "matrix", "mem", "list"))
    parser.add_argument("--quick", action="store_true", help="audit only the tier-1 subset")
    parser.add_argument("--only", metavar="RULE[,RULE]", default=None,
                        help="gate the exit code on these rule ids only (everything still runs)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="'cuda' (default; an error without a card) or 'cpu'")
    parser.add_argument("--out", type=Path, default=None, help="write the port's report to this path")
    args = parser.parse_args(argv)
    if args.out is not None and args.out.name in _BASELINES:
        parser.error(f"--out {args.out}: the JAX package's {args.out.name} is read as data, never written")
    if args.command == "list":
        return _cmd_list()
    only = _parse_only(args.only, parser)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("analysis: CUDA is not available; pass --device cpu to run on the CPU", file=sys.stderr)
            return 2
    if args.command == "matrix":
        return _cmd_matrix(args, only)
    if args.command == "mem":
        return _cmd_mem(args)
    return _cmd_audit(args, only)


if __name__ == "__main__":
    sys.exit(main())
