"""graftlint CLI: ``python -m unionml_tpu_torch.analysis [paths] [--json OUT]``.

Exit codes: 0 clean, 1 findings (or blown ``--budget``), 2 bad invocation.
Findings always fail the run — ``--fail-on-findings`` exists so CI scripts
state the contract explicitly; ``--no-fail-on-findings`` turns the run
advisory (report only).

Scoped runs: ``--only FAMILY[,FAMILY...]`` selects whole rule families
(``races``, ``locks``, ``host_sync``, ...; see ``--list-rules``) instead of
naming individual rules; ``--paths FILE [FILE...]`` is the incremental /
pre-commit mode — the full scan still runs (interprocedural passes need the
whole call graph) but only findings located in the named files are reported.
``--timings`` prints per-family wall time after the summary.

CI surfaces: ``--sarif OUT`` writes a SARIF 2.1.0 report (GitHub
code-scanning upload → findings annotate PRs inline); ``--baseline FILE``
silences findings recorded in FILE (new ones still fail) so a widened lint
scope can land incrementally; ``--write-baseline FILE`` records the current
findings as that inventory. ``--budget SECONDS`` enforces the lint-runtime
contract: the wall time is always printed, and a run slower than the budget
fails even when finding-free — a linter nobody waits for is a linter that
gets skipped.
"""

import argparse
import sys
import time

from unionml_tpu_torch.analysis.core import (
    RULES,
    baseline_payload,
    families,
    load_baseline,
    run_lint,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m unionml_tpu_torch.analysis",
        description="graftlint for the PyTorch port: static analysis "
                    "(host-sync, recapture, lock-discipline, lock-order, "
                    "async-blocking, races, resources)",
    )
    parser.add_argument("paths", nargs="*", default=["unionml_tpu_torch"],
                        help="files or directories to lint (default: unionml_tpu_torch)")
    parser.add_argument("--rules", help="comma-separated rule subset (default: all)")
    parser.add_argument("--only", metavar="FAMILY", dest="only",
                        help="comma-separated rule FAMILY subset (e.g. races,locks); "
                             "see --list-rules for the catalog")
    parser.add_argument("--paths", metavar="FILE", dest="report_paths", nargs="+",
                        help="incremental mode: scan the full tree for context but "
                             "report only findings located in these files")
    parser.add_argument("--timings", action="store_true",
                        help="print per-family wall time after the summary")
    parser.add_argument("--json", metavar="OUT", dest="json_out",
                        help="write the machine-readable report to OUT ('-' for stdout)")
    parser.add_argument("--sarif", metavar="OUT", dest="sarif_out",
                        help="write a SARIF 2.1.0 report to OUT ('-' for stdout)")
    parser.add_argument("--baseline", metavar="FILE",
                        help="silence findings recorded in FILE (new findings still fail)")
    parser.add_argument("--write-baseline", metavar="FILE", dest="write_baseline",
                        help="record the current findings to FILE and exit 0")
    parser.add_argument("--budget", type=float, metavar="SECONDS",
                        help="fail the run when lint wall time exceeds SECONDS")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    parser.add_argument("--fail-on-findings", dest="fail", action="store_true", default=True,
                        help="exit non-zero when findings remain (default)")
    parser.add_argument("--no-fail-on-findings", dest="fail", action="store_false",
                        help="advisory mode: report but exit 0")
    args = parser.parse_args(argv)

    if args.list_rules:
        from unionml_tpu_torch.analysis.core import _load_rule_modules

        _load_rule_modules()
        for name in sorted(RULES):
            print(f"{name:16s} [{RULES[name].family}] {RULES[name].summary}")
        print("suppression      (always on) graftlint comments need a known rule and a reason")
        return 0

    if args.rules and args.only:
        print("graftlint: --rules and --only are mutually exclusive", file=sys.stderr)
        return 2
    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
    if args.only:
        catalog = families()
        wanted = [f.strip() for f in args.only.split(",") if f.strip()]
        unknown = [f for f in wanted if f not in catalog]
        if unknown:
            print(
                f"graftlint: unknown family(ies): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(catalog))})",
                file=sys.stderr,
            )
            return 2
        rules = sorted({name for f in wanted for name in catalog[f]})
    baseline = None
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as exc:
            print(f"graftlint: cannot read baseline: {exc}", file=sys.stderr)
            return 2
    t0 = time.perf_counter()
    try:
        result = run_lint(
            args.paths or ["unionml_tpu_torch"], rules,
            baseline=baseline, restrict=args.report_paths,
        )
    except ValueError as exc:
        print(f"graftlint: {exc}", file=sys.stderr)
        return 2
    wall_s = time.perf_counter() - t0

    if args.write_baseline:
        import json as _json

        with open(args.write_baseline, "w") as fh:
            _json.dump(baseline_payload(result.findings), fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(
            f"graftlint: wrote baseline with {len(result.findings)} finding(s) "
            f"to {args.write_baseline}"
        )
        return 0

    for finding in result.findings:
        print(finding.format())
    summary = (
        f"graftlint: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed, "
        f"{len(result.baselined)} baselined, {result.files} file(s), "
        f"wall {wall_s:.2f}s"
        + (f" (budget {args.budget:.0f}s)" if args.budget else "")
    )
    print(summary, file=sys.stderr if result.findings else sys.stdout)
    if args.timings:
        for fam, fam_s in sorted(result.timings.items(), key=lambda kv: -kv[1]):
            print(f"graftlint:   {fam:12s} {fam_s:6.2f}s")

    if args.json_out:
        payload = result.report_json() + "\n"
        if args.json_out == "-":
            sys.stdout.write(payload)
        else:
            with open(args.json_out, "w") as fh:
                fh.write(payload)
    if args.sarif_out:
        payload = result.sarif_json() + "\n"
        if args.sarif_out == "-":
            sys.stdout.write(payload)
        else:
            with open(args.sarif_out, "w") as fh:
                fh.write(payload)

    if args.budget is not None and wall_s > args.budget:
        print(
            f"graftlint: wall time {wall_s:.2f}s blew the {args.budget:.0f}s budget",
            file=sys.stderr,
        )
        return 1
    return 1 if (result.findings and args.fail) else 0


if __name__ == "__main__":
    sys.exit(main())
