"""CLI: ``python -m repro_torch.analysis [paths...]``.

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --budget BUDGET_torch.json
    PYTHONPATH=src python -m repro_torch.analysis --budget-check BUDGET_torch.json

Exit codes: 0 clean; 1 findings, stale baseline entries or a stale
certificate; 2 parse/usage errors. The paths default to ``src/repro_torch``
(run from the repository root); the certificate is derived from the same
tree.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import (DEFAULT_BASELINE, build_project,
                                   iter_py_files, load_baseline,
                                   prune_baseline, run, write_baseline)
from repro_torch.analysis.rules import ALL_RULES

DEFAULT_PATHS = ["src/repro_torch"]


def _budget(paths: list[str], out: str | None, check: str | None) -> int:
    """Certify launch/sync budgets; write or diff the certificate."""
    from repro_torch.analysis import budget

    files = iter_py_files([Path(p) for p in paths])
    project, errors = build_project(files)
    if errors:
        for e in errors:
            print(e.format())
        return 2
    try:
        if check is not None:
            drift = budget.check(project.graph, Path(check))
            if drift:
                print(f"mdrqlint: budget certificate {check} is stale "
                      f"({len(drift)} difference(s)) — regenerate with "
                      f"`--budget {check}` and review the diff:")
                for line in drift:
                    print(f"  {line}")
                return 1
            print(f"mdrqlint: budget certificate {check} matches the source")
            return 0
        cert = budget.certify(project.graph)
        text = budget.render(cert)
        if out is None or out == "-":
            print(text, end="")
        else:
            Path(out).write_text(text)
            print(f"mdrqlint: wrote budget certificate to {out}")
        return 0
    except budget.BudgetError as e:
        print(f"mdrqlint: budget certification failed: {e}")
        return 2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="mdrqlint for the PyTorch/CUDA port: whole-program "
                    "static checks for launch/host-sync/sentinel/lock/"
                    "registry/thread-boundary invariants, plus the launch/"
                    "sync budget certifier")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write the full report as JSON")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="drop stale baseline entries (keys matching no "
                         "current finding)")
    ap.add_argument("--budget", metavar="FILE", nargs="?", const="-",
                    default=None,
                    help="derive the static launch/sync budget certificate "
                         "and write it to FILE (stdout if omitted)")
    ap.add_argument("--budget-check", metavar="FILE", default=None,
                    help="diff the checked-in budget certificate against a "
                         "fresh derivation; exit 1 on drift")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids and the invariants they encode")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}: {rule.doc}")
        return 0

    if args.budget is not None or args.budget_check is not None:
        # budgets are a property of the package, not of the scripts
        # driving it
        return _budget(args.paths, args.budget, args.budget_check)

    baseline_path = Path(args.baseline) if args.baseline else None
    report = run([Path(p) for p in args.paths], ALL_RULES,
                 baseline=load_baseline(baseline_path))

    if args.write_baseline:
        path = write_baseline(report, baseline_path)
        print(f"mdrqlint: wrote {len(report.active) + len(report.baselined)} "
              f"accepted finding(s) to {path}")
        return 0
    if args.prune_baseline:
        path = prune_baseline(report, baseline_path)
        print(f"mdrqlint: pruned {len(report.stale_baseline)} stale "
              f"entr(y/ies) from {path} "
              f"({len(report.baselined)} kept)")
        return 0

    if args.json:
        Path(args.json).write_text(
            json.dumps(report.to_json(), indent=2) + "\n")
    print(report.format())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
