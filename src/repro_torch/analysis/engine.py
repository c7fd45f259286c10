"""mdrqlint rule engine for the port: findings, suppressions, baseline,
project runner.

Ports ``repro/analysis/engine.py``. The engine is deliberately tiny and
dependency-free (stdlib ``ast`` only): rules receive a parsed
``FileContext`` and return ``Finding`` records; the runner splits them into
*active* / *suppressed* (a ``# mdrqlint: disable=`` comment on the finding's
line, comma-separated for multiple rules) / *baselined* (listed in the
checked-in ``baseline.json`` next to this module — accepted legacy debt,
keyed by (file, rule, message) so entries survive unrelated line drift; the
port's starts empty).

Whole-program: the runner parses every file first, builds one
``callgraph.CallGraph`` over the set, and hands each rule a ``FileContext``
carrying the shared ``ProjectContext`` — so rules can resolve imports,
aliases, counted-op registrations, and method receivers across module
boundaries instead of stopping at the file edge. Baseline entries that no
longer match any finding are *stale*: they fail the run (a stale entry is a
fixed bug still wearing its waiver) until ``--prune-baseline`` drops them.

Exit codes: 0 clean; 1 findings or stale baseline entries; 2 parse errors.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.callgraph import CallGraph

_SUPPRESS_RE = re.compile(r"#\s*mdrqlint:\s*disable=([\w,\- ]+)")

DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: ``file:line rule message``."""

    file: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.file}:{self.line} {self.rule} {self.message}"

    def baseline_key(self) -> str:
        # line numbers excluded: baseline entries survive unrelated edits
        return f"{self.file}::{self.rule}::{self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProjectContext:
    """The whole-program view shared by every rule in one run.

    ``graph`` is the project call graph (symbol tables, import/alias
    resolution, counted-op registry, class method resolution); ``cache`` is
    scratch space for project-wide analyses that should run once per run,
    not once per file (e.g. the cross-module taint fixpoint).
    """

    files: "list[FileContext]"
    graph: CallGraph
    cache: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FileContext:
    """One parsed source file, handed to every rule."""

    path: Path
    posix: str  # posix path string; rules scope themselves by substring
    text: str
    tree: ast.AST
    project: Optional[ProjectContext] = None

    @classmethod
    def parse(cls, path: Path) -> "FileContext":
        text = path.read_text()
        return cls(path=path, posix=path.as_posix(), text=text,
                   tree=ast.parse(text, filename=str(path)))

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.text, node) or ""

    @property
    def module(self) -> str:
        from repro_torch.analysis.callgraph import module_name
        return module_name(self.path)


class Rule:
    """Base class: subclasses set ``rule_id`` and implement ``check``."""

    rule_id: str = ""
    doc: str = ""

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(file=ctx.posix, line=getattr(node, "lineno", 0),
                       rule=self.rule_id, message=message)


def parse_suppressions(text: str) -> dict[int, set[str]]:
    """Map line number -> set of rule ids disabled on that line.

    ``# mdrqlint: disable=host-sync,sentinel`` disables both rules on the
    line; ``disable=all`` disables every rule.
    """
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def iter_py_files(paths: Iterable[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            files.extend(f for f in sorted(p.rglob("*.py"))
                         if "__pycache__" not in f.parts)
    return files


@dataclasses.dataclass
class Report:
    """Partitioned lint results for one run.

    ``errors`` are files the engine could not parse (exit code 2 — a broken
    tree is not a clean tree, and not a finding either); ``stale_baseline``
    are accepted-debt keys matching no current finding (exit code 1 until
    pruned — the debt is paid, drop the waiver).
    """

    active: list[Finding] = dataclasses.field(default_factory=list)
    suppressed: list[Finding] = dataclasses.field(default_factory=list)
    baselined: list[Finding] = dataclasses.field(default_factory=list)
    errors: list[Finding] = dataclasses.field(default_factory=list)
    stale_baseline: list[str] = dataclasses.field(default_factory=list)
    n_files: int = 0

    @property
    def exit_code(self) -> int:
        if self.errors:
            return 2
        return 1 if (self.active or self.stale_baseline) else 0

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.active],
            "suppressed": [f.to_json() for f in self.suppressed],
            "baselined": [f.to_json() for f in self.baselined],
            "errors": [f.to_json() for f in self.errors],
            "stale_baseline": list(self.stale_baseline),
            "n_files": self.n_files,
        }

    def format(self) -> str:
        lines = [f.format() for f in self.errors]
        lines += [f.format() for f in self.active]
        for key in self.stale_baseline:
            lines.append(f"stale baseline entry (no matching finding — run "
                         f"--prune-baseline): {key}")
        lines.append(
            f"mdrqlint: {len(self.active)} finding(s) "
            f"({len(self.suppressed)} suppressed, "
            f"{len(self.baselined)} baselined, "
            f"{len(self.stale_baseline)} stale baseline entr(y/ies), "
            f"{len(self.errors)} parse error(s)) in {self.n_files} file(s)")
        return "\n".join(lines)


def load_baseline(path: Optional[Path] = None) -> set[str]:
    path = Path(path) if path is not None else DEFAULT_BASELINE
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("accepted", []))


def write_baseline(report: Report, path: Optional[Path] = None) -> Path:
    """Accept every current finding (active + baselined) as legacy debt."""
    path = Path(path) if path is not None else DEFAULT_BASELINE
    keys = sorted({f.baseline_key()
                   for f in report.active + report.baselined})
    path.write_text(json.dumps({"accepted": keys}, indent=2) + "\n")
    return path


def prune_baseline(report: Report, path: Optional[Path] = None) -> Path:
    """Drop stale baseline entries, keeping only keys that still match."""
    path = Path(path) if path is not None else DEFAULT_BASELINE
    keys = sorted({f.baseline_key() for f in report.baselined})
    path.write_text(json.dumps({"accepted": keys}, indent=2) + "\n")
    return path


def build_project(files: Iterable[Path]) -> tuple[ProjectContext,
                                                  list[Finding]]:
    """Parse every file once and build the shared whole-program context."""
    ctxs: list[FileContext] = []
    errors: list[Finding] = []
    for path in files:
        try:
            ctxs.append(FileContext.parse(path))
        except SyntaxError as e:
            errors.append(Finding(
                file=path.as_posix(), line=e.lineno or 0, rule="parse-error",
                message=f"could not parse: {e.msg}"))
    project = ProjectContext(
        files=ctxs, graph=CallGraph.build([(c.path, c.tree) for c in ctxs]))
    for ctx in ctxs:
        ctx.project = project
    return project, errors


def run(paths: Iterable[Path], rules: Iterable[Rule],
        baseline: Optional[set[str]] = None) -> Report:
    """Lint ``paths`` with ``rules``; partition findings against baseline."""
    baseline = baseline or set()
    report = Report()
    files = iter_py_files(paths)
    report.n_files = len(files)
    project, report.errors = build_project(files)
    matched_keys: set[str] = set()
    for ctx in project.files:
        suppressions = parse_suppressions(ctx.text)
        for rule in rules:
            for f in rule.check(ctx):
                disabled = suppressions.get(f.line, set())
                if f.rule in disabled or "all" in disabled:
                    report.suppressed.append(f)
                elif f.baseline_key() in baseline:
                    matched_keys.add(f.baseline_key())
                    report.baselined.append(f)
                else:
                    report.active.append(f)
    report.stale_baseline = sorted(baseline - matched_keys)
    report.active.sort()
    report.suppressed.sort()
    report.baselined.sort()
    report.errors.sort()
    return report
