"""The port's call graph (``repro_torch.analysis.callgraph``): aliased
imports, decorator-registered counted launches, the port's
``name = ops.counted("name", doc)(fn)`` form, ``__init__.py`` re-export
chains, import cycles, base-class method resolution, inferred attribute
types, and module naming on a package whose every level has an
``__init__.py``. Mirrors ``tests/test_callgraph.py``.

Fixture projects are written to tmp dirs with real ``__init__.py`` files so
``module_name`` derives the same dotted names the rules match against.
"""
from __future__ import annotations

import ast
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import engine
from repro_torch.analysis.callgraph import CallGraph, module_name
from repro_torch.analysis.rules import HostSyncRule

REPO = Path(__file__).resolve().parents[1]


def write_tree(tmp_path: Path, files: dict[str, str]) -> list[Path]:
    paths = []
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        # every package level needs an __init__.py for module_name to walk
        d = p.parent
        while d != tmp_path:
            init = d / "__init__.py"
            if not init.exists():
                init.touch()
            d = d.parent
        paths.append(p)
    return paths


def build_graph(tmp_path: Path, files: dict[str, str]) -> CallGraph:
    write_tree(tmp_path, files)
    pairs = [(p, ast.parse(p.read_text()))
             for p in sorted(tmp_path.rglob("*.py"))]
    return CallGraph.build(pairs)


def test_aliased_import_resolves_counted_op(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/kernels/myops.py": """\
            def counted(name, doc):
                def deco(fn):
                    return fn
                return deco
            def _impl(batch):
                return batch
            big_scan = counted("big_scan_op", "A counted op.")(_impl)
            """,
        "repro_torch/serve/user.py": """\
            from repro_torch.kernels import myops as o
            def drive(batch):
                return o.big_scan(batch)
            """,
    })
    assert g.counted_op("repro_torch.serve.user", "o.big_scan") \
        == "big_scan_op"
    # the wrapped impl is registered under the same op
    assert g.counted_op("repro_torch.kernels.myops", "_impl") == "big_scan_op"


def test_port_ops_counted_form_across_modules(tmp_path):
    """``prune = ops.counted("prune", doc)(_prune)`` in a core module (as
    ``core/blockindex.py`` and ``core/distributed.py`` register theirs),
    with a decorated impl, resolves from a third module."""
    g = build_graph(tmp_path, {
        "repro_torch/kernels/ops.py": """\
            def counted(name, doc):
                def deco(fn):
                    def wrapper(*args, **kwargs):
                        return fn(*args, **kwargs)
                    return wrapper
                return deco

            def _scan(x):
                return x

            multi_scan_reduce = counted("multi_scan_reduce", "Fused.")(_scan)
            """,
        "repro_torch/core/blockindex.py": """\
            import functools
            from repro_torch.kernels import ops

            def _on_first(fn):
                @functools.wraps(fn)
                def wrapper(*a):
                    return fn(*a)
                return wrapper

            @_on_first
            def _prune(q):
                return q

            prune_hierarchy_batch = ops.counted(
                "prune_hierarchy_batch", "Batched prune.")(_prune)
            """,
        "repro_torch/core/scan.py": """\
            from repro_torch.core.blockindex import prune_hierarchy_batch
            from repro_torch.kernels import ops

            def launch(q):
                return prune_hierarchy_batch(q), ops.multi_scan_reduce(q)
            """,
    })
    assert g.counted_op("repro_torch.core.scan", "prune_hierarchy_batch") \
        == "prune_hierarchy_batch"
    assert g.counted_op("repro_torch.core.scan", "ops.multi_scan_reduce") \
        == "multi_scan_reduce"
    assert g.counted_op("repro_torch.core.blockindex", "_prune") \
        == "prune_hierarchy_batch"
    assert g.counted_op("repro_torch.kernels.ops", "counted") is None
    assert g.counted_ops["repro_torch.kernels.ops._scan"] \
        == "multi_scan_reduce"


def test_decorator_registered_counted_launch(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/kernels/deco.py": """\
            from repro_torch.kernels.myops import counted

            @counted("deco_op", "A counted op.")
            def fused(batch):
                return batch
            """,
        "repro_torch/kernels/myops.py": """\
            def counted(name, doc):
                def deco(fn):
                    return fn
                return deco
            """,
        "repro_torch/core/user.py": """\
            from repro_torch.kernels.deco import fused
            def drive(batch):
                return fused(batch)
            """,
    })
    assert g.counted_op("repro_torch.kernels.deco", "fused") == "deco_op"
    assert g.counted_op("repro_torch.core.user", "fused") == "deco_op"


def test_reexport_through_init_resolves(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/kernels/myops.py": """\
            def counted(name, doc):
                def deco(fn):
                    return fn
                return deco

            @counted("exported_op", "A counted op.")
            def big_scan(batch):
                return batch
            """,
        "repro_torch/kernels/__init__.py": """\
            from repro_torch.kernels.myops import big_scan
            """,
        "repro_torch/serve/user.py": """\
            from repro_torch.kernels import big_scan
            def drive(batch):
                return big_scan(batch)
            """,
    })
    # canonicalize follows the __init__ re-export to the real definition
    assert g.resolve("repro_torch.serve.user", "big_scan") \
        == "repro_torch.kernels.myops.big_scan"
    assert g.counted_op("repro_torch.serve.user", "big_scan") \
        == "exported_op"


def test_relative_import_resolves(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/core/engine.py": """\
            class MDRQEngine:
                def launch_batch(self, batch):
                    return batch
            """,
        "repro_torch/core/__init__.py": """\
            from .engine import MDRQEngine
            """,
        "repro_torch/serve/user.py": """\
            from ..core import MDRQEngine
            """,
    })
    assert g.resolve("repro_torch.serve.user", "MDRQEngine") \
        == "repro_torch.core.engine.MDRQEngine"


def test_import_cycle_is_cycle_safe(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/core/a.py": """\
            from repro_torch.core.b import thing
            """,
        "repro_torch/core/b.py": """\
            from repro_torch.core.a import thing
            """,
        "repro_torch/core/user.py": """\
            from repro_torch.core.a import thing
            def drive():
                return thing()
            """,
    })
    # neither module defines `thing`; the chain a -> b -> a terminates
    assert g.resolve("repro_torch.core.user", "thing") is None


def test_method_resolution_walks_bases(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/core/base.py": """\
            class BasePath:
                def query_batch(self, batch):
                    return batch
            """,
        "repro_torch/core/paths.py": """\
            from repro_torch.core.base import BasePath
            class FancyPath(BasePath):
                def launch_batch(self, batch):
                    return batch, None
            """,
    })
    hit = g.lookup_method("repro_torch.core.paths.FancyPath", "query_batch")
    assert hit is not None
    assert hit.qual == "repro_torch.core.base.BasePath.query_batch"


def test_attr_types_from_init_construction_and_annotation(tmp_path):
    g = build_graph(tmp_path, {
        "repro_torch/core/scan.py": """\
            class ColumnarScan:
                def query_batch(self, batch):
                    return batch
            """,
        "repro_torch/core/paths.py": """\
            from repro_torch.core.scan import ColumnarScan
            class DirectPath:
                def __init__(self):
                    self._scan = ColumnarScan()
            class AnnotatedPath:
                def __init__(self, scan: ColumnarScan):
                    self._scan = scan
            """,
    })
    assert g.classes["repro_torch.core.paths.DirectPath"] \
        .attr_types["_scan"] == "repro_torch.core.scan.ColumnarScan"
    assert g.classes["repro_torch.core.paths.AnnotatedPath"] \
        .attr_types["_scan"] == "repro_torch.core.scan.ColumnarScan"
    fi = g.functions["repro_torch.core.paths.DirectPath.__init__"]
    assert any(c.callee == "repro_torch.core.scan.ColumnarScan"
               for c in g.callees(fi))


def test_cross_module_host_sync_rides_aliased_import(tmp_path):
    """A raw ``.cpu()`` around an aliased counted launch in another module
    is a host-sync finding — the taint crosses files."""
    files = {
        "repro_torch/kernels/myops.py": """\
            def counted(name, doc):
                def deco(fn):
                    return fn
                return deco

            @counted("big_scan_op", "A counted op.")
            def big_scan(batch):
                return batch
            """,
        "repro_torch/serve/user.py": """\
            from repro_torch.kernels import myops as o

            def drive(batch):
                return o.big_scan(batch).cpu()
            """,
    }
    paths = write_tree(tmp_path, files)
    rep = engine.run(paths, [HostSyncRule()])
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert "serve/user.py" in rep.active[0].file


def test_cross_module_host_sync_rides_returning_helpers(tmp_path):
    """A helper in one module returning a counted launch's payload taints
    its caller in another (the project-wide fixpoint)."""
    files = {
        "repro_torch/kernels/ops.py": """\
            def counted(name, doc):
                def deco(fn):
                    return fn
                return deco

            def _scan(q):
                return q

            multi_scan_reduce = counted("multi_scan_reduce", "Fused.")(_scan)
            """,
        "repro_torch/core/scan.py": """\
            from repro_torch.kernels import ops

            class ColumnarScan:
                def launch(self, q):
                    return ops.multi_scan_reduce(q)
            """,
        "repro_torch/core/paths.py": """\
            from repro_torch.core.scan import ColumnarScan

            class ScanPath:
                def __init__(self):
                    self._scan = ColumnarScan()

                def peek(self, q):
                    return self._scan.launch(q).tolist()
            """,
    }
    paths = write_tree(tmp_path, files)
    rep = engine.run(paths, [HostSyncRule()])
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert "core/paths.py" in rep.active[0].file
    assert ".tolist()" in rep.active[0].message


def test_module_name_on_the_port_tree():
    """Every level of ``src/repro_torch/`` has an ``__init__.py``; module
    names come out rooted at ``repro_torch``."""
    src = REPO / "src" / "repro_torch"
    assert module_name(src / "core" / "paths.py") == "repro_torch.core.paths"
    assert module_name(src / "numerics.py") == "repro_torch.numerics"
    assert module_name(src / "kernels" / "__init__.py") \
        == "repro_torch.kernels"
    assert module_name(src / "analysis" / "budget.py") \
        == "repro_torch.analysis.budget"


def test_module_name_in_tmp_src_layout(tmp_path):
    p = tmp_path / "src" / "mypkg" / "sub" / "mod.py"
    p.parent.mkdir(parents=True)
    (p.parent / "__init__.py").touch()
    (p.parent.parent / "__init__.py").touch()
    p.write_text("X = 1\n")
    assert module_name(p) == "mypkg.sub.mod"
    # a file with no package parent keeps its stem
    lone = tmp_path / "lone.py"
    lone.write_text("X = 1\n")
    assert module_name(lone) == "lone"


def test_port_graph_registers_every_counted_op():
    """The shipped tree: every ``ops.counted`` registration of the port is
    in the registry under its op name."""
    project, errors = engine.build_project(
        engine.iter_py_files([REPO / "src" / "repro_torch"]))
    assert errors == []
    ops = set(project.graph.counted_ops.values())
    assert {"multi_scan_reduce", "multi_scan_vertical_reduce",
            "multi_visit_reduce", "multi_va_filter", "prune_hierarchy_batch",
            "prune_hierarchy", "distributed_multi_reduce", "mask_counts",
            "kv_visit_attention"} <= ops
    assert project.graph.counted_op("repro_torch.core.scan",
                                    "ops.multi_scan_reduce") \
        == "multi_scan_reduce"


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
