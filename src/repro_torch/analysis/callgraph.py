"""Project-wide symbol table and call graph for the port's mdrqlint.

Ports ``repro/analysis/callgraph.py``. Every project-scoped analysis
(cross-module host-sync taint, the counted-body check of
``uncounted-launch``, the budget certifier) shares this one view of the
tree:

  * **modules** — every ``.py`` file parsed once, named by its package path
    (``src/repro_torch/core/scan.py`` -> ``repro_torch.core.scan``; the
    package root is found by walking ``__init__.py`` parents: every level
    of ``src/repro_torch/`` has one, so test fixture trees resolve the same
    way the shipped tree does);
  * **imports** — ``import x.y as z`` / ``from pkg import name as alias`` /
    relative ``from . import ops`` all normalize to fully-qualified targets,
    and re-exports chain through ``__init__.py``
    (``repro_torch.core.MDRQEngine`` canonicalizes to
    ``repro_torch.core.engine.MDRQEngine``), cycle-safe;
  * **counted ops** — every ``X = ops.counted("name", doc)(impl)`` binding
    (the port's form: ``kernels/ops.py``, ``core/blockindex.py``,
    ``core/distributed.py``) and ``@ops.counted("name", doc)`` decorator in
    the project, resolved to both the public binding and the impl function,
    so a call through any alias (``from repro_torch.kernels import ops as
    o; o.multi_scan_reduce(...)``) is recognized as the counted launch it
    is;
  * **classes** — methods, resolved base classes, and ``self.attr`` types
    inferred from ``__init__`` construction sites, so ``self._scan.query(q)``
    resolves to ``ColumnarScan.query`` where the constructor argument's class
    is statically known.

Everything here is stdlib ``ast``: the lint and the budget certifier run
without torch.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Optional


def _dotted(node: Optional[ast.AST]) -> Optional[str]:
    """'ops.device_get' for Attribute chains, 'x' for Name, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def module_name(path: Path) -> str:
    """Dotted module name by walking ``__init__.py`` parents.

    ``src/repro_torch/core/scan.py`` -> ``repro_torch.core.scan``: every
    level of the package has an ``__init__.py`` and ``src/`` has none. A
    file with no package parent keeps its stem.
    """
    parts = [] if path.stem == "__init__" else [path.stem]
    d = path.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        parent = d.parent
        if parent == d:
            break
        d = parent
    return ".".join(parts) or path.stem


@dataclasses.dataclass
class FunctionInfo:
    """One function or method definition."""

    qual: str                    # repro_torch.core.scan.ColumnarScan.launch_batch
    name: str
    module: str
    cls: Optional[str]           # owning class name, or None
    node: ast.AST                # FunctionDef / AsyncFunctionDef
    decorators: tuple[str, ...]  # dotted decorator names (unresolved text)


@dataclasses.dataclass
class ClassInfo:
    """One class: methods, bases, and inferred ``self.attr`` types."""

    qual: str
    name: str
    module: str
    node: ast.ClassDef
    bases: tuple[str, ...]                  # dotted base names (module-local)
    methods: dict[str, FunctionInfo]
    attr_types: dict[str, str]              # self.<attr> -> class qual


@dataclasses.dataclass
class ModuleInfo:
    """One parsed module's symbol table."""

    name: str
    path: Path
    posix: str
    tree: ast.AST
    imports: dict[str, str]          # local name -> fully-qualified target
    functions: dict[str, FunctionInfo]
    classes: dict[str, ClassInfo]
    counted: dict[str, str]          # local binding/impl name -> op name


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One resolved call edge."""

    caller: str            # caller qual
    callee: str            # resolved callee qual (or raw dotted if unresolved)
    resolved: bool
    line: int


class CallGraph:
    """The project view: modules, functions, classes, counted ops, edges."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.counted_ops: dict[str, str] = {}   # qual -> op name

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, files: Iterable[tuple[Path, ast.AST]]) -> "CallGraph":
        """Build from (path, parsed-tree) pairs (trees parse once upstream)."""
        g = cls()
        for path, tree in files:
            g._add_module(path, tree)
        g._resolve_attr_types()
        return g

    def _add_module(self, path: Path, tree: ast.AST) -> None:
        name = module_name(path)
        mod = ModuleInfo(name=name, path=path, posix=path.as_posix(),
                         tree=tree, imports={}, functions={}, classes={},
                         counted={})
        self._collect_imports(mod)
        self._collect_defs(mod)
        self._collect_counted(mod)
        self.modules[name] = mod
        for fn in mod.functions.values():
            self.functions[fn.qual] = fn
        for ci in mod.classes.values():
            self.classes[ci.qual] = ci
            for m in ci.methods.values():
                self.functions[m.qual] = m
        for local, op in mod.counted.items():
            self.counted_ops[f"{name}.{local}"] = op

    def _collect_imports(self, mod: ModuleInfo) -> None:
        pkg = mod.name if mod.path.stem == "__init__" \
            else mod.name.rpartition(".")[0]
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname is None:
                        # ``import x.y`` binds x but makes x.y addressable
                        mod.imports.setdefault(a.name, a.name)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: anchor at this module's package
                    anchor = pkg.split(".")
                    anchor = anchor[: len(anchor) - (node.level - 1)]
                    base = ".".join(anchor + ([node.module]
                                              if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = f"{base}.{a.name}"

    def _collect_defs(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.functions[node.name] = FunctionInfo(
                    qual=f"{mod.name}.{node.name}", name=node.name,
                    module=mod.name, cls=None, node=node,
                    decorators=tuple(_dotted(d.func if isinstance(d, ast.Call)
                                             else d) or ""
                                     for d in node.decorator_list))
            elif isinstance(node, ast.ClassDef):
                cq = f"{mod.name}.{node.name}"
                methods: dict[str, FunctionInfo] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods[item.name] = FunctionInfo(
                            qual=f"{cq}.{item.name}", name=item.name,
                            module=mod.name, cls=node.name, node=item,
                            decorators=tuple(
                                _dotted(d.func if isinstance(d, ast.Call)
                                        else d) or ""
                                for d in item.decorator_list))
                mod.classes[node.name] = ClassInfo(
                    qual=cq, name=node.name, module=mod.name, node=node,
                    bases=tuple(_dotted(b) or "" for b in node.bases),
                    methods=methods, attr_types={})

    def _collect_counted(self, mod: ModuleInfo) -> None:
        """``X = counted("op", ...)(impl)`` bindings and ``@counted`` defs.

        Any callee whose dotted name ends in ``counted`` qualifies (covers
        ``counted``, ``_counted``, ``ops.counted``, and aliased imports like
        ``o.counted``) — the op name is the first string literal argument.
        """
        def op_of(call: ast.Call) -> Optional[str]:
            name = _dotted(call.func) or ""
            if not name.rsplit(".", 1)[-1].rstrip("_").lstrip("_") \
                    == "counted":
                return None
            for a in call.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    return a.value
            return None

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call) \
                    and isinstance(node.value.func, ast.Call):
                op = op_of(node.value.func)
                if op is None:
                    continue
                for tgt in node.targets:
                    n = _dotted(tgt)
                    if n:
                        mod.counted[n] = op
                for a in node.value.args:   # the wrapped impl fn
                    n = _dotted(a)
                    if n:
                        mod.counted[n] = op
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in node.decorator_list:
                    if isinstance(d, ast.Call):
                        op = op_of(d)
                        if op is not None:
                            mod.counted[node.name] = op

    def _resolve_attr_types(self) -> None:
        """Infer ``self.attr`` class types from ``__init__`` bodies.

        ``self._scan = scan`` alone is opaque, but ``self._index = index``
        next to a registration site ``BlockedIndexPath(BlockedIndex(...))``
        is not something we chase — the inference here is the direct form:
        ``self.attr = SomeClass(...)`` where ``SomeClass`` resolves to a
        project class, and ``self.attr = arg`` where the parameter carries a
        class annotation. Explicit bindings for the known adapter classes
        live in ``analysis.budget`` (config, not inference).
        """
        for ci in self.classes.values():
            init = ci.methods.get("__init__")
            if init is None:
                continue
            ann: dict[str, str] = {}
            args = init.node.args
            for a in list(args.args) + list(args.kwonlyargs):
                if a.annotation is not None:
                    d = _dotted(a.annotation)
                    if d:
                        q = self.resolve(ci.module, d)
                        if q in self.classes:
                            ann[a.arg] = q
            for node in ast.walk(init.node):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    v = node.value
                    if isinstance(v, ast.Call):
                        d = _dotted(v.func)
                        q = self.resolve(ci.module, d) if d else None
                        if q in self.classes:
                            ci.attr_types[tgt.attr] = q
                    elif isinstance(v, ast.Name) and v.id in ann:
                        ci.attr_types[tgt.attr] = ann[v.id]

    # -- resolution ---------------------------------------------------------
    def resolve(self, module: str, dotted: str,
                _seen: Optional[frozenset] = None) -> Optional[str]:
        """Resolve a dotted name as used in ``module`` to a project qual.

        Follows import aliases and ``__init__.py`` re-export chains (cycle
        safe). Returns None for builtins / third-party names.
        """
        mod = self.modules.get(module)
        if mod is None or not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if head in mod.imports:
            return self.canonicalize(
                mod.imports[head] + (f".{rest}" if rest else ""), _seen)
        if head in mod.functions or head in mod.classes \
                or head in mod.counted:
            return self.canonicalize(f"{module}.{dotted}", _seen)
        return None

    def canonicalize(self, qual: str,
                     _seen: Optional[frozenset] = None) -> Optional[str]:
        """Follow re-export chains until ``qual`` names a real definition."""
        _seen = _seen or frozenset()
        if qual in _seen:
            return None  # import cycle: stop, stay unresolved
        _seen = _seen | {qual}
        # longest module prefix owning this qual
        parts = qual.split(".")
        for i in range(len(parts), 0, -1):
            prefix = ".".join(parts[:i])
            mod = self.modules.get(prefix)
            if mod is None:
                continue
            rest = parts[i:]
            if not rest:
                return prefix  # the module itself
            head = rest[0]
            if head in mod.functions or head in mod.classes \
                    or head in mod.counted:
                return qual
            if head in mod.imports:
                target = mod.imports[head] + \
                    ("." + ".".join(rest[1:]) if rest[1:] else "")
                return self.canonicalize(target, _seen)
            return qual  # module exists but symbol is dynamic; keep literal
        return qual if any(qual.startswith(m + ".") or qual == m
                           for m in self.modules) else None

    def lookup_method(self, class_qual: str, meth: str,
                      _seen: Optional[frozenset] = None
                      ) -> Optional[FunctionInfo]:
        """Resolve ``meth`` on ``class_qual``, walking base classes."""
        _seen = _seen or frozenset()
        if class_qual in _seen:
            return None
        ci = self.classes.get(class_qual)
        if ci is None:
            return None
        if meth in ci.methods:
            return ci.methods[meth]
        for b in ci.bases:
            bq = self.resolve(ci.module, b)
            if bq:
                hit = self.lookup_method(bq, meth, _seen | {class_qual})
                if hit is not None:
                    return hit
        return None

    def counted_op(self, module: str, dotted: str) -> Optional[str]:
        """The op name if ``dotted`` (as used in ``module``) is counted."""
        q = self.resolve(module, dotted)
        return self.counted_ops.get(q) if q else None

    def is_device_get(self, module: str, dotted: str) -> bool:
        """Whether ``dotted`` resolves to the counted ``ops.device_get``."""
        if dotted.rsplit(".", 1)[-1] != "device_get":
            return False
        q = self.resolve(module, dotted)
        # unresolved ``ops.device_get`` in a fixture still counts by shape
        return q is None or q.endswith(".device_get")

    # -- call edges (for tests and future rules) ----------------------------
    def callees(self, fn: FunctionInfo) -> list[CallSite]:
        """Best-effort resolved call edges out of one function."""
        out: list[CallSite] = []
        ci = self.classes.get(f"{fn.module}.{fn.cls}") if fn.cls else None
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if not d:
                continue
            target: Optional[str] = None
            if d.startswith("self.") and ci is not None:
                rest = d[len("self."):]
                head, _, meth = rest.partition(".")
                if not meth:
                    hit = self.lookup_method(ci.qual, head)
                    target = hit.qual if hit else None
                elif head in ci.attr_types and "." not in meth:
                    hit = self.lookup_method(ci.attr_types[head], meth)
                    target = hit.qual if hit else None
            else:
                target = self.resolve(fn.module, d)
            out.append(CallSite(caller=fn.qual, callee=target or d,
                                resolved=target is not None,
                                line=node.lineno))
        return out
