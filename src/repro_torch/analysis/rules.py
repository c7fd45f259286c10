"""The port's seven mdrqlint rules (the three kernel-contract rules are in
``analysis.contracts``).

Ports ``repro/analysis/rules.py``. Each rule keeps its reference id and the
invariant the engine's perf/correctness story depends on, pointed at
``src/repro_torch/`` (every rule scopes itself to paths holding
``/repro_torch/``):

==================  =========================================================
rule id             invariant
==================  =========================================================
host-sync           device->host transfers route through ``ops.device_get``
                    (counted): never ``np.asarray``/``np.array``/``float``/
                    ``int``/``bool`` of a device value, ``.item()``/
                    ``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")`` on
                    one, or a raw ``torch.cuda.synchronize``/``.synchronize()``
uncounted-launch    in ``kernels/`` and ``core/``, a call into the compiled
                    extension (``_build.launch``/``_build.library``) or into a
                    wrapper module (``multi_scan``, ``range_scan``,
                    ``reducers``, ``va_filter``, ``kv_visit``) happens only
                    inside a counted body
raw-shard-map       copies between devices (``.to(<device>)``, ``.cuda()``,
                    ``copy_``) only in ``core/distributed.py``
                    (``DataMesh.replicate``/``gather``); an upload of a host
                    tensor made in the same expression is not a mesh copy
sentinel            no hardcoded ``3e38``-family extrema / ``inf``-into-
                    unknown-dtype casts; use ``repro_torch.numerics`` or
                    ``core.types.finite_query_bounds``
lock-discipline     attrs ever written under ``self._lock``/``_ingest_lock``
                    are never written off-lock (outside ``__init__``);
                    ``_state`` swaps are single assignments under the ingest
                    lock; ``_state`` is never mutated in place
registry-hygiene    ``@register_result_spec`` classes are frozen dataclasses
                    (specs are part of the ops' warm keys and of the engine's
                    plan: hashable and immutable); registry classes carry no
                    mutable class-level defaults
thread-boundary     a ``@device_stage`` function never calls
                    ``ops.device_get`` and never parks a device value on
                    ``self``
==================  =========================================================

The host-sync rule is a *taint-lite* dataflow pass: device values enter a
function through counted ``ops.*`` calls (not the host helpers of
``_OPS_HOST_FNS``), ``launch_batch`` (the split protocol's in-flight
payload), or functions that return tainted values; taint propagates through
assignment/unpacking/subscripts/arithmetic and through calls carrying
tainted arguments; ``ops.device_get`` launders taint (it *is* the counted
sync). Tainted-returning functions are a *project-wide* fixpoint over the
call graph, so a device value returned by
``core.scan.ColumnarScan.launch_batch`` stays tainted through a helper in
another module, aliased imports resolve to the counted registry, and
``self.<attr>.method(...)`` calls resolve through inferred attribute types.
Per-file analysis remains the fallback when no project is attached. A
tensor's metadata (``len()``, ``.shape``, ``.size``/``.size()``,
``.dtype``, ``.device``, ``.numel()``, ...) is host data in PyTorch and
carries no taint. The taint pass cannot tell a host tensor from a device
one: a sink on host data it flags is suppressed inline with its reason.

``uncounted-launch`` is project-wide too. A *counted body* is a function
registered through ``ops.counted`` (binding or impl), or one whose every
reference in the project — a call, or the function passed as a value — sits
in a counted body (a fixpoint; a method call on a receiver the call graph
cannot type refers to every project method of that name). Every function
of a wrapper module counts as a launch: the modules are the device layer. A
host helper of theirs used outside a counted body (the build's
``va_filter.pack_codes``) carries an inline suppression with its reason.

The host-sync rule also covers the port's examples (``examples/*_torch.py``),
as the reference's covers ``examples/``: an uncounted coercion there would
hide a sync from the numbers the example prints. Three kernel-contract rules
(``kernel-tile``, ``kernel-dtype``, ``note-trace``) live in
``analysis.contracts`` and are re-exported through ``ALL_RULES`` here.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.engine import (FileContext, Finding, ProjectContext,
                                         Rule)

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: Optional[ast.AST]) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains, 'x' for Name, else
    None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _in_port(posix: str) -> bool:
    return "/repro_torch/" in posix or posix.startswith("repro_torch/")


def _in_sync_scope(posix: str) -> bool:
    """host-sync scope: the package plus the port's examples, which drive
    it and print what they measure."""
    if _in_port(posix):
        return True
    in_examples = "/examples/" in posix or posix.startswith("examples/")
    return in_examples and posix.endswith("_torch.py")


def _functions_with_class(tree: ast.AST) -> list[tuple[ast.AST,
                                                       Optional[str]]]:
    """Every function def in the tree, with its immediate owning class."""
    out: list[tuple[ast.AST, Optional[str]]] = []
    method_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((item, node.name))
                    method_ids.add(id(item))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) not in method_ids:
            out.append((node, None))
    return out


# ---------------------------------------------------------------------------
# rule 1: host-sync — taint-lite device->host coercion check
# ---------------------------------------------------------------------------

# ops.* helpers that return HOST data (or are pure bookkeeping): calls to
# these are not device-value sources, and device_get launders taint.
_OPS_HOST_FNS = {"device_get", "counter", "counters", "reset_counters",
                 "kernel_launches", "reset_kernel_launches", "counted",
                 "check_backend", "prepare_columnar", "warm_key", "warm_keys",
                 "clear_warm_keys", "trace_log", "reset_trace_log"}
# calls whose result is an in-flight device payload, whatever the receiver
_DEVICE_SOURCES = {"launch_batch"}
_RAW_SYNC_FNS = {"torch.cuda.synchronize", "cuda.synchronize"}
_CAST_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "float", "int", "bool"}
# tensor methods that copy a device value to the host (and wait for it)
_TENSOR_SINKS = {"item", "tolist", "cpu", "numpy"}
# A tensor's metadata lives on the host: reading it never syncs, so it
# carries no taint (attributes, and methods returning host values).
_HOST_META_ATTRS = {"shape", "size", "dtype", "device", "ndim", "is_cuda"}
_HOST_META_METHODS = {"size", "dim", "numel", "stride", "data_ptr",
                      "element_size", "get_device", "is_contiguous"}


def _is_cpu_target(call: ast.Call) -> bool:
    """Whether ``x.to(...)`` names the CPU: ``"cpu"``, ``device="cpu"`` or
    ``torch.device("cpu")``."""
    def cpu(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return e.value.split(":")[0] == "cpu"
        if isinstance(e, ast.Call) and (_dotted(e.func) or "").endswith(
                "device") and e.args:
            return cpu(e.args[0])
        return False
    return any(cpu(a) for a in call.args) or any(
        k.arg == "device" and cpu(k.value) for k in call.keywords)


class _FnTaint:
    """One function's taint pass: flags sinks fed by device values."""

    def __init__(self, rule: "HostSyncRule", ctx: FileContext,
                 tainted_returning: set[str], collect_only: bool,
                 xmod: "Optional[_CrossModule]" = None):
        self.rule = rule
        self.ctx = ctx
        self.tainted_returning = tainted_returning
        self.collect_only = collect_only
        self.xmod = xmod
        self.tainted: set[str] = set()
        self.returns_tainted = False
        self.findings: list[Finding] = []

    # -- statements ---------------------------------------------------------
    def run(self, fn: ast.AST) -> None:
        body = getattr(fn, "body", [])
        # two passes: monotone taint set converges for use-before-def within
        # loops; findings only recorded on the second pass
        self.collecting = True
        self.block(body)
        self.collecting = False
        if not self.collect_only:
            self.block(body)

    def block(self, stmts: list[ast.stmt]) -> None:
        for s in stmts:
            self.stmt(s)

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            t = self.expr(s.value)
            for tgt in s.targets:
                self.bind(tgt, t)
        elif isinstance(s, ast.AugAssign):
            t = self.expr(s.value) or self.expr(s.target)
            self.bind(s.target, t)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.bind(s.target, self.expr(s.value))
        elif isinstance(s, ast.Return):
            if s.value is not None and self.expr(s.value):
                self.returns_tainted = True
        elif isinstance(s, ast.Expr):
            self.expr(s.value)
        elif isinstance(s, (ast.If, ast.While)):
            self.expr(s.test)
            self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.For):
            if self.expr(s.iter):
                self.bind(s.target, True)
            self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                t = self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, t)
            self.block(s.body)
        elif isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            pass  # nested scopes analyzed separately
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child)

    def bind(self, tgt: ast.AST, tainted: bool) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self.bind(e, tainted)
            return
        if isinstance(tgt, ast.Starred):
            self.bind(tgt.value, tainted)
            return
        name = _dotted(tgt)
        if tainted and name:
            self.tainted.add(name)

    # -- expressions --------------------------------------------------------
    def flag(self, node: ast.AST, message: str) -> None:
        if not self.collecting and not self.collect_only:
            self.findings.append(self.rule.finding(self.ctx, node, message))

    def expr(self, e: Optional[ast.AST]) -> bool:
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            d = _dotted(e)
            base = self.expr(e.value)
            if e.attr in _HOST_META_ATTRS:
                return False
            return base or (d in self.tainted)
        if isinstance(e, ast.Call):
            return self.call(e)
        if isinstance(e, ast.Lambda):
            return False  # opaque; bodies get no device values in this repo
        # generic: any tainted child taints the expression
        t = False
        for child in ast.iter_child_nodes(e):
            if isinstance(child, (ast.expr, ast.comprehension, ast.keyword,
                                  ast.arguments)):
                t = self.expr_child(child) or t
        return t

    def expr_child(self, child: ast.AST) -> bool:
        if isinstance(child, ast.keyword):
            return self.expr(child.value)
        if isinstance(child, ast.comprehension):
            t = self.expr(child.iter)
            if t:
                self.bind(child.target, True)
            for cond in child.ifs:
                self.expr(cond)
            return t
        if isinstance(child, ast.arguments):
            return False
        return self.expr(child)

    def call(self, e: ast.Call) -> bool:
        fname = _dotted(e.func) or ""
        short = fname.rsplit(".", 1)[-1]

        # blessed: the counted sync returns host data and launders taint —
        # under any alias ("device_get" is unambiguous in this codebase)
        if short == "device_get":
            for a in list(e.args) + [k.value for k in e.keywords]:
                self.expr(a)
            return False

        # raw sync APIs: always a finding in scoped files
        if fname in _RAW_SYNC_FNS:
            self.flag(e, f"raw {fname}() — route device->host reads through "
                         "ops.device_get so the sync is counted")
        elif isinstance(e.func, ast.Attribute) \
                and e.func.attr == "synchronize":
            self.flag(e, "raw .synchronize() — use ops.device_get (or "
                         "obs.tracing spans) so the sync is counted")

        args_tainted = any(self.expr(a) for a in e.args) | \
            any(self.expr(k.value) for k in e.keywords)
        base_tainted = (isinstance(e.func, ast.Attribute)
                        and self.expr(e.func.value))

        # sinks: host coercions and copies of device values
        if fname in _CAST_SINKS and args_tainted:
            self.flag(e, f"uncounted host sync: {short}() coerces a device "
                         "value — use ops.device_get")
        if base_tainted and e.func.attr in _TENSOR_SINKS:
            self.flag(e, f"uncounted host sync: .{e.func.attr}() on a device "
                         "value — use ops.device_get")
        elif base_tainted and e.func.attr == "to" and _is_cpu_target(e):
            self.flag(e, "uncounted host sync: .to('cpu') of a device value "
                         "— use ops.device_get")

        # host metadata: len() of a tensor, .size(), .numel(), ...
        if fname == "len" or (isinstance(e.func, ast.Attribute)
                              and e.func.attr in _HOST_META_METHODS):
            return False

        # sources: counted kernel entry points and the split protocol
        source = False
        if fname.startswith("ops.") and short not in _OPS_HOST_FNS:
            source = True
        elif short in _DEVICE_SOURCES or fname in self.tainted_returning:
            source = True
        elif isinstance(e.func, ast.Attribute) \
                and e.func.attr in self.tainted_returning:
            source = True
        elif isinstance(e.func, ast.Call) and self.expr(e.func):
            source = True
        elif self.xmod is not None and self.xmod.is_source(fname):
            source = True
        return source or args_tainted or base_tainted


class _CrossModule:
    """Cross-module source oracle for ``_FnTaint`` (project runs only).

    Resolves a call's dotted name through the project call graph: counted-op
    registrations under any import alias, project functions in the tainted-
    returning fixpoint set, and ``self.<attr>.method(...)`` receivers via
    inferred attribute types.
    """

    def __init__(self, graph, module: str, cls: Optional[str],
                 tainted_quals: set[str]):
        self.graph = graph
        self.module = module
        self.cls = cls
        self.tainted_quals = tainted_quals

    def is_source(self, fname: str) -> bool:
        if not fname:
            return False
        if fname.startswith("self."):
            return self._self_call(fname[len("self."):])
        q = self.graph.resolve(self.module, fname)
        if q is None:
            return False
        return q in self.graph.counted_ops or q in self.tainted_quals

    def _self_call(self, rest: str) -> bool:
        if self.cls is None:
            return False
        cq = f"{self.module}.{self.cls}"
        head, _, meth = rest.partition(".")
        if not meth:   # self.method()
            hit = self.graph.lookup_method(cq, head)
            return hit is not None and hit.qual in self.tainted_quals
        if "." in meth:
            return False
        ci = self.graph.classes.get(cq)
        if ci is None or head not in ci.attr_types:
            return False
        hit = self.graph.lookup_method(ci.attr_types[head], meth)
        return hit is not None and hit.qual in self.tainted_quals


def project_tainted_quals(project: ProjectContext) -> set[str]:
    """Project-wide fixpoint: quals of functions returning device values.

    Cached on the ProjectContext — computed once per run, shared by every
    file's host-sync pass. Monotone (the set only grows), so the sweep
    converges; 6 rounds bound the deepest cross-module return chain in this
    tree with slack.
    """
    cached = project.cache.get("host_sync_tainted")
    if cached is not None:
        return cached
    graph = project.graph
    rule = HostSyncRule()
    mods = []
    for fctx in project.files:
        mod = graph.modules.get(fctx.module)
        if mod is None:
            continue
        mods.append((fctx, mod, _functions_with_class(fctx.tree)))
    tainted: set[str] = set()
    for _ in range(6):
        changed = False
        for fctx, mod, fns in mods:
            local = {q.rsplit(".", 1)[-1] for q in tainted
                     if q.startswith(mod.name + ".")}
            for fn, cls in fns:
                prefix = f"{mod.name}.{cls}." if cls else f"{mod.name}."
                qual = prefix + fn.name
                if qual in tainted:
                    continue
                xmod = _CrossModule(graph, mod.name, cls, tainted)
                t = _FnTaint(rule, fctx, local, collect_only=True, xmod=xmod)
                t.run(fn)
                if t.returns_tainted:
                    tainted.add(qual)
                    changed = True
        if not changed:
            break
    project.cache["host_sync_tainted"] = tainted
    return tainted


class HostSyncRule(Rule):
    rule_id = "host-sync"
    doc = ("Device->host transfers must route through ops.device_get so the "
           "launch/host-sync counters (and span attribution) stay exact: no "
           "float/int/bool/np.asarray of a device value, no .item/.tolist/"
           ".cpu/.numpy/.to('cpu') on one, no raw torch.cuda.synchronize. "
           "Whole-program: taint follows returns across module boundaries.")

    _ALLOWLIST = ("kernels/ops.py",   # the accounting home itself
                  "obs/tracing.py")   # span exit's sanctioned sync

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_sync_scope(ctx.posix) or "/analysis/" in ctx.posix:
            return []
        if any(ctx.posix.endswith(a) for a in self._ALLOWLIST):
            return []

        fns = _functions_with_class(ctx.tree)

        if ctx.project is not None:
            graph = ctx.project.graph
            modname = ctx.module
            quals = project_tainted_quals(ctx.project)
            tainted_returning = {q.rsplit(".", 1)[-1] for q in quals
                                 if q.startswith(modname + ".")}
            findings: list[Finding] = []
            for fn, cls in fns:
                xmod = _CrossModule(graph, modname, cls, quals)
                t = _FnTaint(self, ctx, tainted_returning,
                             collect_only=False, xmod=xmod)
                t.run(fn)
                findings.extend(t.findings)
            return findings

        # fallback: same-module-only analysis (no project attached)
        functions = [fn for fn, _ in fns]
        tainted_returning: set[str] = set()
        for _ in range(2):  # one refinement round catches chained returns
            for fn in functions:
                t = _FnTaint(self, ctx, tainted_returning, collect_only=True)
                t.run(fn)
                if t.returns_tainted:
                    tainted_returning.add(fn.name)
        findings = []
        for fn in functions:
            t = _FnTaint(self, ctx, tainted_returning, collect_only=False)
            t.run(fn)
            findings.extend(t.findings)
        return findings


# ---------------------------------------------------------------------------
# rule 2: uncounted-launch
# ---------------------------------------------------------------------------

_WRAPPER_MODULES = ("multi_scan", "range_scan", "reducers", "va_filter",
                    "kv_visit")
_EXTENSION_MODULE = "_build"
_EXTENSION_ENTRIES = ("launch", "library")   # the loaded libraries


def _kernels_module(name: str, leaves: tuple[str, ...]) -> bool:
    head, _, tail = name.rpartition(".")
    return head.endswith("kernels") and tail in leaves


def _in_launch_scope(module: str) -> bool:
    """kernels/ (bar the wrappers and the extension loader) and core/."""
    parts = module.split(".")
    if "core" in parts[:-1]:
        return True
    return "kernels" in parts[:-1] and not _kernels_module(
        module, (*_WRAPPER_MODULES, _EXTENSION_MODULE))


def _body_nodes(fn: ast.AST):
    """Every node of a function's body (nested defs included; the
    signature, its annotations and the decorators left out)."""
    for stmt in getattr(fn, "body", []):
        yield from ast.walk(stmt)


def _module_level_nodes(tree: ast.AST):
    """Nodes of a module that run at import, outside every def."""
    stack = [s for s in getattr(tree, "body", [])
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                stack.append(child)


class _LaunchGraph:
    """The project facts ``uncounted-launch`` needs, computed once per run:
    launch targets (the extension's entries and the wrapper modules'
    device functions) and counted bodies."""

    def __init__(self, graph):
        self.graph = graph
        self._roots = {m.split(".")[0] for m in graph.modules}
        self._methods_by_name: dict[str, list[str]] = {}
        for ci in graph.classes.values():
            for name, fi in ci.methods.items():
                self._methods_by_name.setdefault(name, []).append(fi.qual)
        self.targets = self._launch_targets()
        self.bodies = self._counted_bodies()

    # -- reference resolution ------------------------------------------------
    def resolve(self, fi, node: ast.AST, is_call: bool) -> list[str]:
        """Project function quals a Name/Attribute in ``fi`` may refer to.
        ``self.m`` / ``self.attr.m`` resolve through the class; an
        unresolved ``x.m(...)`` call refers to every project method ``m``."""
        d = _dotted(node)
        if not d:
            return []
        g = self.graph
        if fi is not None and fi.cls is not None and d.startswith("self."):
            cq = f"{fi.module}.{fi.cls}"
            head, _, meth = d[len("self."):].partition(".")
            hit = None
            if not meth:
                hit = g.lookup_method(cq, head)
            elif "." not in meth:
                ci = g.classes.get(cq)
                if ci is not None and head in ci.attr_types:
                    hit = g.lookup_method(ci.attr_types[head], meth)
            if hit is not None:
                return [hit.qual]
        else:
            module = fi.module if fi is not None else None
            q = g.resolve(module, d) if module else None
            if q in g.functions:
                return [q]
            if q in g.classes:
                return []
        mod = g.modules.get(fi.module) if fi is not None else None
        head = d.split(".", 1)[0]
        if mod is not None and head in mod.imports \
                and mod.imports[head].split(".")[0] not in self._roots:
            return []   # a third-party call (torch.*, np.*)
        if is_call and isinstance(node, ast.Attribute):
            return list(self._methods_by_name.get(node.attr, ()))
        return []

    def _refs(self, fi, nodes) -> list[tuple[ast.AST, list[str]]]:
        """(node, quals) for every call and function reference in
        ``nodes``; the arguments of ``counted(...)(impl)`` registrations are
        the registration itself, not a reference."""
        out = []
        registered: set[int] = set()
        called: set[int] = set()
        nodes = list(nodes)
        for n in nodes:
            if isinstance(n, ast.Call):
                called.add(id(n.func))
                if isinstance(n.func, ast.Call) and (_dotted(
                        n.func.func) or "").rsplit(".", 1)[-1].strip(
                        "_") == "counted":
                    registered.update(id(a) for a in n.args)
        for n in nodes:
            if isinstance(n, (ast.Name, ast.Attribute)) \
                    and isinstance(n.ctx, ast.Load) \
                    and id(n) not in registered:
                quals = self.resolve(fi, n, id(n) in called)
                if quals:
                    out.append((n, quals))
        return out

    # -- launch targets -----------------------------------------------------
    def _launch_targets(self) -> dict[str, str]:
        """qual -> kernels module of every launch target: the extension's
        entries and every function of a wrapper module."""
        g = self.graph
        targets: dict[str, str] = {}
        for name, mod in g.modules.items():
            if _kernels_module(name, (_EXTENSION_MODULE,)):
                for entry in _EXTENSION_ENTRIES:
                    if entry in mod.functions:
                        targets[f"{name}.{entry}"] = _EXTENSION_MODULE
        for fi in g.functions.values():
            if _kernels_module(fi.module, _WRAPPER_MODULES):
                targets[fi.qual] = fi.module.rsplit(".", 1)[-1]
        return targets

    # -- counted bodies -----------------------------------------------------
    def _counted_bodies(self) -> set[str]:
        g = self.graph
        bodies = {q for q in g.counted_ops if q in g.functions}
        # referrers[q]: the functions (None = module level) referring to q
        referrers: dict[str, set] = {}
        for fi in g.functions.values():
            for _, quals in self._refs(fi, _body_nodes(fi.node)):
                for q in quals:
                    referrers.setdefault(q, set()).add(fi.qual)
        for name, mod in g.modules.items():
            pseudo = _ModuleLevel(name)
            for _, quals in self._refs(pseudo,
                                       _module_level_nodes(mod.tree)):
                for q in quals:
                    referrers.setdefault(q, set()).add(None)
        changed = True
        while changed:
            changed = False
            for q, refs in referrers.items():
                if q not in bodies and None not in refs \
                        and refs <= bodies:
                    bodies.add(q)
                    changed = True
        return bodies


class _ModuleLevel:
    """Stands in for a function when resolving module-level references."""

    cls = None

    def __init__(self, module: str):
        self.module = module


def _launch_graph(project: ProjectContext) -> _LaunchGraph:
    lg = project.cache.get("launch_graph")
    if lg is None:
        lg = project.cache["launch_graph"] = _LaunchGraph(project.graph)
    return lg


class UncountedLaunchRule(Rule):
    rule_id = "uncounted-launch"
    doc = ("In kernels/ and core/, a call into the compiled extension "
           "(_build.launch/library) or into a wrapper module (multi_scan, "
           "range_scan, reducers, va_filter, kv_visit) "
           "must sit in a function registered through ops.counted, or "
           "reached only from one, so launch budgets stay assertable.")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or ctx.project is None:
            return []
        module = ctx.module
        if not _in_launch_scope(module):
            return []
        lg = _launch_graph(ctx.project)
        g = ctx.project.graph
        findings: list[Finding] = []
        scopes = [(fi, _body_nodes(fi.node)) for fi in g.functions.values()
                  if fi.module == module and fi.qual not in lg.bodies]
        scopes.append((_ModuleLevel(module),
                       _module_level_nodes(g.modules[module].tree)
                       if module in g.modules else ()))
        for fi, nodes in scopes:
            where = getattr(fi, "qual", f"module {module}")
            for node, quals in lg._refs(fi, nodes):
                hit = next((q for q in quals if q in lg.targets), None)
                if hit is None:
                    continue
                findings.append(self.finding(
                    ctx, node, f"'{hit.rsplit('.', 1)[-1]}' of "
                    f"kernels/{lg.targets[hit]} reached from {where}, which "
                    "is not a counted body — register it through "
                    "ops.counted (or call it only from one) so its launches "
                    "count toward the budget"))
        return findings


# ---------------------------------------------------------------------------
# rule 3: raw-shard-map
# ---------------------------------------------------------------------------

# ``.to(x)`` casts when ``x`` names a dtype: ``torch.<dtype>``, a name or
# attribute ending in "dtype", or an upper-case dtype constant (``F32``).
_TORCH_DTYPES = {
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "int16", "int32", "int64", "uint8", "bool", "long", "int",
    "short", "complex64", "complex128"}
# A receiver built from host data in the same expression makes ``.to`` an
# upload, not a copy between the devices of a mesh.
_HOST_TENSOR_FNS = {"torch.from_numpy", "from_numpy", "pin_memory"}


def _is_dtype_expr(e: ast.AST) -> bool:
    d = _dotted(e) or ""
    head, _, last = d.rpartition(".")
    if head == "torch" and last in _TORCH_DTYPES:
        return True
    return bool(last) and (last.endswith("dtype") or last.isupper())


def _host_receiver(e: ast.AST) -> bool:
    return any(isinstance(n, ast.Call)
               and ((_dotted(n.func) or "") in _HOST_TENSOR_FNS
                    or (isinstance(n.func, ast.Attribute)
                        and n.func.attr in _HOST_TENSOR_FNS))
               for n in ast.walk(e))


class RawShardMapRule(Rule):
    rule_id = "raw-shard-map"
    doc = ("Copies between devices (.to(<device>), .cuda(), copy_) only in "
           "core/distributed.py (DataMesh.replicate/gather): one place owns "
           "how a mesh moves data, so a sharded path's copies stay where "
           "the collectives are counted.")

    _MSG = ("device copy outside core/distributed.py — move data between the "
            "devices of a mesh through DataMesh.replicate/gather")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or "/analysis/" in ctx.posix \
                or ctx.posix.endswith("core/distributed.py"):
            return []
        findings = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr, recv = node.func.attr, node.func.value
            if attr in ("copy_", "cuda"):
                findings.append(self.finding(ctx, node, self._MSG))
            elif attr == "to" and not _host_receiver(recv):
                device_kw = any(k.arg == "device" for k in node.keywords)
                device_arg = bool(node.args) and not _is_dtype_expr(
                    node.args[0])
                if device_kw or device_arg:
                    findings.append(self.finding(ctx, node, self._MSG))
        return findings


# ---------------------------------------------------------------------------
# rule 4: sentinel
# ---------------------------------------------------------------------------

_CAST_FNS = {"torch.tensor", "torch.as_tensor", "torch.full",
             "torch.full_like", "np.full", "np.full_like"}
_WIDE_DTYPES = {"np.float32", "np.float64", "torch.float32", "torch.float64",
                "torch.float", "torch.double", "float", "F32", "F64",
                "FLOAT32", "FLOAT64"}
_INF_NAMES = {"np.inf", "torch.inf", "math.inf", "inf"}


def _is_inf_expr(e: ast.AST) -> bool:
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.USub, ast.UAdd)):
        return _is_inf_expr(e.operand)
    if _dotted(e) in _INF_NAMES:
        return True
    if isinstance(e, ast.Call) and _dotted(e.func) == "float" and e.args:
        a = e.args[0]
        return isinstance(a, ast.Constant) and isinstance(a.value, str) \
            and "inf" in a.value
    return False


class SentinelRule(Rule):
    rule_id = "sentinel"
    doc = ("No hardcoded 3e38-family extrema and no inf into unknown-dtype "
           "casts: f32 extrema round to +-inf under bf16 casts. Use "
           "repro_torch.numerics / core.types.finite_query_bounds.")

    _LIMIT = 1e30

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or "/analysis/" in ctx.posix \
                or ctx.posix.endswith("repro_torch/numerics.py"):
            return []
        findings = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, float) \
                    and abs(node.value) >= self._LIMIT \
                    and node.value == node.value:  # not NaN
                findings.append(self.finding(
                    ctx, node, f"hardcoded extreme literal {node.value!r} — "
                    "derive it from the target dtype via repro_torch."
                    "numerics (finite_min/finite_max/mask_fill); f32-scale "
                    "extrema round to inf under bf16 casts"))
            elif isinstance(node, ast.Call) \
                    and _dotted(node.func) in _CAST_FNS:
                vals = list(node.args) + [k.value for k in node.keywords]
                if not any(_is_inf_expr(v) for v in vals):
                    continue
                dtypes = [_dotted(v) for v in vals]
                if not any(d in _WIDE_DTYPES for d in dtypes if d):
                    findings.append(self.finding(
                        ctx, node, "inf cast into a non-explicit dtype — "
                        "under bf16 this may stay inf where a finite "
                        "sentinel was intended; use repro_torch.numerics or "
                        "core.types.finite_query_bounds"))
        return findings


# ---------------------------------------------------------------------------
# rule 5: lock-discipline
# ---------------------------------------------------------------------------

def _lockish(ctx: FileContext, w: ast.With, needle: str = "_lock") -> bool:
    return any(needle in (ctx.segment(item.context_expr) or "")
               for item in w.items)


class LockDisciplineRule(Rule):
    rule_id = "lock-discipline"
    doc = ("Attributes ever written under self._lock/_ingest_lock are "
           "lock-guarded: off-lock writes (outside __init__) race the "
           "mutable plane. _state swaps must be one assignment under the "
           "ingest lock; _state is never mutated in place.")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or "/analysis/" in ctx.posix:
            return []
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node))
        findings.extend(self._check_state_swaps(ctx))
        return findings

    # -- guarded attribute writes ------------------------------------------
    def _attr_writes(self, fn: ast.AST, ctx: FileContext
                     ) -> list[tuple[str, ast.AST, bool]]:
        """(attr, node, under_lock) for every ``self.X = ...`` write."""
        out: list[tuple[str, ast.AST, bool]] = []

        def walk(stmts, under):
            for s in stmts:
                if isinstance(s, ast.With):
                    walk(s.body, under or _lockish(ctx, s))
                    continue
                if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (s.targets if isinstance(s, ast.Assign)
                               else [s.target])
                    for tgt in targets:
                        parts = (tgt.elts
                                 if isinstance(tgt, (ast.Tuple, ast.List))
                                 else [tgt])
                        for t in parts:
                            base = t
                            if isinstance(base, ast.Subscript):
                                base = base.value
                            if isinstance(base, ast.Attribute) \
                                    and isinstance(base.value, ast.Name) \
                                    and base.value.id == "self":
                                out.append((base.attr, s, under))
                for name in ("body", "orelse", "finalbody"):
                    walk(getattr(s, name, []) or [], under)
                for h in getattr(s, "handlers", []) or []:
                    walk(h.body, under)
        walk(getattr(fn, "body", []), False)
        return out

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef
                     ) -> list[Finding]:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        writes = {m.name: self._attr_writes(m, ctx) for m in methods}
        guarded = {attr for ws in writes.values()
                   for attr, _, under in ws if under}
        findings = []
        for name, ws in writes.items():
            if name == "__init__":
                continue
            for attr, node, under in ws:
                if attr in guarded and not under:
                    findings.append(self.finding(
                        ctx, node, f"'{cls.name}.{attr}' is written under a "
                        "lock elsewhere but mutated here off-lock — this "
                        "races the guarded mutable plane"))
        return findings

    # -- _state swap discipline --------------------------------------------
    def _check_state_swaps(self, ctx: FileContext) -> list[Finding]:
        findings = []

        def walk(stmts, under_ingest, in_init):
            for s in stmts:
                if isinstance(s, ast.With):
                    walk(s.body,
                         under_ingest or _lockish(ctx, s, "_ingest_lock"),
                         in_init)
                    continue
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(s.body, False, s.name == "__init__")
                    continue
                if isinstance(s, ast.ClassDef):
                    walk(s.body, False, False)
                    continue
                if isinstance(s, ast.Assign):
                    for tgt in s.targets:
                        # X._state.attr = v  /  X._state.d[k] = v: in-place
                        base = tgt
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        inner = base.value if isinstance(base, ast.Attribute) \
                            else None
                        if isinstance(inner, ast.Attribute) \
                                and inner.attr == "_state":
                            findings.append(self.finding(
                                ctx, s, "in-place mutation of _state — "
                                "engine state is immutable; build a new "
                                "state and swap it in one assignment"))
                        # X._state = v: must be a lone swap under the lock
                        elif isinstance(base, ast.Attribute) \
                                and base.attr == "_state":
                            if len(s.targets) != 1 \
                                    or isinstance(tgt, (ast.Tuple, ast.List)):
                                findings.append(self.finding(
                                    ctx, s, "_state swap must be a single "
                                    "plain assignment (readers snapshot it "
                                    "lock-free)"))
                            elif not (under_ingest or in_init):
                                findings.append(self.finding(
                                    ctx, s, "_state swap outside the ingest "
                                    "lock — concurrent writers can "
                                    "interleave stale states"))
                for name in ("body", "orelse", "finalbody"):
                    walk(getattr(s, name, []) or [], under_ingest, in_init)
                for h in getattr(s, "handlers", []) or []:
                    walk(h.body, under_ingest, in_init)
        walk(ctx.tree.body, False, False)
        return findings


# ---------------------------------------------------------------------------
# rule 6: registry-hygiene
# ---------------------------------------------------------------------------

_REGISTER_DECOS = {"register_result_spec", "register_path"}


class RegistryHygieneRule(Rule):
    rule_id = "registry-hygiene"
    doc = ("Registered ResultSpec classes must be frozen dataclasses (specs "
           "are part of the ops' warm keys: hashable and immutable) and "
           "registry classes must not carry mutable class-level defaults.")

    _REGISTRY_MODULES = ("core/types.py", "core/paths.py")

    def _register_deco(self, cls: ast.ClassDef) -> Optional[str]:
        for d in cls.decorator_list:
            name = _dotted(d.func if isinstance(d, ast.Call) else d) or ""
            short = name.rsplit(".", 1)[-1]
            if short in _REGISTER_DECOS:
                return short
        return None

    def _frozen_dataclass(self, cls: ast.ClassDef) -> bool:
        for d in cls.decorator_list:
            if isinstance(d, ast.Call):
                name = _dotted(d.func) or ""
                if name.rsplit(".", 1)[-1] == "dataclass":
                    for k in d.keywords:
                        if k.arg == "frozen" \
                                and isinstance(k.value, ast.Constant) \
                                and k.value.value is True:
                            return True
        return False

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix):
            return []
        findings = []
        in_registry_module = any(ctx.posix.endswith(m)
                                 for m in self._REGISTRY_MODULES)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            deco = self._register_deco(node)
            if deco == "register_result_spec" \
                    and not self._frozen_dataclass(node):
                findings.append(self.finding(
                    ctx, node, f"'{node.name}' is registered via "
                    "register_result_spec but is not a frozen dataclass — "
                    "specs are part of the ops' warm keys and must be "
                    "hashable and immutable"))
            if deco or in_registry_module:
                for stmt in node.body:
                    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        val = stmt.value
                        if isinstance(val, (ast.List, ast.Dict, ast.Set)):
                            findings.append(self.finding(
                                ctx, stmt, f"mutable class-level default on "
                                f"'{node.name}' — shared across every "
                                "instance (and unhashable in a warm key); "
                                "use dataclasses.field or a tuple"))
        return findings


# ---------------------------------------------------------------------------
# rule 7: thread-boundary
# ---------------------------------------------------------------------------

class ThreadBoundaryRule(Rule):
    rule_id = "thread-boundary"
    doc = ("Pipelined-serving stage discipline (serve/pipeline.py): a "
           "@device_stage function never calls ops.device_get (the counted "
           "sync belongs to the finalizer thread) and never parks a device "
           "value on self — in-flight payloads cross threads only inside a "
           "PendingBatch riding the bounded backlog queue.")

    @staticmethod
    def _stage(fn: ast.AST) -> Optional[str]:
        for d in getattr(fn, "decorator_list", []):
            name = _dotted(d) or ""
            short = name.rsplit(".", 1)[-1]
            if short == "device_stage":
                return "device"
            if short == "finalizer_stage":
                return "finalize"
        return None

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or "/analysis/" in ctx.posix:
            return []
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and self._stage(node) == "device":
                findings.extend(self._check_device(ctx, node))
        return findings

    def _check_device(self, ctx: FileContext, fn: ast.AST) -> list[Finding]:
        findings: list[Finding] = []
        tainted: set[str] = set()

        def is_tainted(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in tainted
            if isinstance(e, ast.Call):
                fname = _dotted(e.func) or ""
                short = fname.rsplit(".", 1)[-1]
                if fname.startswith("ops.") and short not in _OPS_HOST_FNS:
                    return True
                if short in _DEVICE_SOURCES:
                    return True
                return (any(is_tainted(a) for a in e.args)
                        or any(is_tainted(k.value) for k in e.keywords))
            if isinstance(e, (ast.Tuple, ast.List)):
                return any(is_tainted(x) for x in e.elts)
            if isinstance(e, (ast.Attribute, ast.Subscript, ast.Starred)):
                return is_tainted(e.value)
            return False

        # two monotone passes converge name taint (use-before-def in loops)
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and is_tainted(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
                        elif isinstance(tgt, (ast.Tuple, ast.List)):
                            for e in tgt.elts:
                                if isinstance(e, ast.Name):
                                    tainted.add(e.id)

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                fname = _dotted(node.func) or ""
                if fname.rsplit(".", 1)[-1] == "device_get":
                    findings.append(self.finding(
                        ctx, node, "ops.device_get in a @device_stage "
                        "function — the counted host sync belongs to the "
                        "finalizer thread; hand the in-flight payload across "
                        "the backlog queue instead"))
            elif isinstance(node, ast.Assign):
                if not is_tainted(node.value):
                    continue
                for tgt in node.targets:
                    base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                    if isinstance(base, ast.Attribute) \
                            and isinstance(base.value, ast.Name) \
                            and base.value.id == "self":
                        findings.append(self.finding(
                            ctx, node, f"device value parked on "
                            f"'self.{base.attr}' in a @device_stage function "
                            "— device values cross threads only through the "
                            "bounded backlog queue (put a PendingBatch, not "
                            "an attribute)"))
        return findings


# imported at the bottom: contracts.py needs the helpers defined above
from repro_torch.analysis.contracts import CONTRACT_RULES  # noqa: E402

ALL_RULES: tuple[Rule, ...] = (
    HostSyncRule(), UncountedLaunchRule(), RawShardMapRule(), SentinelRule(),
    LockDisciplineRule(), RegistryHygieneRule(), ThreadBoundaryRule(),
) + CONTRACT_RULES
