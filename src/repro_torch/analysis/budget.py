"""Static launch/host-sync budget certifier for the port.

Ports ``repro/analysis/budget.py``. The engine's performance claim is a
*budget*: every warm serving path costs a fixed number of counted kernel
launches and host syncs per batch window (e.g. scan = one fused
``multi_scan_reduce`` + one ``device_get``; the two-phase tree paths = prune
+ visit launches with the mid-stage survivor sync + the payload sync). The
port's runtime tests assert these numbers against the
``mdrq_launches_total`` counters — *after* the code runs. This module
derives the same numbers **statically**, by abstract interpretation over the
project call graph, and writes them to the checked-in ``BUDGET_torch.json``:
a source edit that adds a launch or sync to a serving path changes the
certificate and fails ``--budget-check`` before any test executes. Its
leaves equal the reference's ``BUDGET.json`` — the port keeps the
reference's budget — and a deliberate budget change ships with its
regenerated certificate in the same diff.

How the interpreter works (stdlib ``ast`` only):

  * Abstract values: ``None``/``True``/``False`` literals, tuples, known
    class instances (``VInstance``), closures (``VFunc``), factories, module
    refs, and two unknowns — ``OPAQUE`` (unknown but non-None: the result of
    a counted launch, a delta view's device tensors) and ``UNKNOWN``.
  * Every call is resolved through the ``CallGraph``: counted ops bump the
    launch tally, ``ops.device_get`` bumps the sync tally, project functions
    and methods are interpreted recursively (cycle/depth guarded),
    ``repro_torch.obs`` is opaque by contract (tracing/metrics must never
    launch).
  * Branches on *known* conditions (``if partial:``, ``if delta is not None
    and not delta.is_empty:``, ``if dcm is None:``) follow that branch;
    branches on unknown conditions interpret both futures and keep the
    **max-cost** one (ties prefer the guard-skipping continuation) — the
    certificate is the warm-path worst case, which for these kernels is also
    the common case (the cheap arms are empty-input corners).
  * Loops and comprehensions run once: the certificate's unit is *per
    bucket* — per fused launch group — matching how the runtime counters are
    asserted.

Entry points are configured, not discovered: each registered access path
adapter x {frozen, live-delta} context, plus the engine split protocol
(``MDRQEngine.launch_batch`` / ``query_batch`` own-cost, ``PendingBatch.
finalize`` per bucket) and the pipelined server's stage functions. Adapter
receiver types (``ColumnarScanPath._scan`` is a ``ColumnarScan``) are
explicit config here — ``self._scan = scan`` with an unannotated parameter
is not inferable, and config that certifies wrong numbers fails the runtime
cross-validation test (``tests/test_torch_budget.py``) immediately.
``DistributedScanPath`` is not certified, as in the reference.
"""
from __future__ import annotations

import ast
import collections
import dataclasses
import json
from pathlib import Path
from typing import Optional

from repro_torch.analysis.callgraph import CallGraph, FunctionInfo


# -- abstract values ----------------------------------------------------------

class _V:
    """Base abstract value."""


@dataclasses.dataclass(frozen=True)
class VConst(_V):
    value: object


@dataclasses.dataclass(frozen=True)
class VUnknown(_V):
    pass


@dataclasses.dataclass(frozen=True)
class VOpaque(_V):
    """Unknown value statically known to be non-None (a counted launch's
    payload, a delta view's device arrays, an obs span)."""


NONE = VConst(None)
TRUE = VConst(True)
FALSE = VConst(False)
UNKNOWN = VUnknown()
OPAQUE = VOpaque()


@dataclasses.dataclass
class VTuple(_V):
    items: tuple


@dataclasses.dataclass
class VInstance(_V):
    cls: str                    # class qual ("__delta__" for the pseudo-view)
    attrs: dict


@dataclasses.dataclass
class VFactory(_V):
    """A zero-arg callable returning an instance of ``cls`` (the vertical
    scan path's lazy ``scan_ref``)."""
    cls: str


@dataclasses.dataclass
class VRef(_V):
    """An unresolved dotted name (module alias, global) — resolved against
    the call graph at call time."""
    dotted: str


@dataclasses.dataclass
class VFunc(_V):
    """A local ``def``/``lambda`` closure: body + defining scope."""
    node: ast.AST
    module: str
    cls: Optional[str]
    env: dict


def _is_none(v: _V) -> Optional[bool]:
    """None-ness: True / False / None (unknown)."""
    if isinstance(v, VConst):
        return v.value is None
    if isinstance(v, VUnknown):
        return None
    return False  # tuples, instances, closures, refs, OPAQUE


def _truth(v: _V) -> Optional[bool]:
    """Truthiness: True / False / None (unknown)."""
    if isinstance(v, VConst):
        return bool(v.value)
    if isinstance(v, VTuple):
        return len(v.items) > 0
    if isinstance(v, (VInstance, VFactory, VFunc, VRef)):
        return True
    return None  # OPAQUE, UNKNOWN


_RET = "ret"          # exec_block signal tag
_MAX_DEPTH = 24

# Host-side shape plumbing interpreted by contract instead of recursion:
# ``validate_mode``/``resolve_spec`` return their spec argument, ``.validate``
# returns its receiver. (All are pure host-side checks.)
_RETURNS_ARG0 = {"validate_mode", "resolve_spec"}
_RETURNS_RECEIVER = {"validate"}


class BudgetError(Exception):
    """An entry point could not be certified (config/source drift)."""


class _Interp:
    """One abstract execution: accumulates launch/sync tallies."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.launches: collections.Counter = collections.Counter()
        self.host_syncs = 0
        self._stack: list[str] = []

    # -- cost bookkeeping ---------------------------------------------------
    def _snap(self):
        return self.launches.copy(), self.host_syncs

    def _restore(self, snap):
        self.launches, self.host_syncs = snap[0].copy(), snap[1]

    def _score(self, snap) -> int:
        return (sum(self.launches.values()) - sum(snap[0].values())) \
            + (self.host_syncs - snap[1])

    # -- function interpretation --------------------------------------------
    def call_function(self, fi: FunctionInfo, self_val: Optional[_V],
                      args: list, kwargs: dict) -> _V:
        if fi.module.startswith("repro_torch.obs"):
            return OPAQUE  # tracing/metrics are cost-free by contract
        if fi.qual in self._stack or len(self._stack) >= _MAX_DEPTH:
            return UNKNOWN
        env = self._bind(fi.node.args, fi,
                         ([self_val] if fi.cls is not None
                          and self_val is not None else []) + list(args),
                         dict(kwargs))
        self._stack.append(fi.qual)
        try:
            r = self.exec_block(list(fi.node.body), env, fi)
        finally:
            self._stack.pop()
        return r[1] if r is not None else NONE

    def call_closure(self, f: VFunc, args: list, kwargs: dict) -> _V:
        key = f"<closure@{f.module}:{getattr(f.node, 'lineno', 0)}>"
        if key in self._stack or len(self._stack) >= _MAX_DEPTH:
            return UNKNOWN
        fi = FunctionInfo(qual=key, name=getattr(f.node, "name", "<lambda>"),
                          module=f.module, cls=f.cls, node=f.node,
                          decorators=())
        env = dict(f.env)
        env.update(self._bind(f.node.args, fi, list(args), dict(kwargs)))
        self._stack.append(key)
        try:
            if isinstance(f.node, ast.Lambda):
                return self.eval(f.node.body, env, fi)
            r = self.exec_block(list(f.node.body), env, fi)
        finally:
            self._stack.pop()
        return r[1] if r is not None else NONE

    def _bind(self, a: ast.arguments, fi: FunctionInfo, vals: list,
              kwargs: dict) -> dict:
        env: dict = {}
        names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
        n_required = len(names) - len(a.defaults)
        for i, nm in enumerate(names):
            if i < len(vals):
                env[nm] = vals[i]
            elif nm in kwargs:
                env[nm] = kwargs.pop(nm)
            elif i >= n_required:
                env[nm] = self._default(a.defaults[i - n_required])
            else:
                env[nm] = UNKNOWN
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if p.arg in kwargs:
                env[p.arg] = kwargs.pop(p.arg)
            else:
                env[p.arg] = self._default(d) if d is not None else UNKNOWN
        if a.vararg:
            env[a.vararg.arg] = UNKNOWN
        if a.kwarg:
            env[a.kwarg.arg] = UNKNOWN
        return env

    @staticmethod
    def _default(d: Optional[ast.AST]) -> _V:
        if isinstance(d, ast.Constant):
            return VConst(d.value)
        # non-literal defaults (T.IDS, module constants): defined objects
        return OPAQUE

    # -- statements ---------------------------------------------------------
    def exec_block(self, stmts: list, env: dict, fi: FunctionInfo):
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Return):
                return (_RET, self.eval(s.value, env, fi)
                        if s.value is not None else NONE)
            if isinstance(s, ast.Raise):
                return (_RET, NONE)
            if isinstance(s, ast.If):
                t = _truth(self.eval(s.test, env, fi))
                if t is True:
                    r = self.exec_block(list(s.body), env, fi)
                elif t is False:
                    r = self.exec_block(list(s.orelse), env, fi)
                else:
                    rest = stmts[i + 1:]
                    return self._fork([list(s.body) + rest,
                                       list(s.orelse) + rest], env, fi)
                if r is not None:
                    return r
            elif isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                v = (self.eval(s.value, env, fi)
                     if getattr(s, "value", None) is not None else UNKNOWN)
                if isinstance(s, ast.AugAssign):
                    v = UNKNOWN  # x += y: the combined value is opaque
                for t in (s.targets if isinstance(s, ast.Assign)
                          else [s.target]):
                    self._bind_target(t, v, env, fi)
            elif isinstance(s, ast.Expr):
                self.eval(s.value, env, fi)
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                env[s.name] = VFunc(node=s, module=fi.module, cls=fi.cls,
                                    env=dict(env))
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                self.eval(s.iter, env, fi)
                self._bind_target(s.target, UNKNOWN, env, fi)
                r = self.exec_block(list(s.body), env, fi)  # body once
                if r is not None:
                    return r
                r = self.exec_block(list(s.orelse), env, fi)
                if r is not None:
                    return r
            elif isinstance(s, ast.While):
                self.eval(s.test, env, fi)
                r = self.exec_block(list(s.body), env, fi)  # body once
                if r is not None:
                    return r
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    v = self.eval(item.context_expr, env, fi)
                    if item.optional_vars is not None:
                        self._bind_target(
                            item.optional_vars,
                            v if not isinstance(v, VUnknown) else OPAQUE,
                            env, fi)
                r = self.exec_block(list(s.body), env, fi)
                if r is not None:
                    return r
            elif isinstance(s, ast.Try):
                r = self.exec_block(list(s.body), env, fi)
                if r is None:
                    r = self.exec_block(list(s.orelse), env, fi)
                rf = self.exec_block(list(s.finalbody), env, fi)
                if r is not None or rf is not None:
                    return rf if rf is not None else r
            # Import/Assert/Pass/Break/Continue/Global/Nonlocal/Delete:
            # no cost, no bindings the analysis needs (function-level imports
            # are already in the module symbol table via ast.walk)
        return None

    def _fork(self, options: list, env: dict, fi: FunctionInfo):
        """Interpret alternative futures; commit the max-cost one.

        Ties prefer the *last* option — for a two-armed ``if`` that is the
        guard-skipping continuation, so equal-cost early-return corners
        (empty visit lists, empty batches) never displace the main path's
        op names in the certificate.
        """
        base = self._snap()
        best = None
        for stmts in options:
            self._restore(base)
            e = dict(env)
            r = self.exec_block(stmts, e, fi)
            cand = (self._score(base), self._snap(), e, r)
            if best is None or cand[0] >= best[0]:
                best = cand
        _, snap, e, r = best
        self._restore(snap)
        env.clear()
        env.update(e)
        return r

    def _bind_target(self, t: ast.AST, v: _V, env: dict,
                     fi: FunctionInfo) -> None:
        if isinstance(t, ast.Name):
            env[t.id] = v
        elif isinstance(t, (ast.Tuple, ast.List)):
            if isinstance(v, VTuple) and len(v.items) == len(t.elts):
                for sub, sv in zip(t.elts, v.items):
                    self._bind_target(sub, sv, env, fi)
            else:
                for sub in t.elts:
                    self._bind_target(sub, UNKNOWN, env, fi)
        elif isinstance(t, ast.Attribute):
            base = self.eval(t.value, env, fi)
            if isinstance(base, VInstance):
                base.attrs[t.attr] = v
        elif isinstance(t, ast.Starred):
            self._bind_target(t.value, UNKNOWN, env, fi)
        # Subscript targets: no binding tracked

    # -- expressions --------------------------------------------------------
    def eval(self, node: ast.AST, env: dict, fi: FunctionInfo) -> _V:
        if isinstance(node, ast.Constant):
            return VConst(node.value)
        if isinstance(node, ast.Name):
            return env.get(node.id, VRef(node.id))
        if isinstance(node, ast.Attribute):
            base = self.eval(node.value, env, fi)
            if isinstance(base, VRef):
                return VRef(f"{base.dotted}.{node.attr}")
            if isinstance(base, VInstance):
                if node.attr in base.attrs:
                    return base.attrs[node.attr]
                ci = self.graph.classes.get(base.cls)
                if ci is not None and node.attr in ci.attr_types:
                    return VInstance(ci.attr_types[node.attr], {})
            return UNKNOWN
        if isinstance(node, ast.Call):
            return self._eval_call(node, env, fi)
        if isinstance(node, (ast.Tuple, ast.List)):
            return VTuple(tuple(self.eval(e, env, fi) for e in node.elts))
        if isinstance(node, ast.IfExp):
            return self._eval_ifexp(node, env, fi)
        if isinstance(node, ast.BoolOp):
            return self._eval_boolop(node, env, fi)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, env, fi)
            if isinstance(node.op, ast.Not):
                t = _truth(v)
                return UNKNOWN if t is None else (FALSE if t else TRUE)
            return UNKNOWN
        if isinstance(node, ast.Compare):
            return self._eval_compare(node, env, fi)
        if isinstance(node, ast.BinOp):
            self.eval(node.left, env, fi)
            self.eval(node.right, env, fi)
            return UNKNOWN
        if isinstance(node, ast.Subscript):
            self.eval(node.value, env, fi)
            if isinstance(node.slice, ast.Slice):
                for part in (node.slice.lower, node.slice.upper,
                             node.slice.step):
                    if part is not None:
                        self.eval(part, env, fi)
            else:
                self.eval(node.slice, env, fi)
            return UNKNOWN
        if isinstance(node, ast.Lambda):
            return VFunc(node=node, module=fi.module, cls=fi.cls,
                         env=dict(env))
        if isinstance(node, ast.Starred):
            return self.eval(node.value, env, fi)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            sub = dict(env)
            for gen in node.generators:
                self.eval(gen.iter, sub, fi)
                self._bind_target(gen.target, UNKNOWN, sub, fi)
                for cond in gen.ifs:
                    self.eval(cond, sub, fi)
            if isinstance(node, ast.DictComp):
                self.eval(node.key, sub, fi)
                self.eval(node.value, sub, fi)
            else:
                self.eval(node.elt, sub, fi)  # body once (per-bucket unit)
            return UNKNOWN
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self.eval(k, env, fi)
            for v in node.values:
                self.eval(v, env, fi)
            return UNKNOWN
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.eval(v.value, env, fi)
            return UNKNOWN
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value, env, fi)
        return UNKNOWN

    def _eval_ifexp(self, node: ast.IfExp, env: dict, fi: FunctionInfo) -> _V:
        t = _truth(self.eval(node.test, env, fi))
        if t is True:
            return self.eval(node.body, env, fi)
        if t is False:
            return self.eval(node.orelse, env, fi)
        base = self._snap()
        v1 = self.eval(node.body, env, fi)
        s1, c1 = self._score(base), self._snap()
        self._restore(base)
        v2 = self.eval(node.orelse, env, fi)
        s2 = self._score(base)
        if s1 > s2:
            self._restore(c1)
            return v1 if v1 == v2 else UNKNOWN
        return v2 if v1 == v2 else UNKNOWN

    def _eval_boolop(self, node: ast.BoolOp, env: dict,
                     fi: FunctionInfo) -> _V:
        is_and = isinstance(node.op, ast.And)
        last: _V = UNKNOWN
        unknown = False
        for v_expr in node.values:
            v = self.eval(v_expr, env, fi)
            t = _truth(v)
            if t is None:
                unknown = True
            elif is_and and not t:
                return FALSE  # short-circuit (matches runtime evaluation)
            elif not is_and and t:
                return v
            last = v
        return UNKNOWN if unknown else last

    def _eval_compare(self, node: ast.Compare, env: dict,
                      fi: FunctionInfo) -> _V:
        left = self.eval(node.left, env, fi)
        rights = [self.eval(c, env, fi) for c in node.comparators]
        if len(node.ops) == 1 and isinstance(node.ops[0], (ast.Is, ast.IsNot)):
            ln, rn = _is_none(left), _is_none(rights[0])
            # the `x is [not] None` idiom: one side is a known None
            hit = ln if rn is True else (rn if ln is True else None)
            if hit is not None:
                if isinstance(node.ops[0], ast.IsNot):
                    hit = not hit
                return TRUE if hit else FALSE
        return UNKNOWN

    # -- calls --------------------------------------------------------------
    def _eval_call(self, node: ast.Call, env: dict, fi: FunctionInfo) -> _V:
        args = [self.eval(a, env, fi) for a in node.args]
        kwargs = {}
        for kw in node.keywords:
            v = self.eval(kw.value, env, fi)
            if kw.arg is not None:
                kwargs[kw.arg] = v
        func = node.func
        if isinstance(func, ast.Attribute):
            base = self.eval(func.value, env, fi)
            if isinstance(base, VRef):
                return self._resolve_call(f"{base.dotted}.{func.attr}",
                                          args, kwargs, fi)
            if func.attr in _RETURNS_RECEIVER:
                return base
            if isinstance(base, VInstance):
                bound = base.attrs.get(func.attr)
                if bound is not None:
                    return self._call_value(bound, args, kwargs, fi)
                meth = self.graph.lookup_method(base.cls, func.attr)
                if meth is not None:
                    return self.call_function(meth, base, args, kwargs)
                # method on a known instance the graph can't see (the
                # pseudo delta view's device_cm/base_tomb_dev/host_ctx):
                # cost-free, but definitely not None
                return OPAQUE
            return UNKNOWN
        if isinstance(func, ast.Name):
            if func.id in env:
                return self._call_value(env[func.id], args, kwargs, fi)
            return self._resolve_call(func.id, args, kwargs, fi)
        return self._call_value(self.eval(func, env, fi), args, kwargs, fi)

    def _call_value(self, v: _V, args: list, kwargs: dict,
                    fi: FunctionInfo) -> _V:
        if isinstance(v, VFunc):
            return self.call_closure(v, args, kwargs)
        if isinstance(v, VFactory):
            return VInstance(v.cls, {})
        if isinstance(v, VRef):
            return self._resolve_call(v.dotted, args, kwargs, fi)
        return UNKNOWN

    def _resolve_call(self, dotted: str, args: list, kwargs: dict,
                      fi: FunctionInfo) -> _V:
        op = self.graph.counted_op(fi.module, dotted)
        if op is not None:
            self.launches[op] += 1
            return OPAQUE  # an in-flight device payload — non-None
        if self.graph.is_device_get(fi.module, dotted):
            self.host_syncs += 1
            return OPAQUE
        short = dotted.rsplit(".", 1)[-1]
        if short in _RETURNS_ARG0:
            return args[0] if args else kwargs.get("spec", UNKNOWN)
        q = self.graph.resolve(fi.module, dotted)
        if q is not None:
            target = self.graph.functions.get(q)
            if target is not None:
                return self.call_function(target, None, args, kwargs)
            if q in self.graph.classes:
                return VInstance(q, {})
        return UNKNOWN


# -- entry-point configuration ------------------------------------------------
# Adapter receiver bindings: ``self.<attr>`` types the call graph cannot
# infer (``self._scan = scan`` with an unannotated parameter). This is
# config, not inference — wrong entries here produce a certificate the
# runtime cross-validation test rejects.

_SCAN = "repro_torch.core.scan.ColumnarScan"
_INDEX = "repro_torch.core.blockindex.BlockedIndex"
_VAFILE = "repro_torch.core.vafile.VAFile"

PATH_ENTRIES: dict[str, tuple[str, dict]] = {
    "scan": ("repro_torch.core.paths.ColumnarScanPath",
             {"_scan": ("inst", _SCAN)}),
    "scan_vertical": ("repro_torch.core.paths.VerticalScanPath",
                      {"_scan_ref": ("factory", _SCAN)}),
    "kdtree": ("repro_torch.core.paths.BlockedIndexPath",
               {"_index": ("inst", _INDEX)}),
    "rstar": ("repro_torch.core.paths.BlockedIndexPath",
              {"_index": ("inst", _INDEX)}),
    "vafile": ("repro_torch.core.paths.VAFilePath",
               {"_vafile": ("inst", _VAFILE)}),
}

ENGINE_CLASS = "repro_torch.core.engine.MDRQEngine"
PENDING_CLASS = "repro_torch.core.engine.PendingBatch"
SERVER_CLASS = "repro_torch.serve.pipeline.PipelinedMDRQServer"


def _receivers(spec: dict) -> dict:
    out = {}
    for attr, (kind, cls) in spec.items():
        out[attr] = VInstance(cls, {}) if kind == "inst" else VFactory(cls)
    return out


def _delta_view() -> VInstance:
    # The live-delta context: a non-empty DeltaView. ``is_empty`` is the one
    # attribute the launch paths branch on; its device-array methods come
    # back OPAQUE (non-None) from the interpreter's instance-method fallback.
    return VInstance("__delta__", {"is_empty": FALSE})


def _walk_method(graph: CallGraph, cls_qual: str, method: str,
                 receivers: dict, kwargs: dict) -> dict:
    fi = graph.lookup_method(cls_qual, method)
    if fi is None:
        raise BudgetError(f"entry point {cls_qual}.{method} not found — "
                          "PATH_ENTRIES config has drifted from the source")
    it = _Interp(graph)
    it.call_function(fi, VInstance(cls_qual, dict(receivers)), [OPAQUE],
                     dict(kwargs))
    return {"launches": dict(sorted(it.launches.items())),
            "host_syncs": it.host_syncs}


def certify(graph: CallGraph) -> dict:
    """Derive the whole budget certificate from the call graph."""
    paths: dict = {}
    for name, (cls_qual, recv_spec) in sorted(PATH_ENTRIES.items()):
        entry: dict = {}
        for ctx_name, delta in (("frozen", NONE), ("delta", _delta_view())):
            recv = _receivers(recv_spec)
            total = _walk_method(graph, cls_qual, "query_batch", recv,
                                 {"spec": OPAQUE, "delta": delta})
            stage = _walk_method(graph, cls_qual, "launch_batch", recv,
                                 {"spec": OPAQUE, "delta": delta})
            entry[ctx_name] = {
                "total": total,
                "device_stage": stage,
                "finalize_host_syncs":
                    total["host_syncs"] - stage["host_syncs"],
            }
        paths[name] = entry

    engine = {
        # The engine is pure routing: certified to add zero launches/syncs
        # of its own — every counted op in a batch is attributable to the
        # bucket's access path (the per-path table above).
        "MDRQEngine.launch_batch": _walk_method(
            graph, ENGINE_CLASS, "launch_batch", {}, {}),
        "MDRQEngine.query_batch": _walk_method(
            graph, ENGINE_CLASS, "query_batch", {}, {}),
        # Host stage of the split protocol: one counted sync per bucket
        # (the interpreter's loop unit IS the bucket).
        "PendingBatch.finalize": {"per_bucket": _walk_method(
            graph, PENDING_CLASS, "finalize", {}, {})},
    }

    serve = {
        # Both pipelined stages certified sync-free in their own frame: the
        # device stage (flush) only launches via engine.launch_batch; the
        # finalizer thread's syncs are PendingBatch.finalize's per-bucket
        # cost, accounted above.
        "PipelinedMDRQServer.flush": _walk_method(
            graph, SERVER_CLASS, "flush",
            {"engine": VInstance(ENGINE_CLASS, {})}, {}),
        "PipelinedMDRQServer._finalize_loop": _walk_method(
            graph, SERVER_CLASS, "_finalize_loop",
            {"engine": VInstance(ENGINE_CLASS, {})}, {}),
    }

    return {
        "_comment": (
            "The port's statically certified per-batch-window launch/host-"
            "sync budgets (repro_torch.analysis.budget over the project call "
            "graph; stdlib-ast only); every other leaf equals BUDGET.json's. "
            "Regenerate with `PYTHONPATH=src python -m repro_torch.analysis "
            "--budget BUDGET_torch.json`; `--budget-check BUDGET_torch.json` "
            "diffs it — a budget change must ship with its regenerated "
            "certificate. tests/test_torch_budget.py asserts these numbers "
            "equal the mdrq_launches_total counter deltas of every warm "
            "path; chip_smoke.py's budget phase holds them on the card, "
            "with no uncounted sync."),
        "unit": "per bucket (one fused launch group) per batch window",
        "paths": paths,
        "engine": engine,
        "serve": serve,
    }


def render(cert: dict) -> str:
    return json.dumps(cert, indent=2, sort_keys=True) + "\n"


def diff_certificate(old: dict, new: dict) -> list[str]:
    """Human-readable leaf-level differences (old -> new)."""
    out: list[str] = []

    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                walk(a.get(k), b.get(k), f"{path}.{k}" if path else k)
        elif a != b:
            out.append(f"{path}: {a!r} -> {b!r}")
    walk(old, new, "")
    return out


def check(graph: CallGraph, path: Path) -> list[str]:
    """Diff the checked-in certificate against a fresh derivation."""
    if not path.exists():
        return [f"{path}: missing — run `python -m repro_torch.analysis "
                f"--budget {path.name}`"]
    on_disk = json.loads(path.read_text())
    return diff_certificate(on_disk, certify(graph))
