"""Kernel-contract rules of the port's mdrqlint.

Ports ``repro/analysis/contracts.py``. The kernels under ``kernels/`` follow
one physical contract: a launch is sized from padded extents that divide
their tiles (no partial tile is dropped), the plain versions and the
wrappers state the dtype of what they create instead of inheriting
PyTorch's defaults, and every public op reaches its body through
``ops.counted``, which notes the call's warm key (the port's counterpart of
the reference's ``ops.note_trace`` probe: the key set the pipelined server's
warmup asserts steady traffic does not grow). Each clause is a rule,
restated for the port's construct:

``kernel-tile``
    in ``kernels/*.py``, every floor division ``a // b`` that sizes a launch
    — one that reaches an argument of ``_build.launch`` in the same
    function, directly or through local assignments (the shape of a tensor
    passed to it included) — must be backed in that function by an
    ``assert a % b == 0`` or by a call to a checker that raises on a
    remainder (``CHECKERS``): every name of the divisor ``b`` (upper-case
    module constants aside) is an argument of such a call, or bound from
    its result. Ceiling divisions ``-(-a // b)`` cover the remainder by
    construction and pass.

``kernel-dtype``
    in ``kernels/ref.py`` and the wrapper modules, ``torch.zeros/ones/
    empty/full`` pass an explicit ``dtype`` (a defaulted float32
    accumulator silently changes the type of what the kernel is held
    against), and an ``inf`` fill states a wide dtype — ``fill_`` /
    ``masked_fill`` / ``new_full`` of an ``inf`` take the target's dtype,
    so they use ``numerics.mask_fill`` instead.

``note-trace``
    the impl registered through ``counted(...)(impl)`` is referenced only
    by its registration and from counted bodies (never from a public
    function outside the counted set, nor at module level), so every call
    that reaches an op's body passes through ``counted``; and ``counted``'s
    wrapper opens by noting the warm key (``_bump(name, warm_key(...))``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import FileContext, Finding, Rule
from repro_torch.analysis.rules import (_WRAPPER_MODULES, _body_nodes,
                                        _dotted, _in_port, _launch_graph,
                                        _module_level_nodes, _ModuleLevel)

# Functions that raise unless their arguments divide: a call backs the
# divisions whose divisor it was given (or whose divisor it returned).
CHECKERS = ("check_tiling", "check_visits", "block_threads")
_LAUNCH = "launch"          # ``_build.launch``, the one way onto the card


def _in_kernels(posix: str) -> bool:
    return _in_port(posix) and "/kernels/" in posix


def _is_ceil(div: ast.BinOp) -> bool:
    """``(-a) // b``: the inner half of the ceiling idiom ``-(-a // b)``."""
    return isinstance(div.left, ast.UnaryOp) \
        and isinstance(div.left.op, ast.USub)


def _floor_divs(node: ast.AST) -> list[ast.BinOp]:
    return [d for d in ast.walk(node)
            if isinstance(d, ast.BinOp) and isinstance(d.op, ast.FloorDiv)
            and not _is_ceil(d)]


def _names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _mod_assert_pairs(fn: ast.AST) -> set[tuple[str, str]]:
    """All ``(a, b)`` with an ``assert ... a % b == 0 ...`` in ``fn``."""
    pairs: set[tuple[str, str]] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assert):
            continue
        for cmp in ast.walk(node.test):
            if isinstance(cmp, ast.Compare) \
                    and isinstance(cmp.left, ast.BinOp) \
                    and isinstance(cmp.left.op, ast.Mod) \
                    and len(cmp.ops) == 1 \
                    and isinstance(cmp.ops[0], ast.Eq) \
                    and isinstance(cmp.comparators[0], ast.Constant) \
                    and cmp.comparators[0].value == 0:
                pairs.add((ast.unparse(cmp.left.left),
                           ast.unparse(cmp.left.right)))
    return pairs


def _checked_names(fn: ast.AST) -> set[str]:
    """Names a checker call in ``fn`` vouches for: its arguments and the
    names bound from its result."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and (_dotted(node.func) or "").rsplit(
                ".", 1)[-1] in CHECKERS:
            for a in list(node.args) + [k.value for k in node.keywords]:
                out |= _names(a)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and (_dotted(node.value.func) or "").rsplit(
                    ".", 1)[-1] in CHECKERS:
            for tgt in node.targets:
                out |= _names(tgt)
    return out


def _launch_divs(fn: ast.AST) -> list[ast.BinOp]:
    """Floor divisions of ``fn`` that reach an argument of
    ``_build.launch``: directly, or through the names ``fn``'s assignments
    bind from them (a fixpoint, in no particular order; a tensor created
    with such a shape is such a name)."""
    carries: dict[str, dict[int, ast.BinOp]] = {}

    def carried(expr: ast.AST) -> dict[int, ast.BinOp]:
        out = {id(d): d for d in _floor_divs(expr)}
        for name in _names(expr):
            out.update(carries.get(name, {}))
        return out

    assigns = [(n.targets if isinstance(n, ast.Assign) else [n.target],
                n.value) for n in ast.walk(fn)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
               and n.value is not None]
    changed = True
    while changed:
        changed = False
        for tgts, value in assigns:
            divs = carried(value)
            for name in set().union(*(_names(t) for t in tgts)):
                known = carries.setdefault(name, {})
                if divs.keys() - known.keys():
                    known.update(divs)
                    changed = True
    hits: dict[int, ast.BinOp] = {}
    for node in ast.walk(fn):
        f = _dotted(node.func) if isinstance(node, ast.Call) else None
        if f and f.rsplit(".", 1)[-1] == _LAUNCH and "_build" in f:
            for a in list(node.args) + [k.value for k in node.keywords]:
                hits.update(carried(a))
    return sorted(hits.values(), key=lambda d: (d.lineno, d.col_offset))


class KernelTileRule(Rule):
    rule_id = "kernel-tile"
    doc = ("In kernels/, every floor division that sizes a launch (reaches "
           "an argument of _build.launch, or the shape of a tensor passed to "
           "it) needs an 'assert a % b == 0' or a checker call "
           "(check_tiling, check_visits, block_threads) for its divisor in "
           "the same function; an inexact division drops the remainder tile "
           "(wrong answers for tail objects only).")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_kernels(ctx.posix):
            return []
        findings: list[Finding] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            divs = _launch_divs(fn)
            if not divs:
                continue
            pairs = _mod_assert_pairs(fn)
            checked = _checked_names(fn)
            for div in divs:
                a, b = ast.unparse(div.left), ast.unparse(div.right)
                names = {n for n in _names(div.right) if not n.isupper()}
                if (a, b) in pairs or (names and names <= checked):
                    continue
                bb = f"({b})" if isinstance(div.right, ast.BinOp) else b
                findings.append(self.finding(
                    ctx, div, f"launch sized by '{a} // {bb}' without "
                    f"'assert {a} % {bb} == 0' or a checker call "
                    f"({', '.join(CHECKERS)}) for '{b}' in '{fn.name}' — an "
                    "inexact division drops the remainder tile"))
        return findings


_CREATORS = ("zeros", "ones", "empty", "full")
_INF_FILLS = ("full", "full_like", "new_full", "fill_", "masked_fill",
              "masked_fill_", "tensor")
_INF_NAMES = {"np.inf", "torch.inf", "math.inf", "inf"}
_WIDE_DTYPES = {"torch.float32", "torch.float64", "torch.float",
                "torch.double", "np.float32", "np.float64"}


def _is_inf(e: ast.AST) -> bool:
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.USub, ast.UAdd)):
        return _is_inf(e.operand)
    if isinstance(e, ast.Call) and _dotted(e.func) == "float" and e.args:
        a = e.args[0]
        return isinstance(a, ast.Constant) and isinstance(a.value, str) \
            and "inf" in a.value.lower()
    return _dotted(e) in _INF_NAMES


def _in_dtype_scope(posix: str) -> bool:
    """``kernels/ref.py`` and the wrapper modules."""
    if not _in_kernels(posix):
        return False
    stem = posix.rsplit("/", 1)[-1].removesuffix(".py")
    return stem == "ref" or stem in _WRAPPER_MODULES


class KernelDtypeRule(Rule):
    rule_id = "kernel-dtype"
    doc = ("In kernels/ref.py and the wrappers, torch.zeros/ones/empty/full "
           "state their dtype (a defaulted accumulator changes the type the "
           "kernel is held against), and inf fills state a wide dtype or use "
           "numerics.mask_fill (PR 3's bf16 sentinel bug shape).")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_dtype_scope(ctx.posix):
            return []
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            short = name.rsplit(".", 1)[-1]
            dtype = next((k.value for k in node.keywords if k.arg == "dtype"),
                         None)
            if name.startswith("torch.") and short in _CREATORS \
                    and dtype is None:
                findings.append(self.finding(
                    ctx, node, f"'torch.{short}' without an explicit dtype — "
                    "a defaulted float32 changes the type the kernel is held "
                    "against; state it"))
            if short in _INF_FILLS:
                vals = list(node.args) + [k.value for k in node.keywords]
                if any(_is_inf(v) for v in vals) \
                        and _dotted(dtype) not in _WIDE_DTYPES:
                    findings.append(self.finding(
                        ctx, node, f"inf fill through '{short}' without a "
                        "wide dtype — use numerics.mask_fill(dtype) for a "
                        "finite sentinel or state a float32 dtype"))
        return findings


def _counted_impls(tree: ast.AST) -> dict[str, ast.AST]:
    """impl name -> registration node of every ``counted(...)(impl)``."""
    out: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Call) \
                and (_dotted(node.func.func) or "").rsplit(
                    ".", 1)[-1].strip("_") == "counted":
            for a in node.args:
                n = _dotted(a)
                if n:
                    out[n.rsplit(".", 1)[-1]] = node
    return out


class NoteTraceRule(Rule):
    rule_id = "note-trace"
    doc = ("Every public op reaches its body only through ops.counted, whose "
           "wrapper notes the call's warm key first — the record the "
           "pipelined server's warmup asserts steady traffic does not grow.")

    def check(self, ctx: FileContext) -> list[Finding]:
        if not _in_port(ctx.posix) or "/analysis/" in ctx.posix:
            return []
        findings: list[Finding] = []
        if ctx.posix.endswith("kernels/ops.py"):
            findings += self._check_counted(ctx)
        impls = _counted_impls(ctx.tree)
        if not impls or ctx.project is None:
            return findings
        lg = _launch_graph(ctx.project)
        g = ctx.project.graph
        module = ctx.module
        scopes = [(fi, _body_nodes(fi.node)) for fi in g.functions.values()
                  if fi.module == module and fi.qual not in lg.bodies]
        if module in g.modules:
            scopes.append((_ModuleLevel(module),
                           _module_level_nodes(g.modules[module].tree)))
        registered = {id(a) for reg in impls.values() for a in reg.args}
        for fi, nodes in scopes:
            where = getattr(fi, "qual", f"module {module}")
            for node in nodes:
                if isinstance(node, ast.Name) and node.id in impls \
                        and isinstance(node.ctx, ast.Load) \
                        and id(node) not in registered:
                    findings.append(self.finding(
                        ctx, node, f"counted op body '{node.id}' reached from "
                        f"{where}, outside ops.counted — its calls note no "
                        "warm key and bump no counter"))
        return findings

    def _check_counted(self, ctx: FileContext) -> list[Finding]:
        """``counted``'s inner wrapper opens with ``_bump(name,
        warm_key(...))``."""
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, ast.FunctionDef) and fn.name == "counted":
                inner = [d for d in ast.walk(fn)
                         if isinstance(d, ast.FunctionDef) and d is not fn]
                for w in inner:
                    first = w.body[0] if w.body else None
                    call = first.value if isinstance(first, ast.Expr) else None
                    if isinstance(call, ast.Call) \
                            and _dotted(call.func) == "_bump" \
                            and len(call.args) == 2 \
                            and isinstance(call.args[1], ast.Call) \
                            and _dotted(call.args[1].func) == "warm_key":
                        return []
                return [self.finding(
                    ctx, fn, "counted's wrapper does not open with "
                    "_bump(name, warm_key(...)) — its ops' calls would note "
                    "no warm key")]
        return [self.finding(ctx, ctx.tree.body[0] if ctx.tree.body
                             else ctx.tree,
                             "kernels/ops.py defines no counted(...)")]


CONTRACT_RULES = (KernelTileRule(), KernelDtypeRule(), NoteTraceRule())
