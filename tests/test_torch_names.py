"""No public name of the reference goes missing from the port unseen.

For every module of ``src/repro`` with a counterpart under
``src/repro_torch``, the reference's public top-level names (``def``,
``class``, assignments) and its classes' public methods must exist in the
port's module (a name the port imports into it counts). A reference module
with no counterpart must be listed in ``MISSING_MODULES``. Each name or
module left out is in an allow-list here with its reason: a JAX construct,
with the port construct that takes its place, or the roadmap item that
will port it. An allow-list entry the port has since ported fails too, so
the lists stay true.
"""
from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

ITEM3 = "ROADMAP queue 1 item 3: the benchmark PR"
ITEM5 = "ROADMAP queue 1 item 5: the mesh and compile tools"

MISSING_MODULES = {
    "launch/perf.py": ITEM5,
}

_BARE = ("JAX construct (a value tagged with its logical sharding axes); "
         "port: bare tensors, their axes in models.params.LEAF_AXES")

_AOT = ("JAX construct (AOT compile cache / retrace probe); port: the warm "
        "keys of ops.counted and PipelinedMDRQServer.warmup")
_BACKEND = ("JAX construct (Pallas interpret / XLA backend switch); port: "
            "the backend= argument and ops.check_backend")

MISSING_NAMES = {
    "core/distributed.py": {
        "shard_map_compat": "JAX construct (shard_map API drift); port: "
                            "DataMesh"},
    "core/scan.py": {"xla_scan_mask": ITEM3},
    "kernels/kv_visit.py": {
        "F32": "JAX construct (the Pallas kernel's dtype); port: the "
               "kernel's own fill",
        "NEG": "JAX construct (the Pallas kernel's mask value); port: the "
               "kernel's own fill"},
    "kernels/ops.py": {
        "note_trace": _AOT, "aot_capture": _AOT, "aot_cache_keys": _AOT,
        "aot_cache_size": _AOT, "aot_counters": _AOT,
        "clear_aot_cache": _AOT, "set_backend": _BACKEND,
        "use_xla": _BACKEND, "default_interpret": _BACKEND},
    "models/params.py": {
        "Param": _BARE,
        "is_param": _BARE,
        "split_tree": _BARE + "; count_params and leaves take the tree "
                              "as it is, axes_for gives its axes",
        "stack_layer_params": "JAX construct (a stacked leading layer axis "
                              "for lax.scan); port: per-layer lists "
                              "(models.convert.from_jax_params unstacks "
                              "the reference's)"},
}


def public_names(path: Path) -> set[str]:
    """Top-level defs, classes and assigned names, and ``Class.method`` for
    each class's methods; names with a leading underscore left out."""
    out: set[str] = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{item.name}" for item in node.body
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def _module(rel: str) -> str:
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["repro_torch", *parts])


def _present(mod, name: str) -> bool:
    obj = mod
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
PORTED = [rel for rel in REF_MODULES if (PORT / rel).exists()]


def test_every_reference_module_is_ported_or_listed():
    missing = {rel for rel in REF_MODULES if not (PORT / rel).exists()}
    assert missing == set(MISSING_MODULES)
    assert "analysis/contracts.py" in PORTED


@pytest.mark.parametrize("rel", PORTED)
def test_public_names_are_ported_or_listed(rel):
    mod = importlib.import_module(_module(rel))
    allowed = MISSING_NAMES.get(rel, {})
    missing = {n for n in public_names(REF / rel) if not _present(mod, n)}
    assert missing == set(allowed), (
        f"{rel}: missing without a reason {sorted(missing - set(allowed))}; "
        f"listed but present {sorted(set(allowed) - missing)}")
    assert all(reason for reason in allowed.values())


def test_allow_lists_name_only_reference_modules():
    assert set(MISSING_NAMES) <= set(PORTED)
    assert all(rel in REF_MODULES for rel in MISSING_MODULES)
