"""The port's import rule: nothing of ``repro_torch`` and nothing of
``chip_smoke.py``, the tools that drive the port on the card or the port's
examples (``examples/*_torch.py``) imports ``jax`` or the reference package
``repro``.

Two checks: a fresh interpreter imports every module of ``src/repro_torch``,
``chip_smoke.py``'s helpers, the tools and the port's examples and must end
with neither package in ``sys.modules``; and every ``import`` statement of those files, including
the ones inside functions that run only on the card, names neither.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TOOLS = tuple(sorted((ROOT / "tools").glob("*.py")))
EXAMPLES = tuple(ROOT / "examples" / name for name in (
    "quickstart_torch.py", "gmrqb_demo_torch.py", "batched_queries_torch.py"))
SCRIPTS = (ROOT / "chip_smoke.py", *TOOLS, *EXAMPLES)
FORBIDDEN = ("jax", "jaxlib", "repro")

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}, {tools!r}, {examples!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for tool in {tools_mods!r}:
    importlib.import_module(tool)
print(json.dumps({{"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in {forbidden!r})}}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_neither_jax_nor_repro():
    tools_mods = [p.stem for p in TOOLS + EXAMPLES]
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                         tools=str(ROOT / "tools"),
                         examples=str(ROOT / "examples"),
                         tools_mods=tools_mods, forbidden=FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.pipeline" in rep["modules"]
    assert "repro_torch.obs.audit" in rep["modules"]
    assert rep["loaded"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_no_import_statement_names_jax_or_repro():
    files = [*sorted(PORT.rglob("*.py")), *SCRIPTS]
    assert len(files) > 40
    bad = [(str(path.relative_to(ROOT)), line, name) for path in files
           for line, name in _imports(path) if _forbidden(name)]
    assert bad == []
