"""The port's four contract rules (``raw-shard-map`` in
``repro_torch.analysis.rules``; ``kernel-tile``, ``kernel-dtype`` and
``note-trace`` in ``repro_torch.analysis.contracts``): a planted fault of
each is flagged and its accepted form is clean, and the shipped port tree
with the port's examples lints clean under all ten rules. Mirrors the
reference's contract-rule tests in ``tests/test_analysis.py``.
"""
from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import engine
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.contracts import (KernelDtypeRule, KernelTileRule,
                                            NoteTraceRule)
from repro_torch.analysis.rules import (ALL_RULES, HostSyncRule,
                                        RawShardMapRule)

REPO = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = ("quickstart_torch.py", "gmrqb_demo_torch.py",
                 "batched_queries_torch.py")


def lint_one(tmp_path: Path, rel: str, source: str, rule) -> engine.Report:
    """Write ``source`` at tmp/<rel> and run a single rule over it."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return engine.run([path], [rule])


def lint_tree(tmp_path: Path, files: dict[str, str], rule) -> engine.Report:
    """Write a package (an ``__init__.py`` at every level below tmp) and
    run ``rule`` over all of it."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        d = p.parent
        while d != tmp_path:
            (d / "__init__.py").touch()
            d = d.parent
    return engine.run([tmp_path], [rule])


# -- raw-shard-map --------------------------------------------------------------

@pytest.mark.parametrize("copy", ["t.to(dev)", "t.to(dev, non_blocking=True)",
                                  "t.to(device=dev)", "t.to('cuda:1')",
                                  "t.cuda(1)", "out.copy_(t)"])
def test_raw_shard_map_flags_device_copies(tmp_path, copy):
    rep = lint_one(tmp_path, "repro_torch/core/spread.py", f"""\
        import torch

        def spread(t, dev, out):
            return {copy}
        """, RawShardMapRule())
    assert [f.rule for f in rep.active] == ["raw-shard-map"]
    assert "DataMesh.replicate/gather" in rep.active[0].message


def test_raw_shard_map_accepts_casts_uploads_and_the_mesh(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/casts.py", """\
        import numpy as np
        import torch

        F32 = torch.float32

        def casts(t, a, dev, data):
            x = t.to(torch.int32) + t.to(F32) + t.to(data.dtype)
            y = t.to(dtype=torch.bfloat16)
            up = torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
            return x, y, up, torch.as_tensor(a, device=dev)
        """, RawShardMapRule())
    assert rep.active == []
    rep = lint_one(tmp_path, "repro_torch/core/distributed.py", """\
        def replicate(t, devices):
            return [t.to(d) for d in devices]
        """, RawShardMapRule())
    assert rep.active == []


def test_raw_shard_map_scoped_to_the_port(tmp_path):
    rep = lint_one(tmp_path, "repro/core/spread.py", """\
        def spread(t, dev):
            return t.to(dev)
        """, RawShardMapRule())
    assert rep.active == []


# -- kernel-tile ----------------------------------------------------------------

def test_kernel_tile_flags_unchecked_launch_division(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/tiles.py", """\
        import torch
        from repro_torch.kernels import _build

        def launch(data, tile, dev):
            n_pad = data.shape[1]
            blocks = n_pad // tile
            out = torch.empty((n_pad // (4 * tile),), dtype=torch.float32)
            _build.launch("k", "sym", dev, data, blocks, out)
            return out
        """, KernelTileRule())
    assert [f.rule for f in rep.active] == ["kernel-tile", "kernel-tile"]
    assert "n_pad // tile" in rep.active[0].message
    assert "n_pad // (4 * tile)" in rep.active[1].message


def test_kernel_tile_follows_a_call_result_into_the_launch(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/tiles.py", """\
        from repro_torch.kernels import _build

        def launch(data, ids, tile, dev):
            m_pad, n_pad = data.shape
            keys, order = schedule(ids, n_pad // tile)
            _build.launch("k", "sym", dev, data, keys, order)
        """, KernelTileRule())
    assert [f.rule for f in rep.active] == ["kernel-tile"]


def test_kernel_tile_accepts_asserts_checkers_and_ceilings(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/tiles.py", """\
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels.range_scan import (VEC, block_threads,
                                                    check_tiling)

        def asserted(data, tile, dev):
            n_pad = data.shape[1]
            assert n_pad % tile == 0, "pad first"
            _build.launch("k", "sym", dev, data, n_pad // tile)

        def checked(data, tile, dev):
            m_pad, n_pad = data.shape
            check_tiling(m_pad, n_pad, tile)
            _build.launch("k", "sym", dev, data, n_pad // tile)

        def threads_backed(data, dev):
            n_pad = data.shape[1]
            threads = block_threads(n_pad)
            partials = torch.empty((n_pad // (VEC * threads),),
                                   dtype=torch.float32)
            _build.launch("k", "sym", dev, data, partials, threads)

        def ceiling(data, tile, dev):
            n_tiles = -(-data.shape[1] // tile)
            _build.launch("k", "sym", dev, data, n_tiles)

        def host_only(data, tile):
            return data.shape[1] // tile      # sizes no launch
        """, KernelTileRule())
    assert rep.active == []


def test_kernel_tile_scoped_to_the_port_kernels(tmp_path):
    src = """\
        from repro_torch.kernels import _build

        def launch(data, tile, dev):
            _build.launch("k", "sym", dev, data, data.shape[1] // tile)
        """
    assert lint_one(tmp_path, "repro_torch/core/tiles.py", src,
                    KernelTileRule()).active == []
    assert lint_one(tmp_path, "repro/kernels/tiles.py", src,
                    KernelTileRule()).active == []


# -- kernel-dtype ---------------------------------------------------------------

def test_kernel_dtype_flags_defaulted_creators_and_inf_fills(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/ref.py", """\
        import math
        import torch

        def plain(masks, n):
            acc = torch.zeros((n,))
            pad = torch.full((n,), -float("inf"), dtype=torch.bfloat16)
            masks.masked_fill_(masks == 0, math.inf)
            return acc, pad
        """, KernelDtypeRule())
    assert [f.rule for f in rep.active] == ["kernel-dtype"] * 3
    assert "torch.zeros" in rep.active[0].message
    assert all("inf fill" in f.message for f in rep.active[1:])


def test_kernel_dtype_accepts_explicit_dtypes_and_mask_fill(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/reducers.py", """\
        import torch
        from repro_torch import numerics

        def plain(masks, x, n):
            acc = torch.zeros((n,), dtype=torch.float32)
            ones = torch.ones_like(x)
            pad = torch.full((n,), float("inf"), dtype=torch.float32)
            s = x.masked_fill(masks == 0, numerics.mask_fill(x.dtype))
            return acc, ones, pad, s
        """, KernelDtypeRule())
    assert rep.active == []


def test_kernel_dtype_scoped_to_ref_and_the_wrappers(tmp_path):
    src = """\
        import torch

        def helper(n):
            return torch.zeros((n,))
        """
    for rel in ("repro_torch/kernels/ops.py", "repro_torch/core/scan.py"):
        assert lint_one(tmp_path, rel, src, KernelDtypeRule()).active == []
    assert len(lint_one(tmp_path, "repro_torch/kernels/va_filter.py", src,
                        KernelDtypeRule()).active) == 1


# -- note-trace -----------------------------------------------------------------

_OPS_COUNTED = '''\
    def _bump(name, key=None):
        pass

    def warm_key(name, args, kwargs):
        return (name, args)

    def counted(name, doc):
        def deco(fn):
            def wrapper(*args, **kwargs):
                _bump(name, warm_key(name, args, kwargs))
                return fn(*args, **kwargs)
            return wrapper
        return deco
    '''


def test_note_trace_flags_an_op_body_reached_outside_counted(tmp_path):
    rep = lint_tree(tmp_path, {"repro_torch/kernels/ops.py": _OPS_COUNTED + '''
    def _scan(x):
        return x + 1

    scan = counted("scan", "the scan")(_scan)

    def shortcut(x):
        return _scan(x)          # no warm key, no counter
    '''}, NoteTraceRule())
    assert [f.rule for f in rep.active] == ["note-trace"]
    assert "'_scan'" in rep.active[0].message
    assert "shortcut" in rep.active[0].message


def test_note_trace_flags_a_counted_that_notes_no_warm_key(tmp_path):
    rep = lint_tree(tmp_path, {"repro_torch/kernels/ops.py": '''\
    def _bump(name, key=None):
        pass

    def counted(name, doc):
        def deco(fn):
            def wrapper(*args, **kwargs):
                _bump(name)
                return fn(*args, **kwargs)
            return wrapper
        return deco
    '''}, NoteTraceRule())
    assert [f.rule for f in rep.active] == ["note-trace"]
    assert "warm_key" in rep.active[0].message


def test_note_trace_accepts_bodies_reached_from_counted_bodies(tmp_path):
    rep = lint_tree(tmp_path, {"repro_torch/kernels/ops.py": _OPS_COUNTED + '''
    def _scan(x):
        return x + 1

    scan = counted("scan", "the scan")(_scan)

    def _scan_reduce(x):
        return _scan(x).sum()    # reached only through counted(scan_reduce)

    scan_reduce = counted("scan_reduce", "scan + sum")(_scan_reduce)
    '''}, NoteTraceRule())
    assert rep.active == []


# -- the shipped tree -----------------------------------------------------------

def test_host_sync_covers_the_port_examples(tmp_path):
    src = """\
        from repro_torch.kernels import ops

        def main(eng, q):
            out = ops.multi_scan_reduce(q)
            return float(out)
        """
    rep = lint_one(tmp_path, "examples/demo_torch.py", src, HostSyncRule())
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert lint_one(tmp_path, "examples/demo.py", src,
                    HostSyncRule()).active == []


def test_port_tree_and_examples_clean_under_ten_rules():
    """``python -m repro_torch.analysis src/repro_torch <the port
    examples>`` runs the ten rules and carries no active finding; every
    suppression has its reason on the line above."""
    assert len(ALL_RULES) == 10
    paths = [str(REPO / "src" / "repro_torch")] + [
        str(REPO / "examples" / e) for e in PORT_EXAMPLES]
    assert lint_main(paths) == 0
    rep = engine.run([Path(p) for p in paths], ALL_RULES,
                     baseline=engine.load_baseline())
    assert rep.active == [] and rep.baselined == [] and rep.errors == []
    for f in rep.suppressed:
        lines = Path(f.file).read_text().splitlines()
        assert lines[f.line - 2].strip().startswith("#"), f.format()
    assert lint_main([str(REPO / "src" / "repro_torch"), "--budget-check",
                      str(REPO / "BUDGET_torch.json")]) == 0


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
