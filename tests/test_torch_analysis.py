"""The port's mdrqlint (``repro_torch.analysis``): per-rule flag and accept
fixtures with the torch sinks and sources, suppression and baseline round
trips, the CLI's exit codes, and the standing assertion that the port's
tree lints clean.

Fixtures are written to tmp dirs whose layout mimics ``repro_torch/...``:
rules scope themselves by posix-path substring, and the project-wide rules
(``uncounted-launch``) name modules by their ``__init__.py`` parents, so
those fixtures are whole packages. Mirrors ``tests/test_analysis.py``.
"""
from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import engine
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.rules import (ALL_RULES, HostSyncRule,
                                        LockDisciplineRule,
                                        RegistryHygieneRule, SentinelRule,
                                        ThreadBoundaryRule,
                                        UncountedLaunchRule)

REPO = Path(__file__).resolve().parents[1]


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


# -- rule 1: host-sync --------------------------------------------------------

def test_host_sync_flags_raw_coercions(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/bad_sync.py", """\
        import numpy as np
        import torch
        from repro_torch.kernels import ops

        def leaky(q):
            out = ops.multi_scan_reduce(q)        # device-value source
            torch.cuda.synchronize()              # raw sync API
            return float(out)                     # raw coercion sink
        """, HostSyncRule())
    rules = [f.rule for f in rep.active]
    assert rules == ["host-sync", "host-sync"]
    assert "torch.cuda.synchronize" in rep.active[0].message
    assert "float()" in rep.active[1].message


@pytest.mark.parametrize("sink", ["out.item()", "out.tolist()", "out.cpu()",
                                  "out.numpy()", "out.to('cpu')",
                                  "out.to(device='cpu')",
                                  "out.to(torch.device('cpu'))",
                                  "np.asarray(out)", "int(out.sum())",
                                  "bool(out.any())"])
def test_host_sync_flags_each_torch_sink(tmp_path, sink):
    rep = lint_one(tmp_path, "repro_torch/core/sink.py", f"""\
        import numpy as np
        import torch
        from repro_torch.kernels import ops

        def leaky(q):
            out = ops.multi_scan_reduce(q)
            return {sink}
        """, HostSyncRule())
    assert [f.rule for f in rep.active] == ["host-sync"], sink
    assert "uncounted host sync" in rep.active[0].message


def test_host_sync_flags_stream_synchronize(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/serve/bad_wait.py", """\
        import torch

        def wait(stream):
            stream.synchronize()
        """, HostSyncRule())
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert ".synchronize()" in rep.active[0].message


def test_host_sync_accepts_counted_device_get(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/good_sync.py", """\
        from repro_torch.kernels import ops

        def clean(q):
            out = ops.multi_scan_reduce(q)
            host = ops.device_get(out)            # the counted sync
            return float(host), host.tolist()     # host values: no sync
        """, HostSyncRule())
    assert rep.active == []


def test_host_sync_accepts_host_helpers_and_metadata(tmp_path):
    # ops' host helpers return host data; a tensor's shape lives on the host
    rep = lint_one(tmp_path, "repro_torch/core/meta.py", """\
        import numpy as np
        from repro_torch.kernels import ops

        def plan(cols, q):
            padded, m, n = ops.prepare_columnar(cols)
            out = ops.multi_scan_reduce(q)
            return (int(np.asarray(padded).sum()), int(out.shape[0]),
                    int(len(out)), int(out.numel()), str(out.dtype))
        """, HostSyncRule())
    assert rep.active == []


def test_host_sync_tracks_taint_through_helpers(tmp_path):
    # _launch returns a device value; the caller's np.asarray is the sync
    rep = lint_one(tmp_path, "repro_torch/core/chained.py", """\
        import numpy as np
        from repro_torch.kernels import ops

        def _launch(q):
            return ops.multi_scan_reduce(q)

        def caller(q):
            return np.asarray(_launch(q))
        """, HostSyncRule())
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert "asarray" in rep.active[0].message


def test_host_sync_treats_launch_batch_as_a_source(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/serve/peek.py", """\
        def peek(engine, queries):
            payload, fin = engine.launch_batch(queries)
            return payload.cpu()                  # the in-flight payload
        """, HostSyncRule())
    assert [f.rule for f in rep.active] == ["host-sync"]
    assert ".cpu()" in rep.active[0].message


def test_host_sync_allowlists_the_accounting_home(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/kernels/ops.py", """\
        def device_get(x):
            return x.cpu().numpy()
        """, HostSyncRule())
    assert rep.active == []


def test_host_sync_ignores_the_reference_package(tmp_path):
    rep = lint_one(tmp_path, "repro/core/bad_sync.py", """\
        from repro.kernels import ops

        def leaky(q):
            return float(ops.multi_scan_reduce(q))
        """, HostSyncRule())
    assert rep.active == []


# -- rule 2: uncounted-launch -------------------------------------------------

_OPS = """\
    from repro_torch.kernels import reducers as _red
    from repro_torch.kernels import _build

    def counted(name, doc):
        def deco(fn):
            return fn
        return deco

    def _fold(masks, tomb):
        return _red.fold_tombstones(masks, tomb)   # helper of a counted body

    def _reduce(masks, tomb):
        return _fold(masks, tomb)

    reduce = counted("reduce", "A counted op.")(_reduce)
    """

_REDUCERS = """\
    import torch

    def fold_tombstones(masks, tomb):
        return masks.mul_((tomb == 0).to(masks.dtype))
    """

_BUILD = """\
    def launch(name, sym, device, *args):
        pass

    def library(sym):
        pass
    """


def test_uncounted_launch_flags_a_wrapper_call_outside_counted_bodies(
        tmp_path):
    rep = lint_tree(tmp_path, {
        "repro_torch/kernels/ops.py": _OPS,
        "repro_torch/kernels/reducers.py": _REDUCERS,
        "repro_torch/kernels/_build.py": _BUILD,
        "repro_torch/core/leak.py": """\
            from repro_torch.kernels import reducers as _red

            def fold_outside(masks, tomb):
                return _red.fold_tombstones(masks, tomb)
            """,
    }, UncountedLaunchRule())
    assert [f.rule for f in rep.active] == ["uncounted-launch"]
    assert rep.active[0].file.endswith("core/leak.py")
    assert "'fold_tombstones' of kernels/reducers" in rep.active[0].message


def test_uncounted_launch_flags_a_helper_reachable_outside(tmp_path):
    """A helper of a counted body that an uncounted function also calls is
    no longer a counted body: its wrapper call is flagged."""
    ops = _OPS + """\

    def debug_fold(masks, tomb):
        return _fold(masks, tomb)
    """
    rep = lint_tree(tmp_path, {
        "repro_torch/kernels/ops.py": ops,
        "repro_torch/kernels/reducers.py": _REDUCERS,
        "repro_torch/kernels/_build.py": _BUILD,
    }, UncountedLaunchRule())
    assert [f.rule for f in rep.active] == ["uncounted-launch"]
    assert "repro_torch.kernels.ops._fold" in rep.active[0].message


def test_uncounted_launch_flags_the_compiled_extension(tmp_path):
    rep = lint_tree(tmp_path, {
        "repro_torch/kernels/ops.py": _OPS + """\

    def raw(x):
        _build.launch("raw", "mdrq_raw", x.device, x)
    """,
        "repro_torch/kernels/reducers.py": _REDUCERS,
        "repro_torch/kernels/_build.py": _BUILD,
    }, UncountedLaunchRule())
    assert [f.rule for f in rep.active] == ["uncounted-launch"]
    assert "'launch' of kernels/_build" in rep.active[0].message


def test_uncounted_launch_accepts_counted_bodies(tmp_path):
    # ops' counted op and its private helpers; a core module calling the
    # counted op through ops; the port's ``ops.counted(...)(fn)`` form with
    # a decorated impl, as core/distributed.py registers its ops
    rep = lint_tree(tmp_path, {
        "repro_torch/kernels/ops.py": _OPS,
        "repro_torch/kernels/reducers.py": _REDUCERS,
        "repro_torch/kernels/_build.py": _BUILD,
        "repro_torch/core/dist.py": """\
            import functools
            from repro_torch.kernels import ops
            from repro_torch.kernels import reducers as _red

            def _first(fn):
                @functools.wraps(fn)
                def wrapper(*a, **k):
                    return fn(*a, **k)
                return wrapper

            @_first
            def _dist_reduce(masks, tombs):
                return [_red.fold_tombstones(x, t)
                        for x, t in zip(masks, tombs)]

            dist_reduce = ops.counted("dist_reduce", "Counted.")(_dist_reduce)

            def serve(masks, tomb):
                return ops.reduce(masks, tomb), dist_reduce([masks], [tomb])
            """,
    }, UncountedLaunchRule())
    assert rep.active == []


def test_uncounted_launch_resolves_spec_methods_by_name(tmp_path):
    # ``spec.device_reduce(...)`` cannot be typed: it refers to every
    # project method of that name, so those methods are counted bodies only
    # while every such call sits in one
    spec_mod = """\
        from repro_torch.kernels import reducers

        class Count:
            def device_reduce(self, masks, tomb):
                return reducers.fold_tombstones(masks, tomb)
        """
    files = {
        "repro_torch/kernels/ops.py": _OPS + """\

    def _scan_reduce(masks, tomb, *, spec):
        return spec.device_reduce(masks, tomb)

    scan_reduce = counted("scan_reduce", "Counted.")(_scan_reduce)
    """,
        "repro_torch/kernels/reducers.py": _REDUCERS,
        "repro_torch/kernels/_build.py": _BUILD,
        "repro_torch/core/types.py": spec_mod,
    }
    assert lint_tree(tmp_path / "a", files, UncountedLaunchRule()).active \
        == []
    files["repro_torch/core/user.py"] = """\
        def eager(spec, masks, tomb):
            return spec.device_reduce(masks, tomb)
        """
    rep = lint_tree(tmp_path / "b", files, UncountedLaunchRule())
    assert [f.rule for f in rep.active] == ["uncounted-launch"]
    assert "Count.device_reduce" in rep.active[0].message


def test_uncounted_launch_scoped_to_kernels_and_core(tmp_path):
    # serve/ reaches the device only through counted ops and the engine;
    # the wrapper modules themselves are the device layer
    rep = lint_tree(tmp_path, {
        "repro_torch/kernels/ops.py": _OPS,
        "repro_torch/kernels/reducers.py": _REDUCERS + """\

    def fold_twice(masks, tomb):
        return fold_tombstones(fold_tombstones(masks, tomb), tomb)
    """,
        "repro_torch/kernels/_build.py": _BUILD,
        "repro_torch/serve/tool.py": """\
            from repro_torch.kernels import reducers

            def fold(masks, tomb):
                return reducers.fold_tombstones(masks, tomb)
            """,
    }, UncountedLaunchRule())
    assert rep.active == []


# -- rule 3: sentinel ---------------------------------------------------------

def test_sentinel_flags_f32_scale_literals_and_blind_inf_casts(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/models/bad_mask.py", """\
        import numpy as np
        import torch

        NEG = -3.0e38                         # rounds to -inf under bf16
        pad = torch.full((4,), -torch.inf)    # inf into an unknown dtype
        """, SentinelRule())
    rules = [f.rule for f in rep.active]
    assert rules == ["sentinel", "sentinel"]
    assert "bf16" in rep.active[0].message


def test_sentinel_accepts_numerics_and_explicit_wide_dtypes(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/models/good_mask.py", """\
        import numpy as np
        import torch
        from repro_torch import numerics

        NEG = numerics.mask_fill(torch.bfloat16)
        cost = np.full((4,), np.inf, np.float64)          # f64 inf is exact
        pad = torch.full((4,), float("inf"), dtype=torch.float32)
        """, SentinelRule())
    assert rep.active == []


# -- rule 4: lock-discipline --------------------------------------------------

def test_lock_discipline_flags_off_lock_write(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/bad_lock.py", """\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0              # __init__ is exempt

            def add(self):
                with self._lock:
                    self.count += 1

            def reset(self):
                self.count = 0              # off-lock write to guarded attr
        """, LockDisciplineRule())
    assert [f.rule for f in rep.active] == ["lock-discipline"]
    assert "Counter.count" in rep.active[0].message


def test_lock_discipline_accepts_guarded_writes(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/good_lock.py", """\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def add(self):
                with self._lock:
                    self.count += 1

            def reset(self):
                with self._lock:
                    self.count = 0
        """, LockDisciplineRule())
    assert rep.active == []


def test_lock_discipline_flags_state_mutation_and_off_lock_swap(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/bad_state.py", """\
        class Engine:
            def patch(self, cols):
                self._state.cols = cols     # in-place mutation

            def swap(self, new):
                self._state = new           # swap outside the ingest lock
        """, LockDisciplineRule())
    msgs = [f.message for f in rep.active]
    assert len(msgs) == 2
    assert any("in-place" in m for m in msgs)
    assert any("ingest lock" in m for m in msgs)


def test_lock_discipline_accepts_single_swap_under_ingest_lock(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/good_state.py", """\
        class Engine:
            def swap(self, new):
                with self._ingest_lock:
                    self._state = new
        """, LockDisciplineRule())
    assert rep.active == []


# -- rule 5: registry-hygiene -------------------------------------------------

def test_registry_hygiene_flags_non_frozen_and_mutable_default(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/bad_spec.py", """\
        from repro_torch.core.types import register_result_spec

        @register_result_spec
        class Sloppy:
            cache = []
        """, RegistryHygieneRule())
    msgs = [f.message for f in rep.active]
    assert len(msgs) == 2
    assert any("frozen dataclass" in m for m in msgs)
    assert any("mutable class-level default" in m for m in msgs)


def test_registry_hygiene_accepts_frozen_dataclass(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/core/good_spec.py", """\
        import dataclasses

        from repro_torch.core.types import register_result_spec

        @register_result_spec
        @dataclasses.dataclass(frozen=True)
        class Tidy:
            k: int = 4
            dims: tuple = ()
        """, RegistryHygieneRule())
    assert rep.active == []


# -- rule 6: thread-boundary --------------------------------------------------

def test_thread_boundary_flags_sync_and_parked_payloads(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/serve/bad_pipeline.py", """\
        from repro_torch.kernels import ops
        from repro_torch.serve.pipeline import device_stage

        class BadServer:
            @device_stage
            def flush(self):
                pb = self.engine.launch_batch(self._queries)
                host = ops.device_get(pb)       # sync on the wrong thread
                self._inflight = pb             # parked device value
                return host
        """, ThreadBoundaryRule())
    rules = [f.rule for f in rep.active]
    assert rules == ["thread-boundary", "thread-boundary"]
    assert "device_get" in rep.active[0].message
    assert "_inflight" in rep.active[1].message


def test_thread_boundary_taint_rides_wrappers(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/serve/bad_window.py", """\
        import torch
        from repro_torch.serve.pipeline import device_stage

        class BadServer:
            @device_stage
            def flush(self):
                pb = self.engine.launch_batch(self._queries)
                win = _Window(batch=pb, ready=torch.cuda.Event())
                self._last_window = win
        """, ThreadBoundaryRule())
    assert [f.rule for f in rep.active] == ["thread-boundary"]
    assert "_last_window" in rep.active[0].message


def test_thread_boundary_accepts_queue_handoff(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/serve/good_pipeline.py", """\
        from repro_torch.kernels import ops
        from repro_torch.serve.pipeline import device_stage, finalizer_stage

        class GoodServer:
            @device_stage
            def flush(self):
                pb = self.engine.launch_batch(self._queries)
                win = _Window(batch=pb, reason="size")
                self._backlog.put(win)          # the one sanctioned crossing
                self.stats.n_flushes = self.stats.n_flushes + 1  # host data

            @finalizer_stage
            def _finalize_loop(self):
                win = self._backlog.get()
                return win.batch.finalize()     # finalizer owns the sync
        """, ThreadBoundaryRule())
    assert rep.active == []


# -- suppressions, baseline, report, CLI -------------------------------------

def test_inline_suppression_moves_finding_out_of_active(tmp_path):
    rep = lint_one(tmp_path, "repro_torch/models/sup.py", """\
        NEG = -3.0e38  # mdrqlint: disable=sentinel
        POS = 3.0e38   # mdrqlint: disable=all
        """, SentinelRule())
    assert rep.active == []
    assert [f.rule for f in rep.suppressed] == ["sentinel", "sentinel"]
    assert rep.exit_code == 0


def test_multi_rule_suppression_comma_separated(tmp_path):
    path = tmp_path / "repro_torch" / "core" / "multi.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent("""\
        import numpy as np
        from repro_torch.kernels import ops

        def peek(x):
            return np.asarray(ops.range_scan(x)), -3.0e38  # mdrqlint: disable=host-sync,sentinel
        """))
    rep = engine.run([path], ALL_RULES)
    assert rep.active == []
    assert sorted({f.rule for f in rep.suppressed}) == ["host-sync",
                                                        "sentinel"]


def test_baseline_round_trip(tmp_path):
    path = tmp_path / "repro_torch" / "models" / "legacy.py"
    path.parent.mkdir(parents=True)
    path.write_text("OLD = -3.0e38\n")

    first = engine.run([path], [SentinelRule()])
    assert first.exit_code == 1 and len(first.active) == 1

    bl = tmp_path / "baseline.json"
    engine.write_baseline(first, bl)
    accepted = engine.load_baseline(bl)
    assert accepted == {first.active[0].baseline_key()}

    second = engine.run([path], [SentinelRule()], baseline=accepted)
    assert second.exit_code == 0
    assert second.active == [] and len(second.baselined) == 1

    # baseline keys carry no line numbers, so entries survive line drift
    path.write_text("# a new leading comment\nOLD = -3.0e38\n")
    third = engine.run([path], [SentinelRule()], baseline=accepted)
    assert third.exit_code == 0 and len(third.baselined) == 1


def test_shipped_baseline_is_empty():
    assert engine.load_baseline() == set()


def test_cli_baseline_flags_round_trip(tmp_path, capsys):
    path = tmp_path / "repro_torch" / "models" / "legacy.py"
    path.parent.mkdir(parents=True)
    path.write_text("OLD = -3.0e38\n")
    bl = tmp_path / "bl.json"

    assert lint_main([str(path), "--baseline", str(bl)]) == 1
    assert lint_main([str(path), "--baseline", str(bl),
                      "--write-baseline"]) == 0
    assert lint_main([str(path), "--baseline", str(bl)]) == 0
    out = capsys.readouterr().out
    assert "1 baselined" in out


def test_stale_baseline_fails_and_prune_drops_it(tmp_path, capsys):
    path = tmp_path / "repro_torch" / "models" / "legacy.py"
    path.parent.mkdir(parents=True)
    path.write_text("OLD = -3.0e38\n")
    bl = tmp_path / "bl.json"
    assert lint_main([str(path), "--baseline", str(bl),
                      "--write-baseline"]) == 0

    # debt paid: the finding is gone, but its waiver lingers -> exit 1
    path.write_text("OLD = 0.0\n")
    assert lint_main([str(path), "--baseline", str(bl)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out

    assert lint_main([str(path), "--baseline", str(bl),
                      "--prune-baseline"]) == 0
    assert engine.load_baseline(bl) == set()
    assert lint_main([str(path), "--baseline", str(bl)]) == 0


def test_report_format_and_json(tmp_path):
    path = tmp_path / "repro_torch" / "models" / "m.py"
    path.parent.mkdir(parents=True)
    path.write_text("NEG = -3.0e38\n")
    rep = engine.run([path], [SentinelRule()])
    line = rep.active[0].format()
    assert line.startswith(path.as_posix() + ":1 sentinel ")
    data = rep.to_json()
    assert data["n_files"] == 1
    assert data["findings"][0]["rule"] == "sentinel"


def test_parse_error_exits_2_not_1(tmp_path):
    """Broken tree != dirty tree: parse errors get their own exit code."""
    path = tmp_path / "repro_torch" / "core" / "broken.py"
    path.parent.mkdir(parents=True)
    path.write_text("def oops(:\n")
    rep = engine.run([path], ALL_RULES)
    assert rep.exit_code == 2
    assert rep.active == []
    assert rep.errors[0].rule == "parse-error"


def test_cli_exit_codes(tmp_path, capsys):
    pkg = tmp_path / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    clean = pkg / "clean.py"
    clean.write_text("X = 1\n")
    assert lint_main([str(clean)]) == 0
    dirty = pkg / "dirty.py"
    dirty.write_text("NEG = -3.0e38\n")
    assert lint_main([str(dirty)]) == 1
    broken = pkg / "broken.py"
    broken.write_text("def oops(:\n")
    assert lint_main([str(broken)]) == 2
    out_json = tmp_path / "report.json"
    assert lint_main([str(dirty), "--json", str(out_json)]) == 1
    assert json.loads(out_json.read_text())["findings"][0]["rule"] \
        == "sentinel"
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(r.rule_id in out for r in ALL_RULES)
    with pytest.raises(SystemExit) as e:
        lint_main(["--no-such-flag"])
    assert e.value.code == 2


# -- the port's tree lints clean ----------------------------------------------

def test_port_tree_is_clean():
    """``python -m repro_torch.analysis src/repro_torch`` carries no active
    finding under the checked-in (empty) baseline; its suppressions each
    carry a reason on the lines above them."""
    port = REPO / "src" / "repro_torch"
    assert lint_main([str(port)]) == 0
    rep = engine.run([port], ALL_RULES, baseline=engine.load_baseline())
    assert rep.active == [] and rep.baselined == [] and rep.errors == []
    for f in rep.suppressed:
        lines = Path(f.file).read_text().splitlines()
        above = lines[f.line - 2].strip()
        assert above.startswith("#"), f.format()


def test_all_rules_have_ids_and_docs():
    ids = [r.rule_id for r in ALL_RULES]
    assert ids == ["host-sync", "uncounted-launch", "raw-shard-map",
                   "sentinel", "lock-discipline", "registry-hygiene",
                   "thread-boundary", "kernel-tile", "kernel-dtype",
                   "note-trace"]
    assert all(r.doc for r in ALL_RULES)


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
