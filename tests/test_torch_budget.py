"""BUDGET_torch.json: the port's static launch/sync certificate against (a)
a fresh derivation from the source, (b) the reference's ``BUDGET.json``,
and (c) the port's runtime ``mdrq_launches_total`` counters.

``repro_torch.analysis.budget`` derives the numbers by abstract
interpretation over the port's call graph (stdlib ast); this file holds
them equal to the reference's certificate leaf for leaf — the port keeps
the reference's budget — and re-asserts them against what the port's
engine does on the CPU: every certified path, frozen and under a live
delta, under ``Ids()`` and ``Count()``, through the synchronous
``query_batch`` and the split ``launch_batch``/``finalize`` protocol. A
copy of the port with one extra ``ops.device_get`` makes ``check`` name the
leaf it moved. Mirrors ``tests/test_budget.py``.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import budget as ref_budget
from repro.analysis.engine import build_project as ref_build_project
from repro.analysis.engine import iter_py_files as ref_iter_py_files
from repro_torch.analysis import budget
from repro_torch.analysis.engine import build_project, iter_py_files
from repro_torch.core import Count, Dataset, Ids, MDRQEngine, RangeQuery
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
CERT_PATH = REPO / "BUDGET_torch.json"
REF_CERT_PATH = REPO / "BUDGET.json"
PORT = REPO / "src" / "repro_torch"

SPECS = (Ids(), Count())


@pytest.fixture(scope="module")
def cert():
    return json.loads(CERT_PATH.read_text())


def _graph(root: Path):
    project, errors = build_project(iter_py_files([root]))
    assert errors == []
    return project.graph


@pytest.fixture(scope="module")
def graph():
    return _graph(PORT)


def _without_comment(c: dict) -> dict:
    return {k: v for k, v in c.items() if k != "_comment"}


# -- the certificate is fresh, the reference's, and consistent ---------------

def test_checked_in_certificate_matches_source(graph):
    """``--budget BUDGET_torch.json`` would be a no-op: re-deriving the
    certificate from the current source gives the checked-in file."""
    assert budget.check(graph, CERT_PATH) == []
    assert CERT_PATH.read_text() == budget.render(budget.certify(graph))


def test_certificate_equals_the_reference_budget(cert):
    """Every leaf of ``paths``, ``engine`` and ``serve`` (and the unit)
    equals ``BUDGET.json``'s: the port keeps the reference's budget."""
    ref = json.loads(REF_CERT_PATH.read_text())
    assert _without_comment(cert) == _without_comment(ref)
    assert budget.diff_certificate(_without_comment(ref),
                                   _without_comment(cert)) == []


def test_port_derivation_equals_the_reference_derivation(graph):
    """The two certifiers, each over its own package, derive the same
    budget (a fresh derivation on both sides, not the checked-in files)."""
    project, errors = ref_build_project(
        ref_iter_py_files([REPO / "src" / "repro"]))
    assert errors == []
    assert _without_comment(budget.certify(graph)) == _without_comment(
        ref_budget.certify(project.graph))


def test_certificate_covers_every_registered_path(cert):
    """Every plannable fused path the port's engine builds is certified;
    the sharded scan is not, as in the reference."""
    assert set(cert["paths"]) == {"scan", "scan_vertical", "kdtree",
                                  "rstar", "vafile"}
    for name, ctx in cert["paths"].items():
        assert set(ctx) == {"frozen", "delta"}, name
    eng = MDRQEngine(Dataset(np.random.default_rng(3).random(
        (3, 2048), dtype=np.float32)), tile_n=512, device="cpu")
    assert {n for n, p in eng.paths.items() if p.plannable} \
        == set(cert["paths"])


def test_certificate_internal_consistency(cert):
    """finalize = total - device_stage, launches all happen in the device
    stage, and the engine/serve layers add zero cost of their own."""
    for name, ctx in cert["paths"].items():
        for key in ("frozen", "delta"):
            e = ctx[key]
            assert e["finalize_host_syncs"] == (
                e["total"]["host_syncs"]
                - e["device_stage"]["host_syncs"]), (name, key)
            assert e["total"]["launches"] == e["device_stage"]["launches"], \
                (name, key)
            assert e["finalize_host_syncs"] >= 1, (name, key)
    zero = {"host_syncs": 0, "launches": {}}
    assert cert["engine"]["MDRQEngine.launch_batch"] == zero
    assert cert["engine"]["MDRQEngine.query_batch"] == zero
    assert cert["engine"]["PendingBatch.finalize"]["per_bucket"] == \
        {"host_syncs": 1, "launches": {}}
    assert cert["serve"]["PipelinedMDRQServer.flush"] == zero
    assert cert["serve"]["PipelinedMDRQServer._finalize_loop"] == zero


# -- the certificate matches the runtime counters ------------------------------

def _mixed_queries(cols, rng, n_q=6):
    m = cols.shape[0]
    out = []
    for k in range(n_q):
        if k % 2 == 0:
            a = cols[:, rng.integers(cols.shape[1])]
            b = cols[:, rng.integers(cols.shape[1])]
            out.append(RangeQuery.complete(np.minimum(a, b),
                                           np.maximum(a, b)))
        else:
            dims = rng.choice(m, size=int(rng.integers(1, m + 1)),
                              replace=False)
            preds = {int(d): tuple(sorted(rng.random(2).tolist()))
                     for d in dims}
            out.append(RangeQuery.partial(m, preds))
    return out


@pytest.fixture(scope="module")
def data():
    return Dataset(np.random.default_rng(42).random((5, 9000),
                                                    dtype=np.float32))


@pytest.fixture(scope="module")
def eng_frozen(data):
    return MDRQEngine(data, tile_n=512, device="cpu")


@pytest.fixture(scope="module")
def eng_delta(data):
    eng = MDRQEngine(data, tile_n=512, device="cpu")
    rng = np.random.default_rng(177)
    new_ids = eng.append(rng.random((200, data.m)).astype(np.float32))
    eng.delete(np.concatenate([rng.choice(data.n, 120, replace=False),
                               new_ids[:10]]))
    return eng


def _expected(entry) -> dict:
    """Certificate entry -> the exact ``ops.counters()`` dict (nonzero only,
    host syncs under the ``host_sync`` pseudo-op of the same family)."""
    exp = dict(entry["launches"])
    if entry["host_syncs"]:
        exp["host_sync"] = entry["host_syncs"]
    return exp


@pytest.mark.parametrize("context", ["frozen", "delta"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.kind)
def test_query_batch_counters_equal_certificate(cert, eng_frozen, eng_delta,
                                                data, context, spec):
    """Warm path x spec x frozen/delta: one synchronous ``query_batch``
    bumps exactly the certified mdrq_launches_total deltas."""
    eng = eng_frozen if context == "frozen" else eng_delta
    queries = _mixed_queries(data.cols, np.random.default_rng(7))
    for name, ctx in cert["paths"].items():
        eng.query_batch(queries, method=name, spec=spec)  # warm
        ops.reset_counters()
        eng.query_batch(queries, method=name, spec=spec)
        assert ops.counters() == _expected(ctx[context]["total"]), \
            (name, context, spec.kind)


@pytest.mark.parametrize("context", ["frozen", "delta"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.kind)
def test_split_protocol_stage_split_equals_certificate(cert, eng_frozen,
                                                       eng_delta, data,
                                                       context, spec):
    """``launch_batch`` spends exactly the certified device-stage budget;
    ``finalize`` adds exactly the certified finalize syncs (one bucket)."""
    eng = eng_frozen if context == "frozen" else eng_delta
    queries = _mixed_queries(data.cols, np.random.default_rng(19))
    for name, ctx in cert["paths"].items():
        e = ctx[context]
        want = eng.query_batch(queries, method=name, spec=spec)  # warm
        ops.reset_counters()
        pending = eng.launch_batch(queries, method=name, spec=spec)
        assert ops.counters() == _expected(e["device_stage"]), \
            (name, context, "device stage")
        got = pending.finalize()
        assert ops.counters() == _expected(e["total"]), \
            (name, context, "after finalize")
        assert ops.counter("host_sync") - e["device_stage"]["host_syncs"] \
            == e["finalize_host_syncs"], (name, context)
        if spec.kind == "ids":
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        else:
            assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8, bool])
def test_upload_on_a_cpu_target_is_as_tensor(dtype):
    """The upload helper follows the target device: on the CPU it is
    ``torch.as_tensor`` (the card's pinned, non-blocking copy is held by
    the card tests)."""
    import torch
    a = (np.random.default_rng(1).random((8, 33)) * 100).astype(dtype)
    for x in (a, a[:, ::3]):
        t = ops.upload(x, "cpu")
        want = torch.as_tensor(x)
        assert t.device.type == "cpu" and t.dtype == want.dtype
        assert torch.equal(t, want)


# -- drift is detected ---------------------------------------------------------

def test_certificate_drift_is_detected(graph, tmp_path):
    """A tampered certificate fails ``budget.check`` with a leaf-level diff
    naming the changed key."""
    cert = budget.certify(graph)
    cert["paths"]["scan"]["frozen"]["total"]["host_syncs"] += 1
    stale = tmp_path / "BUDGET_torch.json"
    stale.write_text(budget.render(cert))
    drift = budget.check(graph, stale)
    assert len(drift) == 1
    assert "paths.scan.frozen.total.host_syncs" in drift[0]


def test_extra_device_get_in_a_port_module_is_detected(tmp_path):
    """A copy of the port whose ``ColumnarScan.launch_batch`` syncs once
    more: ``check`` against the checked-in certificate names the moved
    leaves of both scan paths, and nothing else."""
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    scan = copy / "core" / "scan.py"
    src = scan.read_text()
    anchor = "        dcm = tomb = None\n"
    assert src.count(anchor) == 1
    scan.write_text(src.replace(anchor,
                                "        ops.device_get(lo)\n" + anchor))
    drift = budget.check(_graph(copy), CERT_PATH)
    moved = {line.split(":")[0] for line in drift}
    assert moved == {
        f"paths.{p}.{c}.{leaf}"
        for p in ("scan", "scan_vertical") for c in ("frozen", "delta")
        for leaf in ("device_stage.host_syncs", "total.host_syncs")}
    assert "paths.scan.frozen.device_stage.host_syncs: 0 -> 1" in drift


def test_cli_budget_check_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main as lint_main
    assert lint_main([str(PORT), "--budget-check", str(CERT_PATH)]) == 0
    stale = tmp_path / "stale.json"
    cert = json.loads(CERT_PATH.read_text())
    cert["serve"]["PipelinedMDRQServer.flush"]["host_syncs"] = 1
    stale.write_text(json.dumps(cert))
    assert lint_main([str(PORT), "--budget-check", str(stale)]) == 1
    assert "PipelinedMDRQServer.flush.host_syncs" in capsys.readouterr().out
    out = tmp_path / "fresh.json"
    assert lint_main([str(PORT), "--budget", str(out)]) == 0
    assert out.read_text() == CERT_PATH.read_text()


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q"]))
