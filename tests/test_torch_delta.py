"""The port's mutable data plane against the reference's, on the CPU.

``repro_torch`` (plain PyTorch versions of the kernels on CPU tensors)
against ``repro`` (Pallas kernels in interpret mode), both engines holding
the reference's four structures plus the row-major scan, on the same GMRQB
and SYNT-UNI data (n=8192, tile_n=512), the same appended rows and the same
tombstones. Each case of the reference's delta tests, held as parity:

  * every path x every result spec under a delta of appended rows plus base
    and delta tombstones, the planner route and singles — and the
    tombstones-only corner (no delta rows);
  * budgets: a live delta changes no bucket's launches or host syncs;
  * ``memory_report``'s delta entry; compaction's id map and version; ingest
    that races a compaction build; a stale commit refused; a path that is
    not delta-aware raising; the planner's delta cost axis; counts that stay
    valid across concurrent swaps; the server's ingest ordering.

Tolerances: ids, counts, masks, top-k (tie order included) and min/max
exactly equal; sums to rtol=1e-5 (float32 sums taken in a different order).
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import Compactor as JCompactor
from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.core.planner import CostModel as JCost
from repro.core.planner import Histograms as JHist
from repro.core.planner import Planner as JPlanner
from repro.kernels import ops as jops
from repro.serve import MDRQServer as JServer
from repro_torch import obs
from repro_torch.core import (Agg, Compactor, Count, CostModel, Dataset,
                              Histograms, Ids, Mask, MDRQEngine, Planner,
                              QueryBatch, RangeQuery, TopK)
from repro_torch.core import types as T
from repro_torch.core.paths import PerQueryPath
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import ops
from repro_torch.serve import MDRQServer

TILE_N = 512
N = 8192
SUM_RTOL = 1e-5
SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=4),
         TopK(k=7, dim=2, largest=False), Agg("sum", 3), Agg("min", 2),
         Agg("max", 0)]
ALL_PATHS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile", "rowscan")


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    ops.reset_kernel_launches()
    obs.registry().reset()
    yield


def _jspec(spec):
    return getattr(JT, type(spec).__name__)(
        **{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})


def _jq(q):
    return JT.RangeQuery(q.lower, q.upper)


def _assert_same(spec, got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        elif spec.kind == "agg" and spec.op == "sum":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
        elif spec.kind == "agg":
            assert (np.isnan(g) and np.isnan(w)) or g == w
        else:
            assert g == w


def _queries(ds, which, n_q, seed):
    """The workload's boxes, plus an empty-result and a match-all query."""
    m = ds.m
    if which == "gmrqb":
        out = [q for _, q in gmrqb.mixed_workload(ds, n_q, seed=seed)]
    else:
        rng = np.random.default_rng(seed)
        out = []
        for k in range(n_q):
            a = ds.cols[:, rng.integers(ds.n)]
            b = ds.cols[:, rng.integers(ds.n)]
            lo, up = np.minimum(a, b), np.maximum(a, b)
            if k % 2:
                dims = rng.choice(m, size=int(rng.integers(1, m)),
                                  replace=False)
                out.append(RangeQuery.partial(
                    m, {int(d): (float(lo[d]), float(up[d])) for d in dims}))
            else:
                out.append(RangeQuery.complete(lo, up))
    top = float(ds.cols[0].max())
    out.append(RangeQuery.partial(m, {0: (top + 1.0, top + 2.0)}))  # empty
    out.append(RangeQuery.partial(m, {}))                             # all
    return out


def _fresh_rows(which, k, seed):
    """k new rows from the dataset's own generator (another seed)."""
    if which == "gmrqb":
        return gmrqb.build(k, seed=seed).rows()
    return synthetic.synt_uni(k, 5, seed=seed).rows()


class _Oracle:
    """Numpy ground truth over the combined (base + delta - tombstones)
    rows, for the specs whose answer has no tie order."""

    def __init__(self, cols, extra_rows, dead_ids):
        self.cols = (np.concatenate([cols, extra_rows.T.astype(np.float32)],
                                    axis=1)
                     if extra_rows is not None and len(extra_rows) else cols)
        self.alive = np.ones((self.cols.shape[1],), bool)
        self.alive[np.asarray(dead_ids, np.int64)] = False

    def ids(self, q):
        return np.nonzero(T.match_mask_np(self.cols, q) & self.alive)[0] \
            .astype(np.int64)

    def check(self, spec, q, res):
        ids = self.ids(q)
        if spec.kind == "ids":
            np.testing.assert_array_equal(res, ids)
        elif spec.kind == "count":
            assert res == ids.size
        elif spec.kind == "mask":
            np.testing.assert_array_equal(np.nonzero(res)[0], ids)
        elif spec.kind == "agg" and ids.size == 0:
            assert res == 0.0 if spec.op == "sum" else np.isnan(res)
        elif spec.kind == "agg":
            vals = self.cols[spec.dim, ids]
            want = {"min": np.min, "max": np.max,
                    "sum": lambda v: np.sum(v, dtype=np.float64)}[spec.op](vals)
            np.testing.assert_allclose(res, want, rtol=1e-4)


@pytest.fixture(scope="module", params=["gmrqb", "synt_uni"])
def delta_engines(request):
    """(port, reference, oracle, queries): all paths over a ~1% delta of
    fresh rows, with base and delta tombstones, applied alike to both."""
    which = request.param
    ds = (gmrqb.build(N, seed=0) if which == "gmrqb"
          else synthetic.synt_uni(N, 5, seed=3))
    port = MDRQEngine(ds, tile_n=TILE_N, rowscan=True, device="cpu")
    ref = JEngine(JT.Dataset(ds.cols), tile_n=TILE_N, rowscan=True)
    extra = _fresh_rows(which, 82, seed=1)
    new_ids = port.append(extra)
    np.testing.assert_array_equal(new_ids, ref.append(extra))
    rng = np.random.default_rng(77)
    dead = np.concatenate([rng.choice(N, 60, replace=False),
                           rng.choice(new_ids, 10, replace=False)])
    assert port.delete(dead) == ref.delete(dead) == dead.size
    return (port, ref, _Oracle(ds.cols, extra, dead),
            _queries(ds, which, 12, seed=5))


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("method", ALL_PATHS)
def test_delta_paths_match_reference(delta_engines, method, spec):
    """query_batch over (base + delta - tombstones): the reference's
    results and counters on every path, and the numpy oracle."""
    port, ref, oracle, queries = delta_engines
    jops.reset_counters()
    want = ref.query_batch([_jq(q) for q in queries], method=method,
                           spec=_jspec(spec))
    want_counts = jops.counters()
    got = port.query_batch(queries, method=method, spec=spec)
    _assert_same(spec, got, want)
    assert ops.counters() == want_counts
    for q, res in zip(queries, got):
        oracle.check(spec, q, res)


def test_delta_auto_and_singles_match_reference(delta_engines):
    """The planner route (with the delta's cost axis) and singles, which
    ride the delta-aware batch rung at Q=1."""
    port, ref, oracle, queries = delta_engines
    for spec in (Ids(), Count(), TopK(k=5, dim=0), Agg("sum", 1)):
        jops.reset_counters()
        ops.reset_counters()
        want = ref.query_batch([_jq(q) for q in queries], spec=_jspec(spec))
        want_counts = jops.counters()
        got = port.query_batch(queries, spec=spec)
        assert port.last_batch_stats.methods == ref.last_batch_stats.methods
        _assert_same(spec, got, want)
        assert ops.counters() == want_counts
        for q in queries[:3] + queries[-2:]:
            for method in ("auto", "scan", "kdtree", "rowscan"):
                got1 = port.query(q, method=method, spec=spec)
                _assert_same(spec, [got1],
                             [ref.query(_jq(q), method=method,
                                        spec=_jspec(spec))])
                oracle.check(spec, q, got1)


@pytest.mark.parametrize("which", ["gmrqb", "synt_uni"])
def test_tombstones_only_delta(which):
    """Deletes with no appends still fold on the device — at the frozen
    paths' budget (there is no delta block to scan)."""
    ds = (gmrqb.build(N, seed=2) if which == "gmrqb"
          else synthetic.synt_uni(N, 5, seed=2))
    port = MDRQEngine(ds, structures=("scan", "kdtree"), tile_n=TILE_N,
                      device="cpu")
    ref = JEngine(JT.Dataset(ds.cols), structures=("scan", "kdtree"),
                  tile_n=TILE_N)
    dead = np.random.default_rng(21).choice(N, 300, replace=False)
    port.delete(dead)
    ref.delete(dead)
    assert port.delta.d == 0 and not port.delta.snapshot().is_empty
    oracle = _Oracle(ds.cols, None, dead)
    queries = _queries(ds, which, 8, seed=6)
    for method in ("scan", "kdtree"):
        for spec in (Ids(), Count(), Agg("sum", 1), TopK(k=4, dim=2)):
            jops.reset_counters()
            ops.reset_counters()
            want = ref.query_batch([_jq(q) for q in queries], method=method,
                                   spec=_jspec(spec))
            want_counts = jops.counters()
            got = port.query_batch(queries, method=method, spec=spec)
            _assert_same(spec, got, want)
            assert ops.counters() == want_counts
            for q, res in zip(queries, got):
                oracle.check(spec, q, res)
    ops.reset_counters()
    port.query_batch(queries, method="scan", spec=Count())
    assert ops.counters() == {"multi_scan_reduce": 1, "host_sync": 1}


# -- launch / host-sync budgets under a live delta ----------------------------

@pytest.mark.parametrize("spec", [Count(), TopK(k=4, dim=2), Agg("sum", 1)],
                         ids=lambda s: s.kind)
def test_reduced_specs_budget_unchanged_with_delta(spec, delta_engines):
    """The delta block scans inside the same counted op and its payload
    rides the same host sync: every bucket keeps its frozen budget."""
    port, ref, _, queries = delta_engines
    budgets = {
        "scan": {"multi_scan_reduce": 1, "host_sync": 1},
        "scan_vertical": {"multi_scan_vertical_reduce": 1, "host_sync": 1},
        "kdtree": {"prune_hierarchy_batch": 1, "multi_visit_reduce": 1,
                   "host_sync": 2},
        "vafile": {"multi_va_filter": 1, "multi_visit_reduce": 1,
                   "host_sync": 2},
    }
    for method, budget in budgets.items():
        ops.reset_counters()
        jops.reset_counters()
        port.query_batch(queries, method=method, spec=spec)
        ref.query_batch([_jq(q) for q in queries], method=method,
                        spec=_jspec(spec))
        assert ops.counters() == budget == jops.counters()


def test_empty_visit_list_under_a_delta_pays_one_delta_launch(delta_engines):
    """Nothing prunes through, but the delta must still be scanned: one
    delta-only scan op and its sync, as in the reference."""
    port, ref, _, _ = delta_engines
    cols = port.dataset.cols
    q = RangeQuery.complete(cols.max(axis=1) + 1.0, cols.min(axis=1) - 1.0)
    for method in ("kdtree", "vafile"):
        for spec in (Ids(), Count(), Agg("min", 1)):
            ops.reset_counters()
            jops.reset_counters()
            got = port.query_batch([q] * 3, method=method, spec=spec)
            want = ref.query_batch([_jq(q)] * 3, method=method,
                                   spec=_jspec(spec))
            _assert_same(spec, got, want)
            assert ops.counters() == jops.counters()
            assert ops.counter("multi_scan_reduce") == 1


def test_memory_report_includes_delta(delta_engines):
    port, ref, _, _ = delta_engines
    rep, jrep = port.memory_report(), ref.memory_report()
    assert rep["delta"] == port.delta.nbytes == jrep["delta"]
    assert rep["data"] == jrep["data"]
    # segment rows + delta tombstones + the base tombstone vector
    assert rep["delta"] >= 82 * port.dataset.m * 4 + port.dataset.n
    assert set(rep) == set(jrep)


def test_delta_view_caches_per_version_and_device(delta_engines):
    """Batches at one version share one view and its device tensors; the
    cache keys carry the device."""
    port, _, _, _ = delta_engines
    view = port.delta.snapshot()
    assert port.delta.snapshot() is view
    cm = view.device_cm(TILE_N, "cpu")
    assert view.device_cm(TILE_N, "cpu") is cm
    assert cm.shape == (24 if port.dataset.m == 19 else 8, TILE_N)
    # tombstoned delta rows are poisoned: +inf never matches
    assert bool(np.isinf(cm[:port.dataset.m, :view.d].numpy()[
        :, view.delta_tomb]).all())
    tomb = view.base_tomb_dev(port.columnar.data_dev.shape[1], "cpu")
    assert int(tomb.sum()) == int(view.base_tomb.sum())
    assert all(k[-1] == "cpu" for k in view._tomb_cache)


# -- compaction ---------------------------------------------------------------

def _tiny_pair(seed, m=3, n=1024, structures=("scan", "kdtree")):
    rng = np.random.default_rng(seed)
    cols = rng.random((m, n), dtype=np.float32)
    port = MDRQEngine(Dataset(cols), structures=structures, tile_n=256,
                      device="cpu")
    ref = JEngine(JT.Dataset(cols), structures=structures, tile_n=256)
    return port, ref, rng


def test_compact_matches_reference():
    """compact() on both: the same id map, version and rebuilt dataset, and
    every path answers alike afterwards."""
    port, ref, rng = _tiny_pair(11)
    m, n = port.dataset.m, port.dataset.n
    extra = rng.random((50, m)).astype(np.float32)
    new_ids = port.append(extra)
    ref.append(extra)
    dead = np.concatenate([rng.choice(n, 30, replace=False), new_ids[:5]])
    port.delete(dead)
    ref.delete(dead)
    queries = _queries(port.dataset, "synt", 6, seed=3)
    before = port.query_batch(queries, method="scan")
    id_map = port.compact()
    np.testing.assert_array_equal(id_map, ref.compact())
    assert port.version == ref.version == 1
    assert port.delta.d == 0 and port.delta.n_total == port.dataset.n
    np.testing.assert_array_equal(port.dataset.cols, ref.dataset.cols)
    np.testing.assert_array_equal(np.nonzero(id_map < 0)[0], np.sort(dead))
    for method in ("scan", "kdtree"):
        for spec in (Ids(), TopK(k=3, dim=1), Agg("sum", 0)):
            _assert_same(spec, port.query_batch(queries, method=method,
                                                spec=spec),
                         ref.query_batch([_jq(q) for q in queries],
                                         method=method, spec=_jspec(spec)))
        for res_b, res_a in zip(before, port.query_batch(queries,
                                                         method=method)):
            np.testing.assert_array_equal(res_a, np.sort(id_map[res_b]))


def test_compactor_folds_ingest_during_build():
    """Writes between build() and commit() survive the swap in both
    packages alike: late appends re-seed the new delta, late deletes fold
    through the id map."""
    port, ref, rng = _tiny_pair(12, structures=("scan",))
    m = port.dataset.m
    rows0 = rng.random((20, m)).astype(np.float32)
    rows1 = rng.random((10, m)).astype(np.float32)
    maps = []
    for eng, comp_cls in ((port, Compactor), (ref, JCompactor)):
        ids0 = eng.append(rows0)
        eng.delete([0, 1, int(ids0[0])])
        comp = comp_cls(eng)
        comp.build()
        ids1 = eng.append(rows1)
        eng.delete([5, int(ids0[1]), int(ids1[0])])
        maps.append(comp.commit())
    np.testing.assert_array_equal(maps[0], maps[1])
    assert port.version == ref.version == 1
    assert port.delta.d == ref.delta.d == 10
    assert port.dataset.n == ref.dataset.n == 1024 + 20 - 3
    queries = _queries(port.dataset, "synt", 6, seed=4)
    for spec in (Ids(), Count(), Mask()):
        _assert_same(spec, port.query_batch(queries, method="scan", spec=spec),
                     ref.query_batch([_jq(q) for q in queries], method="scan",
                                     spec=_jspec(spec)))


def test_compaction_frees_the_old_version():
    """Nothing reaches a replaced version once the swap is done: its device
    tensors go at the swap, not when the cycle collector next runs (both
    versions are on the card during a build; three would not fit at
    scale)."""
    import gc
    import weakref
    port, _, rng = _tiny_pair(17)
    old = weakref.ref(port._state)
    port.append(rng.random((5, port.dataset.m)).astype(np.float32))
    port.query_batch([RangeQuery.partial(port.dataset.m, {})], method="scan")
    gc.disable()
    try:
        port.compact()
        assert old() is None
    finally:
        gc.enable()


def test_compact_rejects_stale_commit():
    port, _, rng = _tiny_pair(13, structures=("scan",))
    port.append(rng.random((4, port.dataset.m)).astype(np.float32))
    c1, c2 = Compactor(port), Compactor(port)
    c1.build(), c2.build()
    c1.commit()
    with pytest.raises(RuntimeError, match="changed during compaction"):
        c2.commit()
    with pytest.raises(RuntimeError, match="before build"):
        Compactor(port).commit()


def test_non_delta_aware_path_raises_until_compact():
    port, _, rng = _tiny_pair(14, structures=("scan",))

    class Frozen:
        nbytes_index = 0

        def query(self, q):
            return np.empty((0,), np.int64)

        def count(self, q):
            return 0

    class FrozenPath(PerQueryPath):
        def query_batch(self, batch, spec=Ids()):  # no delta parameter
            return super().query_batch(batch, spec=spec)

    port.register_path(FrozenPath("frozen", Frozen()))
    q = RangeQuery.partial(port.dataset.m, {})
    port.query_batch([q], method="frozen")  # empty delta: fine
    port.append(rng.random((2, port.dataset.m)).astype(np.float32))
    with pytest.raises(ValueError, match="not delta-aware"):
        port.query_batch([q], method="frozen")
    with pytest.raises(ValueError, match="compact"):
        port.launch_batch([q], method="frozen")
    port.compact()   # the registry is rebuilt: re-register to serve again
    assert "frozen" not in port.paths


# -- planning -----------------------------------------------------------------

def test_plan_batch_flips_index_pick_as_delta_grows():
    """A minority kd-tree bucket amortizes the delta scan over few queries;
    as delta_n grows both planners move it to the scan bucket alike."""
    ds = synthetic.synt_uni(20_000, 5, seed=42)
    port = Planner(Histograms.build(ds), CostModel(n=4_000_000, m=5),
                   available=("scan", "kdtree"))
    ref = JPlanner(JHist.build(JT.Dataset(ds.cols)),
                   JCost(n=4_000_000, m=5), available=("scan", "kdtree"))
    lo = np.full((5,), 0.4, np.float32)
    tiny = [RangeQuery.complete(lo, lo + 2e-4) for _ in range(8)]
    broad = [RangeQuery.complete(np.zeros(5, np.float32),
                                 np.full(5, 0.9, np.float32))
             for _ in range(24)]
    batch = QueryBatch.from_queries(tiny + broad)
    jbatch = JT.QueryBatch.from_queries([_jq(q) for q in tiny + broad])
    plans = []
    for delta_n in (0, 2_000_000):
        port.model.delta_n = ref.model.delta_n = delta_n
        got = port.plan_batch(batch, spec=Count())
        want = ref.plan_batch(jbatch, spec=JT.Count())
        assert got.methods == want.methods
        np.testing.assert_array_equal(got.costs, want.costs)
        plans.append(got.methods)
    assert plans[0][:8] == ["kdtree"] * 8 and set(plans[0][8:]) == {"scan"}
    assert plans[1] == ["scan"] * 32


def test_engine_refreshes_delta_cost_axis():
    port, ref, rng = _tiny_pair(15, structures=("scan",))
    q = RangeQuery.partial(port.dataset.m, {0: (0.1, 0.2)})
    port.query_batch([q], method="scan")
    assert port.planner.model.delta_n == 0
    rows = rng.random((64, port.dataset.m)).astype(np.float32)
    port.append(rows)
    ref.append(rows)
    port.query_batch([q], method="scan")
    ref.query_batch([_jq(q)], method="scan")
    assert port.planner.model.delta_n == ref.planner.model.delta_n == 64
    port.delete([0])
    port.query(q, method="scan")
    assert port.planner.model.delta_n == 64


# -- atomicity under concurrent serving ----------------------------------------

def test_compact_swap_atomic_under_concurrent_counts():
    """Match-all counts in another thread during append/delete/compact only
    ever observe valid totals: a torn swap (a new base without its delta, a
    delta counted twice, half-applied tombstones) would show as an off-set
    count."""
    port, _, rng = _tiny_pair(16, n=2048)
    n = port.dataset.n
    q = RangeQuery.partial(port.dataset.m, {})
    valid = {n}
    observed, errors = [], []
    stop = threading.Event()

    def prober():
        try:
            while not stop.is_set():
                observed.append(
                    port.query_batch([q], method="scan", spec=Count())[0])
        except Exception as exc:  # pragma: no cover - surfaced by the assert
            errors.append(exc)

    th = threading.Thread(target=prober)
    th.start()
    live = n
    try:
        for _ in range(3):
            ids = port.append(rng.random((32, port.dataset.m))
                              .astype(np.float32))
            live += 32
            valid.add(live)
            port.delete(ids[:8])
            live -= 8
            valid.add(live)
            port.compact()
    finally:
        stop.set()
        th.join(timeout=60)
    assert not errors, errors
    assert observed and set(observed) <= valid, \
        (sorted(set(observed) - valid), sorted(valid))
    assert port.version == 3
    assert port.query_batch([q], method="scan", spec=Count())[0] == live


# -- the server's ingest plane -------------------------------------------------

def test_server_ingest_matches_reference():
    """Queries submitted before a write never see it, those after always
    do; ingest flushes the window first and is logged — in both packages."""
    rows = synthetic.synt_uni(40, 3, seed=9).rows()
    outs = []
    for Engine, Server, reg, qtype, spec in (
            (lambda c: MDRQEngine(Dataset(c), structures=("scan",),
                                  tile_n=256, device="cpu"),
             MDRQServer, obs.registry, RangeQuery, Count()),
            (lambda c: JEngine(JT.Dataset(c), structures=("scan",),
                               tile_n=256),
             JServer, jobs.registry, JT.RangeQuery, JT.Count())):
        cols = synthetic.synt_uni(1024, 3, seed=8).cols
        srv = Server(Engine(cols), max_batch=64, spec=spec)
        q = qtype(np.zeros(3, np.float32), np.ones(3, np.float32))
        t0 = srv.submit(q)
        ids = srv.append(rows)
        t1 = srv.submit(q)
        deleted = srv.delete(np.concatenate([ids[:5], np.arange(7)]))
        t2 = srv.submit(q)
        id_map = srv.compact()
        t3 = srv.submit(q)
        ingest = [e for e in srv.query_log.by_reason("ingest")
                  if e.spec_kind == "ingest"]
        outs.append((
            [t.result() for t in (t0, t1, t2, t3)], ids.tolist(), deleted,
            id_map.tolist(), dict(srv.stats.flush_reasons),
            dict(srv.stats.ingest_counts), sorted(e.method for e in ingest),
            all(np.isnan(e.lower).all() for e in ingest),
            reg().family_total("mdrq_ingest_total")))
    assert outs[0] == outs[1]
    results = outs[0][0]
    assert results == [1024, 1064, 1052, 1052]
    assert outs[0][4]["ingest"] == 3
    assert outs[0][5] == {"append": 1, "delete": 1, "compact": 1}
    assert outs[0][7] and outs[0][8] == 3
