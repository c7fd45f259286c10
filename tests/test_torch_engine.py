"""The port's engine against the reference engine, on the CPU.

``repro_torch.core.MDRQEngine(..., device="cpu")`` (plain PyTorch versions of
the kernels) against ``repro.core.MDRQEngine(structures=("scan",))`` (Pallas
kernels in interpret mode) on the same GMRQB and SYNT-UNI data and queries:
results exactly equal — ids, counts, masks, top-k with its tie order — and
aggregates equal (min/max exactly, sums to rtol=1e-5, float32 sums taken in a
different order); the same plans; the same launches and host syncs per
bucket.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.data import gmrqb as jgmrqb
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.serve import MDRQServer as JServer
from repro_torch import obs
from repro_torch.core import (Agg, Count, Ids, Mask, MDRQEngine, QueryBatch,
                              RangeQuery, TopK)
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import ops
from repro_torch.serve import MDRQServer

TILE_N = 512
N = 8192
SUM_RTOL = 1e-5
SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=4), TopK(k=7, dim=2, largest=False),
         Agg("sum", 3), Agg("min", 2), Agg("max", 0)]


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    ops.reset_kernel_launches()
    obs.registry().reset()
    yield


def _jspec(spec):
    """The reference's spec of the same kind and fields."""
    kind = type(spec).__name__
    return getattr(JT, kind)(**{f.name: getattr(spec, f.name)
                                for f in dataclasses.fields(spec)})


def _synt_queries(cols, n_q, seed):
    """SYNT-UNI boxes: the paper's two-record ranges, every other one
    partial-match over a random subset of dims."""
    rng = np.random.default_rng(seed)
    m, n = cols.shape
    out = []
    for k in range(n_q):
        a, b = cols[:, rng.integers(n)], cols[:, rng.integers(n)]
        lo, up = np.minimum(a, b), np.maximum(a, b)
        if k % 2:
            dims = rng.choice(m, size=int(rng.integers(1, m)), replace=False)
            out.append(RangeQuery.partial(
                m, {int(d): (float(lo[d]), float(up[d])) for d in dims}))
        else:
            out.append(RangeQuery.complete(lo, up))
    return out


@pytest.fixture(scope="module", params=["gmrqb", "synt_uni"])
def engines(request):
    """(port engine, reference engine, host cols, port queries)."""
    if request.param == "gmrqb":
        ds = gmrqb.build(N, seed=0)
        queries = [q for _, q in gmrqb.mixed_workload(ds, 32, seed=0)]
    else:
        ds = synthetic.synt_uni(N, 5, seed=3)
        queries = _synt_queries(ds.cols, 32, seed=4)
    port = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, device="cpu")
    ref = JEngine(JT.Dataset(ds.cols), structures=("scan",), tile_n=TILE_N)
    return port, ref, ds.cols, queries


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


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_query_batch_matches_reference(engines, spec):
    port, ref, _, queries = engines
    jops.reset_counters()
    want = ref.query_batch([_jq(q) for q in queries], method="auto",
                           spec=_jspec(spec))
    want_counts = jops.counters()
    got = port.query_batch(queries, method="auto", spec=spec)
    _assert_same(spec, got, want)
    assert port.last_batch_stats.methods == ref.last_batch_stats.methods
    assert port.last_batch_stats.method_counts \
        == ref.last_batch_stats.method_counts
    assert ops.counters() == want_counts
    # one fused launch and one host sync per bucket
    assert ops.counter("host_sync") == len(port.last_batch_stats.method_counts)


@pytest.mark.parametrize("b", [1, 8, 32])
def test_plan_batch_matches_reference(engines, b):
    port, ref, _, queries = engines
    for spec in (Ids(), Count()):
        got = port.planner.plan_batch(QueryBatch.from_queries(queries[:b]),
                                      spec=spec)
        want = ref.planner.plan_batch(
            JT.QueryBatch.from_queries([_jq(q) for q in queries[:b]]),
            spec=_jspec(spec))
        assert got.methods == want.methods
        assert got.bucket_sizes == want.bucket_sizes
        np.testing.assert_array_equal(got.costs, want.costs)
        np.testing.assert_array_equal(got.est_selectivity, want.est_selectivity)


def test_plans_follow_the_cost_model_constants(engines):
    """Both models holding the same (non-default) constants plan alike."""
    port, ref, _, queries = engines
    changed = {"sec_per_cmp": 1e-15, "sec_per_result_byte": 1.0 / 4e9}
    saved = {k: getattr(port.planner.model, k) for k in changed}
    for model in (port.planner.model, ref.planner.model):
        for k, v in changed.items():
            setattr(model, k, v)
    try:
        got = port.planner.plan_batch(QueryBatch.from_queries(queries))
        want = ref.planner.plan_batch(
            JT.QueryBatch.from_queries([_jq(q) for q in queries]))
        assert got.methods == want.methods
    finally:
        for model in (port.planner.model, ref.planner.model):
            for k, v in saved.items():
                setattr(model, k, v)


@pytest.mark.parametrize("spec", [Ids(), Count(), TopK(k=5, dim=1),
                                  Agg("max", 1)], ids=str)
def test_single_queries_match_reference(engines, spec):
    port, ref, _, queries = engines
    jops.reset_counters()
    for q in queries[:6]:
        want = ref.query(_jq(q), spec=_jspec(spec))
        got = port.query(q, spec=spec)
        _assert_same(spec, [got], [want])
        assert port.last_stats.method == ref.last_stats.method
    assert ops.counters() == jops.counters()


def test_traced_batch_matches_reference(engines):
    port, ref, _, queries = engines
    ref.query_batch([_jq(q) for q in queries], spec=JT.Count(), trace=True)
    port.query_batch(queries, spec=Count(), trace=True)
    got, want = port.last_trace, ref.last_trace
    assert [t.method for t in got.queries] == [t.method for t in want.queries]
    for g, w in zip(got.queries, want.queries):
        assert (g.bucket_size, g.result_size, g.mq) \
            == (w.bucket_size, w.result_size, w.mq)
        assert g.launches == w.launches and g.host_syncs == w.host_syncs
        assert g.est_selectivity == w.est_selectivity
        assert g.est_cost == w.est_cost


def test_launch_batch_split_matches_query_batch(engines):
    port, _, _, queries = engines
    want = port.query_batch(queries, spec=TopK(k=3, dim=0))
    ops.reset_counters()
    pending = port.launch_batch(queries, spec=TopK(k=3, dim=0))
    assert ops.counter("host_sync") == 0      # nothing synced at launch
    got = pending.finalize()
    _assert_same(TopK(k=3, dim=0), got, want)
    assert ops.counter("host_sync") == len(pending.method_counts)
    assert pending.stats.n_queries == len(queries)


def test_server_matches_reference_server(engines):
    port, ref, _, queries = engines
    got = MDRQServer(port, max_batch=8, spec=Count()).serve_all(queries)
    jobs.registry().reset()
    want = JServer(ref, max_batch=8, spec=JT.Count()).serve_all(
        [_jq(q) for q in queries])
    assert got == want
    assert got == port.query_batch(queries, spec=Count())


def test_explicit_methods_match_reference(engines):
    port, ref, _, queries = engines
    partial = [q for q in queries if not q.is_complete_match]
    for method, qs in (("scan", queries), ("scan_vertical", partial)):
        got = port.query_batch(qs, method=method, spec=Count())
        want = ref.query_batch([_jq(q) for q in qs], method=method,
                               spec=JT.Count())
        assert got == want


def test_plain_backend_matches_auto_on_cpu(engines):
    port, _, cols, queries = engines
    plain = MDRQEngine(port.dataset, structures=("scan",), tile_n=TILE_N,
                       device="cpu", backend="torch")
    for spec in (Ids(), TopK(k=4, dim=0, largest=False), Agg("sum", 1)):
        _assert_same(spec, plain.query_batch(queries, spec=spec),
                     port.query_batch(queries, spec=spec))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    ds = synthetic.synt_uni(1024, 3, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        MDRQEngine(ds)


def test_empty_batch_and_bad_dims():
    ds = synthetic.synt_uni(1024, 3, seed=0)
    eng = MDRQEngine(ds, tile_n=TILE_N, device="cpu")
    assert eng.query_batch([]) == []
    with pytest.raises(ValueError, match="dims"):
        eng.query_batch([RangeQuery.complete([0, 0], [1, 1])])
    with pytest.raises(ValueError, match="out of range"):
        eng.query_batch([RangeQuery.complete([0] * 3, [1] * 3)],
                        spec=TopK(k=1, dim=3))


@pytest.mark.parametrize("which", ["gmrqb", "workload", "synt_uni", "synt_clust"])
def test_generators_match_reference(which):
    if which == "gmrqb":
        np.testing.assert_array_equal(gmrqb.build(3000, seed=5).cols,
                                      jgmrqb.build(3000, seed=5).cols)
    elif which == "workload":
        ds = gmrqb.build(3000, seed=5)
        got = gmrqb.mixed_workload(ds, 40, seed=2)
        want = jgmrqb.mixed_workload(JT.Dataset(ds.cols), 40, seed=2)
        for (k, q), (jk, jq) in zip(got, want):
            assert k == jk
            np.testing.assert_array_equal(q.lower, jq.lower)
            np.testing.assert_array_equal(q.upper, jq.upper)
    elif which == "synt_uni":
        np.testing.assert_array_equal(synthetic.synt_uni(3000, 7, seed=1).cols,
                                      jsyn.synt_uni(3000, 7, seed=1).cols)
    else:
        np.testing.assert_array_equal(
            synthetic.synt_clust(3000, 7, 4, seed=1).cols,
            jsyn.synt_clust(3000, 7, 4, seed=1).cols)


def test_per_query_path_serves_every_spec(engines):
    """A registered single-query path rides the registry; reduced specs
    finalize on the host from its ids."""
    from repro_torch.core import PerQueryPath
    port, _, cols, queries = engines
    port.register_path(PerQueryPath("perquery", port.columnar, cols=cols))
    try:
        assert "perquery" not in port.planner.available   # not plannable
        for spec in (Ids(), Count(), TopK(k=3, dim=1), Agg("min", 0)):
            _assert_same(spec, port.query_batch(queries, method="perquery",
                                                spec=spec),
                         port.query_batch(queries, method="scan", spec=spec))
    finally:
        del port.paths["perquery"]


@pytest.mark.parametrize("kwargs", [
    {}, {"batch_size": 64}, {"index_path": "vafile"}, {"m_q": 2, "batch_size": 8},
    {"spec": "count"}, {"n_devices": 4}])
def test_break_even_matches_reference(kwargs):
    """The structure-free planner studies: same histograms, same model,
    the same break-even selectivity."""
    from repro.core.planner import CostModel as JCost, Planner as JPlanner
    from repro.core.planner import Histograms as JHist
    from repro_torch.core import CostModel, Histograms, Planner
    ds = synthetic.synt_uni(20_000, 6, seed=8)
    jhist = JHist.build(JT.Dataset(ds.cols))
    kw = dict(kwargs)
    jkw = dict(kwargs)
    if kw.get("spec") == "count":
        kw["spec"], jkw["spec"] = Count(), JT.Count()
    got = Planner(Histograms.build(ds), CostModel(n=1_000_000, m=6)) \
        .break_even_selectivity(**kw)
    want = JPlanner(jhist, JCost(n=1_000_000, m=6)).break_even_selectivity(**jkw)
    assert got == want


def test_calibrate_matches_reference():
    from repro.core.planner import CostModel as JCost, Planner as JPlanner
    from repro.core.planner import Histograms as JHist
    from repro_torch.core import CostModel, Histograms, Planner
    ds = synthetic.synt_uni(5000, 4, seed=9)
    rng = np.random.default_rng(10)
    samples = [("scan", float(b), float(2e-6 + b / 1e12 * rng.uniform(0.9, 1.1)))
               for b in rng.uniform(1e6, 1e9, size=12)]
    port = Planner(Histograms.build(ds), CostModel(n=ds.n, m=ds.m))
    ref = JPlanner(JHist.build(JT.Dataset(ds.cols)), JCost(n=ds.n, m=ds.m))
    got, want = port.calibrate(samples), ref.calibrate(samples)
    assert [(f.constant, f.fitted, f.accepted) for f in got.fits] \
        == [(f.constant, f.fitted, f.accepted) for f in want.fits]
    assert port.model.sec_per_byte == ref.model.sec_per_byte
    assert got.rms_rel_err == want.rms_rel_err
