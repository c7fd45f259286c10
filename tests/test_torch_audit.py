"""The port's drift audit and calibration bridge against the reference's.

``repro_torch.obs.audit`` / ``calibration_samples`` against
``repro.obs.audit`` on the CPU:

  * hand-built ``QueryTrace`` lists (numpy seed) fed to both: the same
    cells, deciles, counts, flags and summary; means and ratios equal to
    1e-12 relative (the same float sums in the same order give equal bits,
    so this only allows for a changed summation);
  * traces of the same queries on the two engines (GMRQB, n = 8192): the
    same cells and estimates;
  * the reference's audit and calibration tests run on the port's engine
    (skewed histograms flagged, cell bucketing, a corrupted constant
    repaired by ``Planner.calibrate``);
  * equal modeled bytes per trace, hence equal calibration samples, for the
    same model constants on every path, with and without a delta.
"""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import types as JT
from repro.core import MDRQEngine as JEngine
from repro.core.planner import CostModel as JCost
from repro.obs import tracing as jtracing
from repro_torch import obs
from repro_torch.core import (Count, CostModel, Dataset, MDRQEngine,
                              RangeQuery)
from repro_torch.data import gmrqb
from repro_torch.kernels import ops
from repro_torch.obs import tracing

REL = 1e-12
METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile", "rowscan",
           "custom")


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    obs.registry().reset()
    yield


def _traces(n, seed, mod):
    """``n`` QueryTrace records of module ``mod`` (either package's
    ``obs.tracing``): every method, every decile, NaN costs, unobservable
    results, zero estimates, selectivities at the decile edges."""
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, 0.1, 0.1 - 1e-12, 0.5, 0.9, 0.999, 1.0])
    out = []
    for k in range(n):
        est = float(rng.choice(edges)) if k % 5 == 0 \
            else float(rng.random() ** 3)
        obs_sel = None if k % 7 == 3 else float(
            min(1.0, est * rng.lognormal(0.0, 1.5)))
        cost = math.nan if k % 4 == 1 else float(rng.lognormal(-9, 1))
        out.append(mod.QueryTrace(
            index=k, method=str(rng.choice(METHODS)),
            bucket_size=int(rng.integers(1, 129)), est_selectivity=est,
            est_cost=cost, spec_kind="ids", mq=int(rng.integers(1, 20)),
            result_size=0, obs_selectivity=obs_sel,
            seconds=float(rng.lognormal(-8, 1)), launches=1.0,
            host_syncs=1.0))
    return out


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= REL * max(abs(a), abs(b))
    return a == b


def _assert_same_report(got, want):
    assert (got.n_traces, got.n_unobserved, got.sel_tolerance,
            got.cost_tolerance, got.ok) == \
        (want.n_traces, want.n_unobserved, want.sel_tolerance,
         want.cost_tolerance, want.ok)
    assert len(got.cells) == len(want.cells)
    for g, w in zip(got.cells, want.cells):
        for f in dataclasses.fields(w):
            assert _close(getattr(g, f.name), getattr(w, f.name)), \
                (f.name, g, w)


@pytest.mark.parametrize("kw", [
    {}, {"sel_tolerance": 2.0}, {"sel_tolerance": 1.5, "min_queries": 3},
    {"cost_tolerance": 3.0}, {"cost_tolerance": 1.2, "min_queries": 2},
], ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_audit_matches_reference_on_hand_built_traces(kw, seed):
    got = obs.audit(_traces(300, seed, tracing), **kw)
    want = jobs.audit(_traces(300, seed, jtracing), **kw)
    _assert_same_report(got, want)
    assert got.summary() == want.summary()
    assert len(got.drifted) == len(want.drifted)


def test_audit_takes_batch_traces_and_rejects_other_records():
    qs = _traces(20, 3, tracing)
    bt = tracing.BatchTrace(n=100, n_queries=20, spec_kind="ids",
                            plan_seconds=0.0, seconds=0.0, queries=qs,
                            spans=[])
    _assert_same_report(obs.audit([bt, qs[0]]), obs.audit(qs + qs[:1]))
    _assert_same_report(obs.audit(bt), obs.audit(qs))
    with pytest.raises(TypeError, match="QueryTrace"):
        obs.audit([object()])


def _gmrqb_pair(n=8192):
    ds = gmrqb.build(n, seed=0)
    queries = [q for _, q in gmrqb.mixed_workload(ds, 32, seed=0)]
    port = MDRQEngine(ds, tile_n=512, device="cpu")
    ref = JEngine(JT.Dataset(ds.cols), tile_n=512)
    return port, ref, queries


@pytest.fixture(scope="module")
def gmrqb_pair():
    return _gmrqb_pair()


@pytest.mark.parametrize("method", ["auto", "scan", "kdtree", "vafile"])
def test_audit_of_engine_traces_matches_reference(gmrqb_pair, method):
    """The same queries through both engines: the same cells and estimates
    (measured seconds differ, so cost ratios are not compared)."""
    port, ref, queries = gmrqb_pair
    port.query_batch(queries, method=method, spec=Count(), trace=True)
    ref.query_batch([JT.RangeQuery(q.lower, q.upper) for q in queries],
                    method=method, spec=JT.Count(), trace=True)
    got, want = obs.audit(port.last_trace), jobs.audit(ref.last_trace)
    assert len(got.cells) == len(want.cells) > 0
    for g, w in zip(got.cells, want.cells):
        assert (g.method, g.decile, g.n_queries, g.n_observed, g.drifted) \
            == (w.method, w.decile, w.n_queries, w.n_observed, w.drifted)
        for name in ("mean_est_sel", "mean_obs_sel", "sel_ratio",
                     "mean_est_cost"):
            assert _close(getattr(g, name), getattr(w, name)), name


# -- the reference's audit tests (tests/test_obs.py), on the port ------------

def test_audit_flags_skewed_histograms():
    """Perfectly correlated dims break the independence assumption: the
    estimate is ~sel^2 where reality is ~sel — the audit flags the cells,
    and a well-modeled dataset stays clean."""
    rng = np.random.default_rng(11)
    col = rng.random(8_192, dtype=np.float32)
    skewed = MDRQEngine(Dataset(np.stack([col, col])), structures=("scan",),
                        device="cpu")
    qs = []
    for _ in range(24):
        lo = float(rng.random() * 0.6)
        qs.append(RangeQuery.complete([lo, lo], [lo + 0.25, lo + 0.25]))
    skewed.query_batch(qs, method="scan", trace=True)
    report = obs.audit(skewed.last_trace, sel_tolerance=2.0)
    assert not report.ok
    assert all(c.method == "scan" for c in report.drifted)
    assert all(c.sel_ratio > 2.0 for c in report.drifted)
    assert "DRIFT" in report.summary()

    ok_eng = MDRQEngine(Dataset(rng.random((2, 8_192), dtype=np.float32)),
                        structures=("scan",), device="cpu")
    ok_eng.query_batch(qs, method="scan", trace=True)
    assert obs.audit(ok_eng.last_trace, sel_tolerance=2.0).ok


def test_audit_cell_bucketing():
    def qt(method, est, obs_sel, cost=float("nan")):
        return tracing.QueryTrace(
            index=0, method=method, bucket_size=4, est_selectivity=est,
            est_cost=cost, spec_kind="ids", mq=2, result_size=0,
            obs_selectivity=obs_sel, seconds=1e-4, launches=0.25,
            host_syncs=0.25)
    report = obs.audit(
        [qt("scan", 0.05, 0.05), qt("scan", 0.55, 0.54),
         qt("kdtree", 0.01, 0.3)], sel_tolerance=4.0)
    cells = {(c.method, c.decile): c for c in report.cells}
    assert set(cells) == {("scan", 0), ("scan", 5), ("kdtree", 0)}
    assert not cells[("scan", 0)].drifted
    assert cells[("kdtree", 0)].drifted  # 30x past a 4x tolerance
    # unobservable traces (reduced specs) are counted but never flagged
    rep2 = obs.audit([qt("scan", 0.05, None)])
    assert rep2.n_unobserved == 1 and rep2.ok


def _box_queries(m, n_q, seed, width=0.4):
    rng = np.random.default_rng(seed)
    lo = rng.random((n_q, m)).astype(np.float32) * (1 - width)
    return [RangeQuery.complete(lo[k], lo[k] + width) for k in range(n_q)]


def test_calibration_repairs_corrupted_cost_constant():
    """Corrupt a machine constant, run traced queries, and show
    ``Planner.calibrate`` on the traces' samples repairs it through the
    ``CalibrationReport`` (trace -> audit -> calibrate)."""
    # One intra-op thread: the timings are the fit's input, and test
    # workers sharing the cores would otherwise oversubscribe them.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _calibration_repairs()
    finally:
        torch.set_num_threads(threads)


def _least_disturbed_traces(eng, batches, min_rounds=9, max_rounds=400,
                            calm=0.1):
    """Each batch's least disturbed traced Count run on the CPU.

    The fit's input is wall-clock time, and a machine shared with other
    processes preempts a run for whole scheduler slices (~20 ms against a
    1-4 ms batch): under load every one of a few runs of a size can be hit,
    which makes the slope negative. A run's disturbance is the share of its
    wall time this thread spent off the CPU (wall minus
    ``time.thread_time``; with one intra-op thread the whole batch runs on
    it). The sizes go in turns, at least ``min_rounds`` rounds and until
    each size has a run under ``calm``; each size keeps its least disturbed
    run's trace.
    """
    best = [None] * len(batches)
    stolen = [math.inf] * len(batches)
    for r in range(max_rounds):
        for k, qs in enumerate(batches):
            c0, t0 = time.thread_time(), time.perf_counter()
            eng.query_batch(qs, method="scan", spec=Count(), trace=True)
            wall = time.perf_counter() - t0
            share = max(0.0, wall - (time.thread_time() - c0)) / wall
            if share < stolen[k]:
                best[k], stolen[k] = eng.last_trace, share
        if r + 1 >= min_rounds and max(stolen) < calm:
            break
    return best


def _calibration_repairs():
    # 5,000 rows (the reference's test takes 50,000): on the CPU the plain
    # scan's work is per query, so only a batch's fixed costs amortize over
    # it the way the model's bytes do; at this size they dominate.
    rng = np.random.default_rng(5)
    eng = MDRQEngine(Dataset(rng.random((4, 5_000), dtype=np.float32)),
                     structures=("scan",), device="cpu")
    model = eng.planner.model
    true_spb = model.sec_per_byte
    model.sec_per_byte = corrupted = true_spb * 1e6

    # traced traffic at several batch sizes — bucket amortization varies
    # modeled bytes per query, which is what the lstsq fit needs.
    batches = [_box_queries(4, b, seed=seed)
               for b, seed in ((4, 0), (16, 1), (64, 2))]
    for qs in batches:
        eng.query_batch(qs, method="scan", spec=Count())  # warm the shape
    best = _least_disturbed_traces(eng, batches)
    samples = []
    for trace in best:
        samples += obs.calibration_samples(trace, model)
    assert len(samples) == 84 and all(m == "scan" for m, _, _ in samples)

    worst = max(corrupted * nb / max(sec, 1e-12) for _, nb, sec in samples)
    assert worst > 50

    report = eng.planner.calibrate(samples)
    assert report.n_samples == 84 and report.methods == ("scan",)
    assert report.accepted["sec_per_byte"]
    assert model.sec_per_byte < corrupted / 50
    resid = [abs(model.sec_per_byte * nb + model.dispatch_overhead - sec)
             / max(sec, 1e-12) for _, nb, sec in samples]
    assert np.median(resid) < 1.0 < worst


# -- modeled bytes / calibration samples -------------------------------------

@pytest.mark.parametrize("delta_n", [0, 1000])
def test_calibration_samples_match_reference(delta_n):
    kw = dict(n=1_000_000, m=19, tile_n=1024, delta_n=delta_n)
    traces = _traces(400, 7, tracing)
    jtraces = _traces(400, 7, jtracing)
    got = obs.calibration_samples(traces, CostModel(**kw))
    want = jobs.calibration_samples(jtraces, JCost(**kw))
    assert len(got) == len(want) > 0
    # "custom" has no byte model: dropped by both
    assert {m for m, _, _ in got} == set(METHODS) - {"custom"}
    for (gm, gb, gs), (wm, wb, ws) in zip(got, want):
        assert gm == wm and gs == ws
        assert _close(gb, wb)
    for t in traces:
        sel = t.obs_selectivity if t.obs_selectivity is not None \
            else t.est_selectivity
        a = CostModel(**kw).modeled_bytes(t.method, sel=sel, mq=t.mq,
                                          bucket=t.bucket_size)
        b = JCost(**kw).modeled_bytes(t.method, sel=sel, mq=t.mq,
                                      bucket=t.bucket_size)
        assert (a is None and b is None) or _close(a, b)
