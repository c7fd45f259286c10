"""The MDRQ names the port adds to its modules, against the reference on the
CPU: the deprecated ``mode=`` alias and string specs of the entry points,
and every name the reference's examples and benchmarks call — the same
numpy inputs through both packages, the same results (exactly, or bit for
bit where the name generates data). The reference runs its Pallas kernels
in interpret mode, as its own tests do.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core import MDRQEngine as JEngine
from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.core import scan as jscan
from repro.core import types as JT
from repro.data import gmrqb as jgmrqb
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.kernels import va_filter as jva
from repro.obs import tracing as jtracing
from repro_torch import core as tcore
from repro_torch.core import (ALL_METHODS, RESULT_MODES, Count, Dataset, Ids,
                              MDRQEngine, QueryBatch, RangeQuery,
                              match_ids_np, validate_mode)
from repro_torch.core import engine as tengine
from repro_torch.core import planner as tplanner
from repro_torch.core import scan as tscan
from repro_torch.core import types as T
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import ops, ref, va_filter
from repro_torch.obs import tracing

TILE_N = 512


def _calls(fn):
    """(result or the raised exception's type, warning categories)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn()
        except Exception as e:          # noqa: BLE001 — compared by type
            out = type(e)
    return out, [w.category for w in caught]


def _same(a, b) -> bool:
    if isinstance(a, type) or isinstance(b, type):
        return a is b
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, np.asarray(b))
    return a == b


@pytest.fixture(scope="module")
def synt_pair():
    """SYNT-UNI 4,000 x 3 (seed 0), ``workload(seed=1)``, the scan built
    in both packages."""
    ds = synthetic.synt_uni(4000, 3, seed=0)
    jds = jsyn.synt_uni(4000, 3, seed=0)
    port = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, device="cpu")
    refe = JEngine(jds, structures=("scan",), tile_n=TILE_N)
    qs = synthetic.workload(ds, 4, seed=1)
    jqs = jsyn.workload(jds, 4, seed=1)
    return port, refe, qs, jqs


# -- A.1: the legacy mode= alias and string specs -------------------------------

@pytest.mark.parametrize("kw", [{"mode": "ids"}, {"mode": "count"},
                                {"spec": "count"}, {"spec": "ids"},
                                {"mode": "topk"}, {"spec": "topk"},
                                {"mode": "count", "spec": "count"}])
def test_mode_alias_single_query_matches_the_reference(synt_pair, kw):
    port, refe, qs, jqs = synt_pair
    got, got_w = _calls(lambda: port.query(qs[0], **kw))
    want, want_w = _calls(lambda: refe.query(jqs[0], **kw))
    assert _same(got, want), (got, want)
    assert got_w == want_w
    if "topk" not in kw.values() and len(kw) == 1:
        assert got_w == [DeprecationWarning]     # once per user call


@pytest.mark.parametrize("kw", [{"mode": "ids"}, {"mode": "count"},
                                {"spec": "count"}, {"spec": "ids"},
                                {"mode": "topk"}, {"spec": "topk"},
                                {"mode": "ids", "spec": "ids"}])
def test_mode_alias_batch_matches_the_reference(synt_pair, kw):
    port, refe, qs, jqs = synt_pair
    got, got_w = _calls(lambda: port.query_batch(qs, **kw))
    want, want_w = _calls(lambda: refe.query_batch(jqs, **kw))
    assert _same(got, want), (got, want)
    assert got_w == want_w
    if kw == {"spec": "count"}:
        assert got == [92, 233, 58, 7]


def test_mode_alias_on_launch_batch_and_the_structures(synt_pair):
    port, _, qs, _ = synt_pair
    want = port.query_batch(qs, spec=Count())
    got, w = _calls(lambda: port.launch_batch(qs, mode="count").finalize())
    assert got == want and w == [DeprecationWarning]
    batch = QueryBatch.from_queries(qs)
    for partial in (False, True):
        got, w = _calls(lambda: port.columnar.query_batch(
            batch, partial=partial, spec="count"))
        assert got == want and w == [DeprecationWarning]
    with pytest.raises(ValueError, match="unknown mode 'topk'"):
        port.columnar.launch_batch(batch, spec="topk")


def test_validate_mode_matches_the_reference():
    for spec in (Ids(), Count(), T.TopK(k=3, dim=1)):
        assert validate_mode(spec) is spec
    for mode in RESULT_MODES:
        with pytest.warns(DeprecationWarning, match=f"mode='{mode}'"):
            got = validate_mode(mode)
        with pytest.warns(DeprecationWarning):
            want = JT.validate_mode(mode)
        assert got.kind == want.kind == mode
    for bad in ("topk", None, 3):
        with pytest.raises(ValueError) as e_port:
            validate_mode(bad)
        with pytest.raises(ValueError) as e_ref:
            JT.validate_mode(bad)
        assert str(e_port.value) == str(e_ref.value)


# -- C.1 / C.2: core/types.py and core/engine.py --------------------------------

def test_types_names_match_the_reference():
    rng = np.random.default_rng(5)
    rows = rng.random((300, 4)).astype(np.float32)
    ds, jds = Dataset.from_rows(rows), JT.Dataset.from_rows(rows)
    assert np.array_equal(ds.cols, jds.cols) and ds.cols.flags.c_contiguous
    lo, up = np.sort(rng.random((2, 4)).astype(np.float32), axis=0)
    q, jq = RangeQuery.complete(lo, up), JT.RangeQuery.complete(lo, up)
    assert ds.selectivity(q) == jds.selectivity(jq)
    order = np.array([2, 0, 3, 1])
    r, jr = q.reorder(order), jq.reorder(order)
    assert np.array_equal(r.lower, jr.lower) and np.array_equal(r.upper,
                                                                jr.upper)
    qs = [RangeQuery.partial(4, {1: (0.2, 0.6)}), q]
    jqs = [JT.RangeQuery.partial(4, {1: (0.2, 0.6)}), jq]
    got = QueryBatch.from_queries(qs).queries
    want = JT.QueryBatch.from_queries(jqs).queries
    assert [(a.lower.tolist(), a.upper.tolist()) for a in got] \
        == [(b.lower.tolist(), b.upper.tolist()) for b in want]
    mask = rng.random(50) < 0.3
    assert np.array_equal(T.mask_to_ids(mask), JT.mask_to_ids(mask))
    assert T.mask_to_ids(mask).dtype == np.int64
    assert np.array_equal(T.mask_to_ids(torch.as_tensor(mask)),
                          JT.mask_to_ids(mask))


def test_engine_constants_and_exports_match_the_reference():
    assert ALL_METHODS == jengine.ALL_METHODS == tengine.ALL_METHODS
    assert RESULT_MODES == jengine.RESULT_MODES == tengine.RESULT_MODES
    import repro.core as jcore
    for name in ("ALL_METHODS", "RESULT_MODES", "validate_mode"):
        assert name in jcore.__all__ and name in tcore.__all__


# -- C.3: the planner -----------------------------------------------------------

def _planners(cols):
    """Name-built planners of both packages over the same histograms, and
    their engine twins' planners (scan paths), default constants."""
    ds, jds = Dataset(cols), JT.Dataset(cols)
    names = ("scan", "scan_vertical", "kdtree", "vafile")
    port = tplanner.Planner(tplanner.Histograms.build(ds),
                            tplanner.CostModel(n=ds.n, m=ds.m),
                            available=names)
    refp = jplanner.Planner(jplanner.Histograms.build(jds),
                            jplanner.CostModel(n=jds.n, m=jds.m),
                            available=names)
    return port, refp


@pytest.mark.parametrize("spec", [Ids(), Count()])
def test_explain_batch_and_choose_match_the_reference(spec):
    ds = gmrqb.build(3000, seed=0)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 24, seed=2)]
    jqs = [JT.RangeQuery(q.lower, q.upper) for q in qs]
    port, refp = _planners(ds.cols)
    jspec = getattr(JT, type(spec).__name__)()
    got, want = port.explain_batch(qs, spec=spec), refp.explain_batch(
        jqs, spec=jspec)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for b in (1, 8, 128):
        assert [port.choose(q, b) for q in qs] \
            == [refp.choose(q, b) for q in jqs]
    assert port.explain_batch([]) == refp.explain_batch([]) == []


def test_engine_planners_explain_batch_like_the_reference(synt_pair):
    port, refe, qs, jqs = synt_pair
    got = port.planner.explain_batch(qs)
    want = refe.planner.explain_batch(jqs)
    assert [dataclasses.asdict(p) for p in got] \
        == [dataclasses.asdict(p) for p in want]
    assert port.planner.choose(qs[1]) == refe.planner.choose(jqs[1])


# -- C.4: core/scan.py ----------------------------------------------------------

@pytest.fixture(scope="module")
def gmrqb_scans():
    ds = gmrqb.build(6000, seed=0)
    port = tscan.build_columnar_scan(ds, tile_n=TILE_N, device="cpu")
    refs = jscan.build_columnar_scan(JT.Dataset(ds.cols), tile_n=TILE_N)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 20, seed=0)]
    return ds, port, refs, qs


@pytest.mark.parametrize("call", ["mask_batch", "mask_batch_partial",
                                  "count_batch", "count_batch_partial"])
def test_columnar_batch_calls_match_the_reference(gmrqb_scans, call):
    ds, port, refs, qs = gmrqb_scans
    batch = QueryBatch.from_queries(qs)
    jbatch = JT.QueryBatch(batch.lower, batch.upper)
    name, _, partial = call.partition("_batch")
    kw = {"partial": True} if name == "count" and partial else {}
    meth = "count_batch" if name == "count" else call
    ops.reset_counters()
    got = getattr(port, meth)(batch, **kw)
    counts = ops.counters()
    want = getattr(refs, meth)(jbatch, **kw)
    if name == "count":
        assert got == want
        assert got == [match_ids_np(ds.cols, q).size for q in qs]
    else:
        assert got.dtype == bool and got.shape == (len(qs), ds.n)
        assert np.array_equal(got, np.asarray(want))
        assert all(np.array_equal(np.nonzero(got[k])[0],
                                  tscan.numpy_scan_ids(ds.cols, q))
                   for k, q in enumerate(qs))
    # one counted fused launch and one counted host sync per call
    assert counts.pop("host_sync") == 1
    assert len(counts) == 1 and sum(counts.values()) == 1


def test_numpy_scan_ids_matches_the_reference(gmrqb_scans):
    ds, _, _, qs = gmrqb_scans
    for q in qs:
        jq = JT.RangeQuery(q.lower, q.upper)
        assert np.array_equal(tscan.numpy_scan_ids(ds.cols, q),
                              jscan.numpy_scan_ids(ds.cols, jq))


# -- C.5 / C.6: the data generators ---------------------------------------------

def test_synthetic_power_and_targeted_query_bit_equal():
    for n, seed in ((1000, 0), (2500, 7)):
        assert np.array_equal(synthetic.power(n, seed).cols,
                              jsyn.power(n, seed).cols)
    ds, jds = synthetic.synt_uni(2000, 6, seed=4), jsyn.synt_uni(2000, 6,
                                                                 seed=4)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for target in (1e-4, 0.01, 0.3):
        q = synthetic.selectivity_targeted_query(ds, target, rng)
        jq = jsyn.selectivity_targeted_query(jds, target, jrng)
        assert np.array_equal(q.lower, jq.lower)
        assert np.array_equal(q.upper, jq.upper)
    from repro_torch import data
    assert {"power", "selectivity_targeted_query"} <= set(data.__all__)


def test_gmrqb_table1_matches_the_reference():
    assert [dataclasses.asdict(r) for r in gmrqb.PAPER_TABLE1] \
        == [dataclasses.asdict(r) for r in jgmrqb.PAPER_TABLE1]
    ds, rows = gmrqb.measure_table1(n=2000, n_inst=6, seed=0)
    jds, jrows = jgmrqb.measure_table1(n=2000, n_inst=6, seed=0)
    assert np.array_equal(ds.cols, jds.cols)
    assert [dataclasses.asdict(r) for r in rows] \
        == [dataclasses.asdict(r) for r in jrows]
    assert all(isinstance(r, gmrqb.Table1Row) for r in rows)


# -- C.7: obs/tracing.py --------------------------------------------------------

def test_tracing_current_is_per_thread_like_the_reference():
    assert tracing.current() is None and jtracing.current() is None
    seen = []
    with tracing.Tracer() as t, jtracing.Tracer() as jt:
        assert tracing.current() is t and jtracing.current() is jt
        th = threading.Thread(target=lambda: seen.append(
            (tracing.current(), jtracing.current())))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with tracing.Tracer() as inner:
            assert tracing.current() is inner
        assert tracing.current() is t
    assert seen == [(None, None)]
    assert tracing.current() is None


# -- C.8 / C.9: kernels/ref.py and kernels/va_filter.py -------------------------

def test_range_scan_blocks_ref_matches_the_reference_and_the_visit_ref():
    rng = np.random.default_rng(3)
    blocks = rng.random((6, 8, 128)).astype(np.float32)
    ids = np.array([4, 0, -1, 5, 4, 2], np.int32)
    lo = np.full(8, 0.1, np.float32)
    up = np.full(8, 0.9, np.float32)
    got = ref.range_scan_blocks_ref(torch.as_tensor(blocks),
                                    torch.as_tensor(ids), torch.as_tensor(lo),
                                    torch.as_tensor(up))
    want = np.asarray(jref.range_scan_blocks_ref(blocks, ids, lo, up))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    other = ref.multi_scan_blocks_ref(
        torch.as_tensor(blocks), torch.zeros(len(ids), dtype=torch.int32),
        torch.as_tensor(ids), torch.as_tensor(lo)[:, None],
        torch.as_tensor(up)[:, None])
    assert torch.equal(got, other)


def test_va_filter_ref_matches_the_reference_and_the_packed_ref():
    rng = np.random.default_rng(4)
    m, n = 19, 640
    codes = rng.integers(0, 4, size=(m, n)).astype(np.uint8)
    lo = rng.integers(0, 3, size=m).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 3, size=m), 3).astype(np.int32)
    got = ref.va_filter_ref(torch.as_tensor(codes), torch.as_tensor(lo),
                            torch.as_tensor(hi))
    want = np.asarray(jref.va_filter_ref(codes, lo, hi))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    packed = torch.as_tensor(va_filter.pack_codes(codes))
    other = ref.va_filter_packed_ref(packed, torch.as_tensor(lo),
                                     torch.as_tensor(hi), m)
    assert torch.equal(got, other)


def test_va_filter_constants_match_the_reference():
    assert va_filter.DEFAULT_TILE_N == jva.DEFAULT_TILE_N == 2048
    assert va_filter.LANES == jva.LANES == 128
