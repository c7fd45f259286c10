"""The port's row-major scan path against the reference's, on the CPU.

``range_scan_rows``'s plain version against the reference's Pallas kernel in
interpret mode (masks exactly equal), then the path as a user drives it:
``RowScan`` and ``MDRQEngine(rowscan=True).query_batch(method="rowscan")``
under the eight result specs, and singles, against the reference's
``MDRQEngine(rowscan=True)`` on the same GMRQB and SYNT-UNI data and queries
— ids, counts, masks and top-k (tie order included) exactly equal, min/max
exactly, sums to rtol=1e-5 (float32 sums in another order) — with the same
launches and host syncs per query.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.core.scan import build_row_scan as jbuild_row_scan
from repro.kernels import ops as jops
from repro.kernels import range_scan as jrs
from repro_torch import obs
from repro_torch.core import (Agg, Count, Ids, Mask, MDRQEngine, RangeQuery,
                              TopK, build_row_scan)
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import ops, range_scan, ref

TILE_N = 512
N = 8192
SUM_RTOL = 1e-5
SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=4),
         TopK(k=7, dim=2, largest=False), Agg("sum", 3), Agg("min", 2),
         Agg("max", 0)]


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


# -- the kernel's plain version against the Pallas kernel ---------------------

def _rows_case(m, seed, n=3000, tile_rows=512):
    """(n_pad, m_pad) padded rows and (1, m_pad) bounds of one query."""
    rng = np.random.default_rng(seed)
    rows = rng.random((n, m), dtype=np.float32)
    rows[:, 0] = rng.integers(0, 3, size=n)   # a categorical dim: ties
    m_pad = -(-m // 8) * 8
    n_pad = -(-n // tile_rows) * tile_rows
    data = np.zeros((n_pad, m_pad), np.float32)
    data[:n, :m] = rows
    data[n:] = np.inf
    a, b = rows[rng.integers(n)], rows[rng.integers(n)]
    lo = np.full((1, m_pad), np.finfo(np.float32).min, np.float32)
    up = np.full((1, m_pad), np.finfo(np.float32).max, np.float32)
    lo[0, :m] = np.minimum(a, b) - 0.3
    up[0, :m] = np.maximum(a, b) + 0.3
    return data, lo, up


@pytest.mark.parametrize("m", [3, 19, 100])
def test_range_scan_rows_matches_pallas(m):
    data, lo, up = _rows_case(m, seed=m)
    want = np.asarray(jrs.range_scan_rows(
        jnp.asarray(data), jnp.asarray(lo), jnp.asarray(up), tile_rows=512,
        interpret=True))
    got = range_scan.range_scan_rows(torch.as_tensor(data), torch.as_tensor(lo),
                                     torch.as_tensor(up), tile_rows=512)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(
        ops.range_scan_rows(torch.as_tensor(data), torch.as_tensor(lo),
                            torch.as_tensor(up), backend="torch").numpy(), want)
    assert ops.counters() == {"range_scan_rows": 1}
    assert ops.kernel_launches() == {}      # the CPU runs the plain version


def test_range_scan_rows_ref_is_the_reference_definition():
    data, lo, up = _rows_case(19, seed=7)
    x, lo_t, up_t = (torch.as_tensor(a) for a in (data, lo, up))
    want = ((x >= lo_t) & (x <= up_t)).all(1).to(torch.int8)
    assert torch.equal(ref.range_scan_rows_ref(x, lo_t, up_t), want)


@pytest.mark.parametrize("shape,bshape", [((1000, 8), (1, 8)),    # n_pad % 512
                                          ((1024, 12), (1, 12)),  # m_pad % 8
                                          ((1024, 8), (8, 1))])   # bounds
def test_range_scan_rows_rejects_bad_shapes(shape, bshape):
    b = torch.zeros(bshape)
    with pytest.raises(ValueError):
        range_scan.range_scan_rows(torch.zeros(shape), b, b, tile_rows=512)


def test_build_row_scan_matches_reference():
    ds = gmrqb.build(3000, seed=4)
    got = build_row_scan(ds, device="cpu")
    want = jbuild_row_scan(JT.Dataset(ds.cols))
    np.testing.assert_array_equal(got.data_dev.numpy(),
                                  np.asarray(want.data_dev))
    assert (got.m, got.n, got.tile_rows) == (want.m, want.n, want.tile_rows)
    assert got.data_dev.shape == (3072, 24)


# -- the path, against the reference engine -----------------------------------

def _synt_queries(cols, n_q, seed):
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
    """(port engine, reference engine, port queries), both with rowscan."""
    if request.param == "gmrqb":
        ds = gmrqb.build(N, seed=0)
        queries = [q for _, q in gmrqb.mixed_workload(ds, 12, seed=0)]
    else:
        ds = synthetic.synt_uni(N, 5, seed=3)
        queries = _synt_queries(ds.cols, 12, seed=4)
    port = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, rowscan=True,
                      device="cpu")
    ref_eng = JEngine(JT.Dataset(ds.cols), structures=("scan",),
                      tile_n=TILE_N, rowscan=True)
    return port, ref_eng, queries


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_rowscan_query_batch_matches_reference(engines, spec):
    port, ref_eng, queries = engines
    jops.reset_counters()
    want = ref_eng.query_batch([_jq(q) for q in queries], method="rowscan",
                               spec=_jspec(spec))
    want_counts = jops.counters()
    got = port.query_batch(queries, method="rowscan", spec=spec)
    _assert_same(spec, got, want)
    assert ops.counters() == want_counts
    # the per-query rung: one row scan and one host sync per query
    assert ops.counter("range_scan_rows") == len(queries)
    _assert_same(spec, got, port.query_batch(queries, method="scan", spec=spec))


@pytest.mark.parametrize("spec", [Ids(), Count(), TopK(k=5, dim=1),
                                  Agg("max", 1)], ids=str)
def test_rowscan_singles_match_reference(engines, spec):
    port, ref_eng, queries = engines
    jops.reset_counters()
    for q in queries[:6]:
        want = ref_eng.query(_jq(q), method="rowscan", spec=_jspec(spec))
        got = port.query(q, method="rowscan", spec=spec)
        _assert_same(spec, [got], [want])
    assert ops.counters() == jops.counters()


def test_rowscan_structure_matches_reference(engines):
    port, ref_eng, queries = engines
    rs, jrs_ = port.rowscan, ref_eng.rowscan
    for q in queries[:4]:
        np.testing.assert_array_equal(rs.mask(q), jrs_.mask(_jq(q)))
        assert rs.count(q) == jrs_.count(_jq(q))
    assert port.memory_report()["rowscan"] == 0
    assert "rowscan" not in port.planner.available   # not plannable


def test_rowscan_is_a_flag_not_a_structure():
    ds = synthetic.synt_uni(1024, 3, seed=0)
    with pytest.raises(ValueError, match="rowscan=True"):
        MDRQEngine(ds, structures=("scan", "rowscan"), device="cpu")
    assert MDRQEngine(ds, structures=("scan",), device="cpu").rowscan is None
