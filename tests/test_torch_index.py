"""The port's two-phase index paths against the reference's, on the CPU.

``repro_torch`` (plain PyTorch versions of the kernels on CPU tensors)
against ``repro`` (Pallas kernels in interpret mode) on the same GMRQB and
SYNT-UNI data (n=8192, tile_n=512) and queries, for the kd-tree, the packed
STR R*-tree and the VA-file:

  * the builds are equal: permutation, MBR hierarchy, packed words, cell
    boundaries — bit for bit;
  * the plain versions of the visit and VA-filter kernels equal the
    reference's Pallas kernels on seeded numpy inputs (exactly: masks);
  * ``query_batch`` under all eight result specs, singles, ``auto`` and the
    launch/finalize split return the reference's results — ids, counts,
    masks and top-k exactly, tie order included (leaf-order position on the
    trees); min/max exactly; sums to rtol=1e-5 (float32 sums taken in a
    different order) — with the same launch and host-sync counters and the
    same visited blocks.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.core.kdtree import build_kdtree as jbuild_kdtree
from repro.core.rstar import build_rstar as jbuild_rstar
from repro.core.vafile import build_vafile as jbuild_vafile
from repro.kernels import multi_scan as jms
from repro.kernels import ops as jops
from repro.kernels import range_scan as jrs
from repro.kernels import va_filter as jva
from repro_torch import obs
from repro_torch.core import (Agg, Count, Ids, Mask, MDRQEngine, QueryBatch,
                              RangeQuery, TopK, build_kdtree, build_rstar,
                              build_vafile)
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import multi_scan, ops, range_scan, va_filter

TILE_N = 512
N = 8192
SUM_RTOL = 1e-5
METHODS = ("kdtree", "rstar", "vafile")
SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=4), TopK(k=7, dim=2, largest=False),
         Agg("sum", 3), Agg("min", 2), Agg("max", 0)]


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    ops.reset_kernel_launches()
    obs.registry().reset()
    yield


def _jspec(spec):
    kind = type(spec).__name__
    return getattr(JT, kind)(**{f.name: getattr(spec, f.name)
                                for f in dataclasses.fields(spec)})


def _jq(q):
    return JT.RangeQuery(q.lower, q.upper)


def _dataset(which):
    if which == "gmrqb":
        ds = gmrqb.build(N, seed=0)
        return ds, [q for _, q in gmrqb.mixed_workload(ds, 32, seed=0)]
    ds = synthetic.synt_uni(N, 5, seed=3)
    rng = np.random.default_rng(4)
    queries = []
    for k in range(32):
        a, b = ds.cols[:, rng.integers(N)], ds.cols[:, rng.integers(N)]
        lo, up = np.minimum(a, b), np.maximum(a, b)
        if k % 2:
            dims = rng.choice(5, size=int(rng.integers(1, 5)), replace=False)
            queries.append(RangeQuery.partial(
                5, {int(d): (float(lo[d]), float(up[d])) for d in dims}))
        else:
            queries.append(RangeQuery.complete(lo, up))
    return ds, queries


@pytest.fixture(scope="module", params=["gmrqb", "synt_uni"])
def engines(request):
    """(port engine, reference engine, host cols, port queries); both with
    the reference's default four structures."""
    ds, queries = _dataset(request.param)
    port = MDRQEngine(ds, tile_n=TILE_N, device="cpu")
    ref = JEngine(JT.Dataset(ds.cols), tile_n=TILE_N)
    return port, ref, ds.cols, queries


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


# -- builds --------------------------------------------------------------------

@pytest.mark.parametrize("which", ["gmrqb", "synt_uni"])
@pytest.mark.parametrize("name", ["kdtree", "rstar"])
def test_tree_builds_match_reference(which, name):
    ds, _ = _dataset(which)
    build, jbuild = {"kdtree": (build_kdtree, jbuild_kdtree),
                     "rstar": (build_rstar, jbuild_rstar)}[name]
    got = build(ds, tile_n=TILE_N, device="cpu")
    want = jbuild(JT.Dataset(ds.cols), tile_n=TILE_N)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.data_dev.numpy().view(np.uint32),
                                  np.asarray(want.data_dev).view(np.uint32))
    assert len(got.levels_lo) == len(want.levels_lo)
    for g, w in zip(got.levels_lo + got.levels_hi, want.levels_lo + want.levels_hi):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.nbytes_index == want.nbytes_index


@pytest.mark.parametrize("which", ["gmrqb", "synt_uni"])
def test_vafile_build_matches_reference(which):
    ds, _ = _dataset(which)
    got = build_vafile(ds, tile_n=TILE_N, data_dev=_t(
        ops.prepare_columnar(ds.cols, tile_n=TILE_N)[0]))
    want = jbuild_vafile(JT.Dataset(ds.cols), tile_n=TILE_N)
    np.testing.assert_array_equal(got.packed_dev.numpy(),
                                  np.asarray(want.packed_dev))
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    assert got.boundaries.dtype == want.boundaries.dtype == np.float32
    np.testing.assert_array_equal(got.data_dev.numpy(), np.asarray(want.data_dev))
    batch = QueryBatch.from_queries(_dataset(which)[1])
    for g, w in zip(got.query_cells_batch(batch, 64),
                    want.query_cells_batch(JT.QueryBatch(batch.lower,
                                                         batch.upper), 64)):
        np.testing.assert_array_equal(g, w)


def test_engine_vafile_shares_scan_storage(engines):
    """The VA-file refines in storage order against the scan's device copy
    (no second copy of the data); a copy of another shape is refused."""
    port = engines[0]
    assert port.vafile.data_dev is port.columnar.data_dev
    with pytest.raises(ValueError, match="padded"):
        build_vafile(port.dataset, tile_n=TILE_N,
                     data_dev=port.columnar.data_dev[:, :TILE_N])


def test_va_constants_have_one_source():
    from repro_torch.core import planner, vafile
    assert planner.VA_CELLS is vafile.CELLS == 1 << va_filter.BITS_PER_DIM
    assert planner.VA_DIMS_PER_WORD is va_filter.DIMS_PER_WORD == jva.DIMS_PER_WORD


def test_pack_codes_matches_reference():
    codes = np.random.default_rng(0).integers(0, 4, size=(37, 300)).astype(np.uint8)
    np.testing.assert_array_equal(va_filter.pack_codes(codes),
                                  jva.pack_codes(codes))


# -- the plain kernel versions against the Pallas kernels --------------------------

def _blocks_case(m, n_q, n_visit, seed):
    """Columnar data padded to tile_n=512, (m_pad, Q) bounds around real
    records, and a visit list of n_visit pairs (not a power of two) whose
    tail is padding (query 0, block -1)."""
    rng = np.random.default_rng(seed)
    cols = rng.random((m, 3000), dtype=np.float32)
    padded, _, _ = ops.prepare_columnar(cols, tile_n=TILE_N)
    lo = np.full((padded.shape[0], n_q), -3e38, np.float32)
    up = np.full((padded.shape[0], n_q), 3e38, np.float32)
    for q in range(n_q):
        a, b = cols[:, rng.integers(3000)], cols[:, rng.integers(3000)]
        lo[:m, q] = np.minimum(a, b) - 0.3
        up[:m, q] = np.maximum(a, b) + 0.3
    n_blocks = padded.shape[1] // TILE_N
    qids = rng.integers(0, n_q, size=n_visit).astype(np.int32)
    bids = rng.integers(0, n_blocks, size=n_visit).astype(np.int32)
    qids[-3:], bids[-3:] = 0, -1
    return padded, lo, up, qids, bids


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("m,n_q,n_visit", [(5, 1, 7), (19, 33, 45), (19, 40, 97)])
def test_multi_scan_visit_matches_pallas(m, n_q, n_visit):
    padded, lo, up, qids, bids = _blocks_case(m, n_q, n_visit, seed=m + n_q)
    want = np.asarray(jms.multi_scan_visit(
        jnp.asarray(padded), jnp.asarray(qids), jnp.asarray(bids),
        jnp.asarray(lo), jnp.asarray(up), tile_n=TILE_N, interpret=True))
    got = multi_scan.multi_scan_visit(_t(padded), _t(qids), _t(bids), _t(lo),
                                      _t(up), tile_n=TILE_N)
    assert got.dtype == torch.int8 and got.shape == (n_visit, TILE_N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:-3].any() and not want[:-3].all()   # a real test


@pytest.mark.parametrize("m", [5, 19])
def test_range_scan_visit_matches_pallas(m):
    padded, lo, up, _, bids = _blocks_case(m, 1, 11, seed=m)
    want = np.asarray(jrs.range_scan_visit(
        jnp.asarray(padded), jnp.asarray(bids), jnp.asarray(lo),
        jnp.asarray(up), tile_n=TILE_N, interpret=True))
    got = range_scan.range_scan_visit(_t(padded), _t(bids), _t(lo), _t(up),
                                      tile_n=TILE_N)
    np.testing.assert_array_equal(got.numpy(), want)


def _va_case(m, n_q, seed):
    """Packed codes of random cells (m=19 -> two words, the second half
    empty) and (m_s, Q) cell bounds, some empty (lo > hi)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(m, 4096)).astype(np.uint8)
    packed = va_filter.pack_codes(codes)
    m_s = -(-m // 8) * 8
    lo = np.zeros((m_s, n_q), np.int32)
    hi = np.full((m_s, n_q), 3, np.int32)
    lo[:m] = rng.integers(0, 3, size=(m, n_q))
    hi[:m] = np.minimum(lo[:m] + rng.integers(0, 4, size=(m, n_q)), 3)
    hi[0, 0] = lo[0, 0] - 1 if n_q > 1 else hi[0, 0]  # one empty query
    # constrain only a few dims, so the masks are neither empty nor full
    wide = rng.random((m, n_q)) < 0.8
    lo[:m][wide], hi[:m][wide] = 0, 3
    return packed, lo, hi


@pytest.mark.parametrize("m,n_q", [(5, 1), (19, 3), (19, 33), (19, 40), (37, 8)])
def test_multi_va_filter_matches_pallas(m, n_q):
    packed, lo, hi = _va_case(m, n_q, seed=m * n_q)
    want = np.asarray(jva.multi_va_filter_packed(
        jnp.asarray(packed), jnp.asarray(lo), jnp.asarray(hi), m,
        tile_n=TILE_N, interpret=True))
    got = va_filter.multi_va_filter_packed(_t(packed), _t(lo), _t(hi), m)
    assert got.dtype == torch.int8 and got.shape == (n_q, packed.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("m", [5, 19])
def test_va_filter_matches_pallas(m):
    packed, lo, hi = _va_case(m, 1, seed=m)
    want = np.asarray(jva.va_filter_packed(
        jnp.asarray(packed), jnp.asarray(lo), jnp.asarray(hi), m,
        tile_n=TILE_N, interpret=True))
    got = va_filter.va_filter_packed(_t(packed), _t(lo), _t(hi), m)
    assert got.shape == (packed.shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_visit_refs_match_reference_refs():
    """ref.py's new plain versions against the reference's jnp oracles."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    padded, lo, up, qids, bids = _blocks_case(19, 9, 30, seed=2)
    blocks = padded.reshape(padded.shape[0], -1, TILE_N).transpose(1, 0, 2)
    np.testing.assert_array_equal(
        ref.multi_scan_blocks_ref(_t(blocks), _t(qids), _t(bids), _t(lo),
                                  _t(up)).numpy(),
        np.asarray(jref.multi_scan_blocks_ref(jnp.asarray(blocks),
                                              jnp.asarray(qids),
                                              jnp.asarray(bids),
                                              jnp.asarray(lo),
                                              jnp.asarray(up))))
    packed, clo, chi = _va_case(19, 6, seed=3)
    np.testing.assert_array_equal(
        ref.multi_va_filter_packed_ref(_t(packed), _t(clo), _t(chi), 19).numpy(),
        np.asarray(jref.multi_va_filter_packed_ref(
            jnp.asarray(packed), jnp.asarray(clo), jnp.asarray(chi), 19)))
    np.testing.assert_array_equal(
        ref.va_filter_packed_ref(_t(packed), _t(clo[:, 1]), _t(chi[:, 1]),
                                 19).numpy(),
        np.asarray(jref.va_filter_packed_ref(
            jnp.asarray(packed), jnp.asarray(clo[:, 1]), jnp.asarray(chi[:, 1]),
            19)))


def test_cpu_visit_wrappers_launch_no_kernel():
    padded, lo, up, qids, bids = _blocks_case(5, 2, 9, seed=1)
    multi_scan.multi_scan_visit(_t(padded), _t(qids), _t(bids), _t(lo), _t(up),
                                tile_n=TILE_N)
    packed, clo, chi = _va_case(5, 2, seed=1)
    va_filter.multi_va_filter_packed(_t(packed), _t(clo), _t(chi), 5)
    assert ops.kernel_launches() == {}


# -- the engine's two-phase paths ----------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("method", METHODS)
def test_query_batch_matches_reference(engines, method, spec):
    port, ref, _, queries = engines
    jops.reset_counters()
    want = ref.query_batch([_jq(q) for q in queries], method=method,
                           spec=_jspec(spec))
    want_counts = jops.counters()
    got = port.query_batch(queries, method=method, spec=spec)
    _assert_same(spec, got, want)
    assert ops.counters() == want_counts
    assert getattr(port, method).last_visited_blocks \
        == getattr(ref, method).last_visited_blocks > 0
    # the path's budget: 1 prune or filter + 1 fused visit launch, 2 syncs
    assert ops.counter("multi_visit_reduce") == 1
    assert ops.counter("host_sync") == 2


@pytest.mark.parametrize("method", METHODS)
def test_single_queries_match_reference(engines, method):
    port, ref, _, queries = engines
    jops.reset_counters()
    for q in queries[:8]:
        np.testing.assert_array_equal(port.query(q, method=method),
                                      ref.query(_jq(q), method=method))
        assert port.query(q, method=method, spec=Count()) \
            == ref.query(_jq(q), method=method, spec=JT.Count())
        assert getattr(port, method).last_visited_blocks \
            == getattr(ref, method).last_visited_blocks
    assert ops.counters() == jops.counters()
    if method == "vafile":
        assert port.vafile.last_candidate_frac == ref.vafile.last_candidate_frac


@pytest.mark.parametrize("changed,routed", [({"sec_per_cmp": 1e-10}, "kdtree"),
                                            ({"sec_per_byte": 1e-9}, "vafile")])
def test_auto_routes_to_two_phase_paths_like_reference(engines, changed, routed):
    """Model constants that send buckets to the two-phase paths, set alike on
    both planners: the same plans, results and counters. (On SYNT-UNI the
    VA-file constants still plan only scans; the plans must agree all the
    same.)"""
    port, ref, cols, queries = engines
    saved = {k: getattr(port.planner.model, k) for k in changed}
    for model in (port.planner.model, ref.planner.model):
        for k, v in changed.items():
            setattr(model, k, v)
    try:
        for spec in (Ids(), TopK(k=10, dim=1), Agg("sum", 2)):
            jops.reset_counters()
            ops.reset_counters()
            want = ref.query_batch([_jq(q) for q in queries], spec=_jspec(spec))
            want_counts = jops.counters()
            got = port.query_batch(queries, spec=spec)
            assert port.last_batch_stats.methods == ref.last_batch_stats.methods
            _assert_same(spec, got, want)
            assert ops.counters() == want_counts
        if routed == "kdtree" or cols.shape[0] == 19:   # GMRQB: m = 19
            assert routed in port.last_batch_stats.method_counts
    finally:
        for model in (port.planner.model, ref.planner.model):
            for k, v in saved.items():
                setattr(model, k, v)


@pytest.mark.parametrize("method", METHODS)
def test_launch_split_matches_query_batch(engines, method):
    port, _, _, queries = engines
    spec = TopK(k=3, dim=0)
    want = port.query_batch(queries, method=method, spec=spec)
    ops.reset_counters()
    pending = port.launch_batch(queries, method=method, spec=spec)
    assert ops.counter("host_sync") == 1   # the survivors' shape-deciding sync
    got = pending.finalize()
    _assert_same(spec, got, want)
    assert ops.counter("host_sync") == 2


@pytest.mark.parametrize("method", METHODS)
def test_empty_visit_list_costs_one_launch_and_one_sync(engines, method):
    """A batch that prunes (or filters) to nothing: no visit launch, and the
    results are the spec's empty results — in both packages."""
    port, ref, cols, _ = engines
    # inverted bounds: no MBR overlaps, and every dim's cell range is empty
    q = RangeQuery.complete(cols.max(axis=1) + 1.0, cols.min(axis=1) - 1.0)
    for spec in (Ids(), Count(), TopK(k=2, dim=0), Agg("min", 1)):
        jops.reset_counters()
        ops.reset_counters()
        want = ref.query_batch([_jq(q)] * 3, method=method, spec=_jspec(spec))
        got = port.query_batch([q] * 3, method=method, spec=spec)
        _assert_same(spec, got, want)
        assert ops.counters() == jops.counters()
        assert ops.counter("host_sync") == 1
        assert sum(ops.counters().values()) == 2
        assert getattr(port, method).last_visited_blocks == 0
    assert port.query(q, method=method).size == 0
    assert port.query(q, method=method, spec=Count()) == 0


def test_tree_topk_ties_follow_leaf_order(engines):
    """The tie rule the reference's two-stage top-k implies on the trees:
    equal keys order by ascending permuted position (``inv_perm[id]``), not
    by id — checked against numpy on the categorical GMRQB dim 4."""
    port, _, cols, queries = engines
    spec = TopK(k=10, dim=4 if cols.shape[0] > 4 else 0, largest=False)
    for method in ("kdtree", "rstar"):
        perm = getattr(port, method).perm
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        got = port.query_batch(queries, method=method, spec=spec)
        by_id = 0
        for q, g in zip(queries, got):
            ids = port.query(q, method="scan")
            vals = cols[spec.dim, ids]
            want = ids[np.lexsort((inv[ids], vals))][: spec.k]
            np.testing.assert_array_equal(g, want)
            by_id += not np.array_equal(g, spec.from_ids(ids, cols))
        if cols.shape[0] == 19:   # GMRQB: the categorical dim has ties
            assert by_id > 0      # ... and there the id order differs


def test_device_arrays_are_row_major(engines):
    """The kernels take row-major rows: a column-permuted build must not
    leave its padded copy column-major."""
    port = engines[0]
    for t in (port.kdtree.data_dev, port.rstar.data_dev, port.vafile.data_dev,
              port.vafile.packed_dev, port.columnar.data_dev):
        assert t.is_contiguous()
    assert set(port.build_seconds) == {"scan", "kdtree", "rstar", "vafile"}


def test_visit_reduce_refuses_a_delta():
    """The visit op no longer refuses a delta: with the delta block and the
    base tombstones it returns (base payload, delta payload) from one
    counted op — the base with the tombstoned objects folded out, the delta
    half the full scan's reduce of the delta block."""
    padded, lo, up, qids, bids = _blocks_case(5, 2, 9, seed=4)
    args = (_t(padded), _t(qids), _t(bids), _t((bids >= 0).astype(np.int32)),
            torch.zeros((1, 1), dtype=torch.int32), _t(lo), _t(up))
    counts = ops.multi_visit_reduce(*args, spec=Count(), tile_n=TILE_N,
                                    n_queries=2)
    assert counts.shape == (2,)
    tomb = torch.ones((padded.shape[1],), dtype=torch.int8)
    base, delta = ops.multi_visit_reduce(*args, _t(padded), tomb, spec=Count(),
                                         tile_n=TILE_N, n_queries=2)
    assert base.tolist() == [0, 0]            # every base object tombstoned
    assert torch.equal(delta, ops.multi_scan_reduce(_t(padded), _t(lo), _t(up),
                                                    spec=Count(),
                                                    tile_n=TILE_N))
    assert ops.counter("multi_visit_reduce") == 2
