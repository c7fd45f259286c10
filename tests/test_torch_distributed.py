"""The port's horizontal partitioning against the reference's, on the CPU.

``repro_torch.core.distributed`` (a ``DataMesh`` listing the CPU once, or
eight times: eight shards that run the partition and merge code D devices
run) against ``repro.core.distributed`` (Pallas kernels in interpret mode):

  * in this process, the reference's ``DistributedScan`` and meshed engine
    on its one CPU device against the port's at D = 1 and D = 8, under Ids,
    Mask, Count, TopK (k = 5, dim 1, largest and smallest) and Agg
    sum/min/max, frozen and under a delta (appended rows, tombstones in
    several shards);
  * in a subprocess, the reference at eight forced host devices (the setup
    of ``tests/test_distributed_batched.py``'s subprocess: 5 x 40,000
    random and 20,000-row GMRQB), frozen and under a delta; its results
    come back through an ``.npz`` and the port's D = 8 must equal them;
  * a tie-heavy TopK (values rounded to 0.1) whose ties straddle shard
    boundaries, against the numpy oracle (ties by ascending id);
  * budgets: one counted op and one host sync per batch and per single;
  * the meshed engine: scan buckets on the sharded path, no unsharded copy
    unless a path that needs it is named, the synchronous and pipelined
    servers unchanged on it, ``compact()`` keeping the mesh;
  * ``make_data_mesh`` refusing more devices than are present.

Tolerances: ids, counts, masks and TopK (order included) and min/max
exactly equal; sums within rtol 1e-5 (float32 sums in another order: the
shards' partials add in shard order); a repeated sum bit-identical.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.core.distributed import DistributedScan as JDistributedScan
from repro.core.distributed import make_data_mesh as j_make_data_mesh
from repro_torch import obs
from repro_torch.core import (Agg, Count, DataMesh, Dataset, DistributedScan,
                              Ids, MDRQEngine, Mask, QueryBatch, RangeQuery,
                              TopK, make_data_mesh, match_ids_np)
from repro_torch.core import distributed as dist_mod
from repro_torch.data import gmrqb
from repro_torch.kernels import ops
from repro_torch.serve import MDRQServer, serve_pipelined

TILE_N = 512
SUM_RTOL = 1e-5
TIMEOUT = 60.0
SPECS = [Ids(), Mask(), Count(), TopK(k=5, dim=1),
         TopK(k=5, dim=1, largest=False), Agg("sum", 0), Agg("min", 2),
         Agg("max", 1)]
SHARDS = (1, 8)


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    obs.registry().reset()
    yield


def _jspec(spec):
    return getattr(JT, type(spec).__name__)(
        **{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})


def _jq(q):
    return JT.RangeQuery(q.lower, q.upper)


def _mesh(d):
    return DataMesh(["cpu"] * d)


def _assert_same(spec, got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        elif spec.kind == "agg" and spec.op == "sum":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
        elif spec.kind == "agg":
            assert (np.isnan(g) and np.isnan(w)) or g == w, (g, w)
        else:
            assert g == w and isinstance(g, int)


def _random_queries(cols, rng, n_q):
    """Record-anchored complete matches + a partial, a point and a
    match-all query (the reference's distributed test mix)."""
    m, n = cols.shape
    out = []
    for _ in range(n_q):
        a, b = cols[:, rng.integers(n)], cols[:, rng.integers(n)]
        out.append(RangeQuery.complete(np.minimum(a, b), np.maximum(a, b)))
    out.append(RangeQuery.partial(m, {1: (0.2, 0.6)}))
    rec = cols[:, rng.integers(n)]
    out.append(RangeQuery.complete(rec, rec))
    out.append(RangeQuery.partial(m, {}))
    return out


def _uni_data():
    rng = np.random.default_rng(7)
    ds = Dataset(rng.random((5, 40_000), dtype=np.float32))
    return ds, _random_queries(ds.cols, rng, 6)


def _gmrqb_data():
    ds = gmrqb.build(20_000, seed=3)
    grng = np.random.default_rng(9)
    return ds, [gmrqb.template(k, grng, ds) for k in (1, 4, 5, 7, 8)]


def _writes(ds, seed):
    """Appended rows and ids to delete: base ids spread over every shard of
    an eight-shard mesh, and two of the new rows."""
    rng = np.random.default_rng(seed)
    rows = rng.random((300, ds.m), dtype=np.float32) \
        * (ds.cols.max(axis=1) - ds.cols.min(axis=1)) + ds.cols.min(axis=1)
    dead = np.concatenate([rng.choice(ds.n, 400, replace=False),
                           ds.n + np.array([3, 250])])
    return rows.astype(np.float32), dead


@pytest.fixture(scope="module")
def uni():
    return _uni_data()


@pytest.fixture(scope="module")
def ref_uni(uni):
    ds, _ = uni
    return JDistributedScan(JT.Dataset(ds.cols), mesh=j_make_data_mesh(),
                            tile_n=TILE_N)


# -- against the reference on its one device -----------------------------------

@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_distributed_scan_matches_reference(uni, ref_uni, d, spec):
    """The port's DistributedScan at D shards equals the reference's, one
    counted op and one host sync per batch."""
    ds, queries = uni
    dsc = DistributedScan(ds, mesh=_mesh(d), tile_n=TILE_N)
    assert dsc.n_local * d == dsc.n_pad and dsc.n_local % TILE_N == 0
    want = ref_uni.query_batch(JT.QueryBatch.from_queries(
        [_jq(q) for q in queries]), spec=_jspec(spec))
    ops.reset_counters()
    got = dsc.query_batch(QueryBatch.from_queries(queries), spec=spec)
    assert ops.counters() == {"distributed_multi_reduce": 1, "host_sync": 1}
    _assert_same(spec, got, want)


@pytest.mark.parametrize("d", SHARDS)
def test_distributed_singles_and_masks_match_reference(uni, ref_uni, d):
    """``mask`` / ``query`` / ``count`` and ``mask_batch`` /
    ``count_batch``: the reference's results, one op + one sync each."""
    ds, queries = uni
    dsc = DistributedScan(ds, mesh=_mesh(d), tile_n=TILE_N)
    for q in queries:
        ops.reset_counters()
        ids = dsc.query(q)
        assert ops.counters() == {"distributed_mask": 1, "host_sync": 1}
        np.testing.assert_array_equal(ids, ref_uni.query(_jq(q)))
        ops.reset_counters()
        assert dsc.count(q) == ref_uni.count(_jq(q)) == ids.size
        assert ops.counters() == {"distributed_count": 1, "host_sync": 1}
    jb = JT.QueryBatch.from_queries([_jq(q) for q in queries])
    ops.reset_counters()
    np.testing.assert_array_equal(dsc.mask_batch(queries),
                                  ref_uni.mask_batch(jb))
    assert dsc.count_batch(queries) == ref_uni.count_batch(jb)
    assert ops.counters() == {"distributed_multi_mask": 1,
                              "distributed_multi_counts": 1, "host_sync": 2}


@pytest.fixture(scope="module")
def ref_delta_engine(uni):
    """The reference's meshed engine (one device) under appends and deletes."""
    ds, _ = uni
    eng = JEngine(JT.Dataset(ds.cols), structures=("scan",), tile_n=TILE_N,
                  mesh=j_make_data_mesh())
    rows, dead = _writes(ds, 1)
    eng.append(rows)
    eng.delete(dead)
    return eng


@pytest.fixture(scope="module")
def port_delta_engines(uni):
    ds, _ = uni
    rows, dead = _writes(ds, 1)
    out = {}
    for d in SHARDS:
        eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                         mesh=_mesh(d))
        eng.append(rows)
        eng.delete(dead)
        out[d] = eng
    return out


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_meshed_engine_under_delta_matches_reference(
        uni, ref_delta_engine, port_delta_engines, d, spec):
    """Appended rows and tombstones in several shards: the reference's
    meshed engine's results, still one op + one sync per batch."""
    _, queries = uni
    eng = port_delta_engines[d]
    n_local = eng.dist.n_local
    dead = np.nonzero(eng.delta.snapshot().base_tomb)[0]
    assert np.unique(dead // n_local).size == d  # every shard has some
    want = ref_delta_engine.query_batch([_jq(q) for q in queries],
                                        method="scan", spec=_jspec(spec))
    ops.reset_counters()
    got = eng.query_batch(queries, method="scan", spec=spec)
    assert ops.counters() == {"distributed_multi_reduce": 1, "host_sync": 1}
    _assert_same(spec, got, want)
    # singles ride the delta-aware batch rung at Q = 1
    q = queries[0]
    _assert_same(spec, [eng.query(q, "scan", spec=spec)],
                 [ref_delta_engine.query(_jq(q), "scan", spec=_jspec(spec))])


def test_tombstone_shards_are_cached_per_shard_index(port_delta_engines):
    """Shards on one device each get their own slice of the tombstone
    vector (the device alone is no key), built once per version."""
    eng = port_delta_engines[8]
    view = eng.delta.snapshot()
    dsc = eng.dist
    parts = [view.base_tomb_dev(dsc.n_pad, "cpu", shard=(s, dsc.n_local))
             for s in range(8)]
    full = np.zeros(dsc.n_pad, np.int8)
    full[: view.n_base] = view.base_tomb
    np.testing.assert_array_equal(torch.cat(parts).numpy(), full)
    again = view.base_tomb_dev(dsc.n_pad, "cpu", shard=(3, dsc.n_local))
    assert again is parts[3]


# -- against the reference at eight forced host devices ------------------------

REF8_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from repro.core import (Agg, Count, Dataset, DistributedScan, Ids, Mask,
                            MDRQEngine, QueryBatch, RangeQuery, TopK)
    from repro.core.distributed import make_data_mesh
    from repro.kernels import ops

    assert len(jax.devices()) == 8
    inp = np.load(sys.argv[1])
    mesh = make_data_mesh(8)
    specs = [Ids(), Mask(), Count(), TopK(k=5, dim=1),
             TopK(k=5, dim=1, largest=False), Agg("sum", 0), Agg("min", 2),
             Agg("max", 1)]
    out = {}

    def record(tag, res, spec):
        for k, r in enumerate(res):
            out[f"{tag}/{spec}/{k}"] = np.asarray(r)

    for tag in ("uni", "gmrqb"):
        cols = inp[f"{tag}_cols"]
        qs = [RangeQuery(lo, up) for lo, up in
              zip(inp[f"{tag}_lower"], inp[f"{tag}_upper"])]
        dsc = DistributedScan(Dataset(cols), mesh=mesh, tile_n=512)
        for spec in specs:
            ops.reset_counters()
            res = dsc.query_batch(QueryBatch.from_queries(qs), spec=spec)
            assert ops.counter("distributed_multi_reduce") == 1
            assert ops.counter("host_sync") == 1
            record(tag, res, spec)
        eng = MDRQEngine(Dataset(cols), structures=("scan",), tile_n=512,
                         mesh=mesh)
        assert eng.planner.model.n_devices == 8
        eng.append(inp[f"{tag}_rows"])
        eng.delete(inp[f"{tag}_dead"])
        for spec in specs:
            record(tag + "_delta",
                   eng.query_batch(qs, method="scan", spec=spec), spec)
    np.savez(sys.argv[2], **out)
    print("REF8_OK")
""")


@pytest.fixture(scope="module")
def ref8_results(tmp_path_factory, uni):
    """The reference's results at eight forced host devices."""
    tmp = tmp_path_factory.mktemp("ref8")
    inputs = {}
    for tag, (ds, qs) in (("uni", uni), ("gmrqb", _gmrqb_data())):
        batch = QueryBatch.from_queries(qs)
        rows, dead = _writes(ds, 2)
        inputs.update({f"{tag}_cols": ds.cols, f"{tag}_lower": batch.lower,
                       f"{tag}_upper": batch.upper, f"{tag}_rows": rows,
                       f"{tag}_dead": dead})
    np.savez(tmp / "in.npz", **inputs)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", REF8_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, timeout=600,
        env=env, cwd=root)
    assert "REF8_OK" in r.stdout, f"stdout={r.stdout}\nstderr={r.stderr[-3000:]}"
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("delta", [False, True], ids=["frozen", "delta"])
@pytest.mark.parametrize("tag", ["uni", "gmrqb"])
def test_eight_shards_match_reference_at_eight_devices(
        ref8_results, uni, tag, delta):
    ds, queries = uni if tag == "uni" else _gmrqb_data()
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=_mesh(8))
    assert eng.planner.model.n_devices == 8
    if delta:
        rows, dead = _writes(ds, 2)
        eng.append(rows)
        eng.delete(dead)
    key = tag + ("_delta" if delta else "")
    for spec in SPECS:
        ops.reset_counters()
        got = eng.query_batch(queries, method="scan", spec=spec)
        assert ops.counters() == {"distributed_multi_reduce": 1,
                                  "host_sync": 1}
        want = [ref8_results[f"{key}/{spec}/{k}"]
                for k in range(len(queries))]
        if spec.kind in ("count", "agg"):
            want = [int(w) if spec.kind == "count" else float(w)
                    for w in want]
        _assert_same(spec, got, want)


# -- TopK ties across shard boundaries -----------------------------------------

def _tie_data():
    """Values rounded to 0.1; dim 1 holds its two extremes (2.0 and -1.0)
    in runs that cross the first shard boundaries of an eight-shard mesh
    (n_local = 5,120 at tile_n = 512)."""
    rng = np.random.default_rng(11)
    cols = np.round(rng.random((4, 40_000)), 1).astype(np.float32)
    n_local = 5_120
    for b in (1, 2, 5):
        cols[1, b * n_local - 2: b * n_local + 2] = 2.0
        cols[1, b * n_local + 10: b * n_local + 12] = -1.0
    return Dataset(cols)


def _oracle_topk(cols, ids, spec):
    vals = cols[spec.dim, ids]
    order = np.lexsort((ids, -vals if spec.largest else vals))
    return ids[order[: spec.k]].astype(np.int64)


@pytest.mark.parametrize("spec", [TopK(k=5, dim=1), TopK(k=9, dim=1),
                                  TopK(k=64, dim=1),
                                  TopK(k=5, dim=1, largest=False),
                                  TopK(k=40, dim=3, largest=False)], ids=str)
def test_topk_ties_straddling_shards(spec):
    ds = _tie_data()
    m = ds.m
    queries = [RangeQuery.partial(m, {}),
               RangeQuery.partial(m, {0: (0.0, 0.0)}),
               RangeQuery.partial(m, {0: (0.5, 0.5), 2: (0.1, 0.3)}),
               RangeQuery.partial(m, {0: (0.3, 0.3), 3: (0.0, 0.0)})]
    single = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                        device="cpu").query_batch(queries, method="scan",
                                                  spec=spec)
    ref = JDistributedScan(JT.Dataset(ds.cols), mesh=j_make_data_mesh(),
                           tile_n=TILE_N).query_batch(
        JT.QueryBatch.from_queries([_jq(q) for q in queries]),
        spec=_jspec(spec))
    for d in SHARDS:
        eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                         mesh=_mesh(d))
        got = eng.query_batch(queries, method="scan", spec=spec)
        _assert_same(spec, got, single)
        _assert_same(spec, got, ref)
        for q, g in zip(queries, got):
            np.testing.assert_array_equal(
                g, _oracle_topk(ds.cols, match_ids_np(ds.cols, q), spec))
    if spec.dim == 1:   # the planted runs: the top ids cross boundaries
        assert np.unique(single[0] // 5_120).size > 1


def test_merge_cuts_fill_lanes_by_count():
    """A shard with fewer than k matches contributes fill lanes: its count
    cuts them, whatever value a lane carries."""
    from repro_torch.kernels import reducers
    i32 = torch.int32
    parts = [
        # shard 0: one match; lanes 1-2 are past its count (a fill lane
        # carries -inf; these carry 0.95 to show the cut alone drops them)
        (torch.tensor([[0.5, 0.95, 0.95]]), torch.tensor([[7, 0, 1]], dtype=i32),
         torch.tensor([1], dtype=i32)),
        # shard 1 (positions offset by n_local = 10): three matches
        (torch.tensor([[0.9, 0.5, 0.1]]), torch.tensor([[2, 0, 4]], dtype=i32),
         torch.tensor([3], dtype=i32)),
    ]
    vals, pos, counts = reducers.merge_shard_topk(parts, 10, 3, True)
    assert counts.tolist() == [4]
    assert pos[0].tolist() == [12, 7, 10]      # 0.9, then the 0.5 tie by id
    assert vals[0].tolist() == pytest.approx([0.9, 0.5, 0.5])
    vals, pos, _ = reducers.merge_shard_topk(parts, 10, 3, False)
    assert pos[0].tolist() == [14, 7, 10]      # 0.1, then the 0.5 tie by id


def test_repeated_agg_sums_are_bit_identical(uni):
    ds, queries = uni
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=_mesh(8))
    first = eng.query_batch(queries, method="scan", spec=Agg("sum", 3))
    for _ in range(3):
        again = eng.query_batch(queries, method="scan", spec=Agg("sum", 3))
        assert [np.float32(a).tobytes() for a in again] == \
            [np.float32(f).tobytes() for f in first]


# -- the meshed engine -----------------------------------------------------------

def test_meshed_engine_routes_scan_buckets(uni):
    """``MDRQEngine(mesh=...)`` sends scan buckets through the sharded path
    and gives a plain engine's results; the cost model takes the mesh's
    size."""
    ds, queries = uni
    mesh = _mesh(8)
    eng_d = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=mesh)
    eng_s = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, device="cpu")
    assert eng_d.planner.model.n_devices == mesh.shape["data"] == 8
    assert eng_s.planner.model.n_devices == 1
    assert eng_d.device == torch.device("cpu") and eng_d.mesh is mesh
    ops.reset_counters()
    got = eng_d.query_batch(queries, method="scan")
    assert ops.counter("distributed_multi_reduce") == 1
    assert ops.counter("multi_scan_reduce") == 0
    _assert_same(Ids(), got, eng_s.query_batch(queries, method="scan"))
    counts = eng_d.query_batch(queries, method="scan", spec=Count())
    assert counts == [match_ids_np(ds.cols, q).size for q in queries]
    q = queries[0]
    ops.reset_counters()
    np.testing.assert_array_equal(eng_d.query(q, "scan"),
                                  match_ids_np(ds.cols, q))
    assert eng_d.query(q, "scan", spec=Count()) == \
        match_ids_np(ds.cols, q).size
    assert ops.counters() == {"distributed_mask": 1, "distributed_count": 1,
                              "host_sync": 2}


def test_meshed_engine_never_auto_builds_columnar_copy(uni):
    """"auto" plans only the sharded scan, so no unsharded copy appears;
    naming ``scan_vertical`` builds it."""
    ds, _ = uni
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=_mesh(8))
    assert eng.planner.available == ("scan",)
    assert eng._columnar is None
    q = RangeQuery.partial(ds.m, {1: (0.2, 0.6)})
    res = eng.query_batch([q], method="auto")
    np.testing.assert_array_equal(res[0], match_ids_np(ds.cols, q))
    assert eng._columnar is None
    np.testing.assert_array_equal(eng.query(q, method="scan_vertical"),
                                  match_ids_np(ds.cols, q))
    assert eng._columnar is not None
    assert "columnar" in eng.build_seconds


def test_server_unchanged_on_meshed_engine(uni):
    ds, queries = uni
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=_mesh(8))
    server = MDRQServer(eng, max_batch=4, max_wait_s=float("inf"),
                        method="scan")
    ops.reset_counters()
    results = server.serve_all(queries)
    # 9 queries at window 4 -> 3 flushes -> 3 sharded ops
    assert ops.counter("distributed_multi_reduce") == server.stats.n_batches \
        == 3
    for q, ids in zip(queries, results):
        np.testing.assert_array_equal(ids, match_ids_np(ds.cols, q))
    counts = MDRQServer(eng, max_batch=8, max_wait_s=float("inf"),
                        method="scan", spec=Count()).serve_all(queries)
    assert counts == [match_ids_np(ds.cols, q).size for q in queries]


@pytest.mark.parametrize("spec", [Ids(), Count(), TopK(k=5, dim=1)], ids=str)
def test_pipelined_server_on_meshed_engine(uni, spec):
    ds, queries = uni
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=_mesh(8))
    want = eng.query_batch(queries[:4], spec=spec) \
        + eng.query_batch(queries[4:8], spec=spec) \
        + eng.query_batch(queries[8:], spec=spec)
    ops.reset_counters()
    srv = serve_pipelined(eng, max_batch=4, spec=spec,
                          max_wait_s=float("inf"), latency_budget_s=1e9,
                          warmup=False)
    try:
        tickets = [srv.submit(q) for q in queries]
        srv.drain(TIMEOUT)
        got = [t.result(timeout=TIMEOUT) for t in tickets]
    finally:
        srv.close(timeout=TIMEOUT)
    _assert_same(spec, got, want)
    assert ops.counter("distributed_multi_reduce") == 3
    assert ops.counter("host_sync") == 3


def test_compact_keeps_the_mesh(uni):
    ds, queries = uni
    mesh = _mesh(8)
    eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N, mesh=mesh)
    rows, dead = _writes(ds, 3)
    eng.append(rows)
    eng.delete(dead)
    id_map = eng.compact()
    assert eng.version == 1 and eng.delta.d == 0
    assert eng.dist is not None and eng.dist.mesh == mesh
    assert eng._columnar is None and eng.planner.model.n_devices == 8
    live = np.concatenate([ds.cols, rows.T], axis=1)[:, id_map >= 0]
    assert eng.dataset.n == live.shape[1]
    for spec in (Ids(), Count(), TopK(k=5, dim=1), Agg("max", 1)):
        got = eng.query_batch(queries, method="scan", spec=spec)
        want = [spec.from_ids(match_ids_np(live, q), live) for q in queries]
        _assert_same(spec, got, want)


def test_engine_from_arrays_takes_a_mesh(uni):
    from repro_torch.core import engine_from_arrays
    ds, queries = uni
    eng = engine_from_arrays(ds.cols, tile_n=TILE_N, structures=("scan",),
                             mesh=_mesh(2))
    assert eng.dist.mesh.size == 2
    _assert_same(Count(), eng.query_batch(queries, spec=Count()),
                 [match_ids_np(ds.cols, q).size for q in queries])


# -- the mesh ---------------------------------------------------------------------

def test_make_data_mesh_refuses_absent_devices(monkeypatch):
    cpu = make_data_mesh(device="cpu")
    assert cpu.devices == (torch.device("cpu"),) and cpu.shape == {"data": 1}
    with pytest.raises(ValueError, match="present"):
        make_data_mesh(2, device="cpu")
    eight = make_data_mesh(device=["cpu"] * 8)   # explicit repeats only
    assert eight.size == 8 and eight.distinct == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        make_data_mesh(4, device=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_data_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MDRQEngine(Dataset(np.zeros((2, 8), np.float32)),
                       structures=("scan",), mesh=DataMesh(["cuda"]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedScan(Dataset(np.zeros((2, 8), np.float32)))
    # a machine with one card: two of them are refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = make_data_mesh()
    assert one.devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="1 present"):
        make_data_mesh(2)
    with pytest.raises(ValueError, match="not present"):
        DataMesh(["cuda:0", "cuda:1"])
    assert DataMesh(["cuda:0"] * 8).size == 8


def test_shard_columnar_places_padded_blocks_in_order():
    mesh = _mesh(4)
    cols = np.arange(2 * 3000, dtype=np.float32).reshape(2, 3000)
    padded, m, n = ops.prepare_columnar(cols, tile_n=TILE_N * 4)
    shards = dist_mod.shard_columnar(mesh, padded, tile_n=TILE_N)
    assert len(shards) == 4 and all(s.shape == (8, 1024) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), padded)
    assert torch.isinf(shards[-1][0, -1])   # the +inf sentinels: last shard
    with pytest.raises(ValueError):
        dist_mod.shard_columnar(mesh, padded[:, :3 * TILE_N], tile_n=TILE_N)
