"""The port's pipelined MDRQ server on the CPU.

``repro_torch.serve.PipelinedMDRQServer`` against the port's synchronous
``MDRQServer`` and the reference's ``repro.serve.MDRQServer`` (Pallas
kernels in interpret mode) on the same data (4 x 6,000, numpy seed 7) and
queries (the paper's random-pair generator): ids, counts and top-k (tie
order included) exactly equal. Then the behaviour tests of the reference's
``tests/test_serve_pipeline.py``, on the port: the warm set (the
counterpart of the reference's AOT cache), no new key after warmup, a
change of backend, the launch/sync budget per window, shedding and
recovery, finalizer-fault isolation, launch-failure requeue, wall-clock
stats, an in-flight window across ingest and compaction, and re-warming
after compaction. The reference's wall-clock race (pipelined faster than
synchronous on the CPU) is not ported: its counterpart is
``chip_smoke.py``'s pipeline phase on the card.

Every wait has a timeout and every server is closed by the ``pipelined``
fixture, so a hung finalizer fails its test instead of stalling the run.
"""
import dataclasses

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import MDRQEngine as JEngine
from repro.core import types as JT
from repro.serve import MDRQServer as JServer
from repro_torch import obs
from repro_torch.core import (Count, Dataset, Ids, MDRQEngine, TopK,
                              match_ids_np)
from repro_torch.core import engine as engine_mod
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.serve import (MDRQServer, Overloaded, PipelinedMDRQServer,
                               serve_pipelined)

TIMEOUT = 30.0
STRUCTURES = ("scan", "kdtree", "vafile")


@pytest.fixture(autouse=True)
def clean_ops():
    ops.reset_counters()
    ops.reset_kernel_launches()
    ops.clear_warm_keys()
    ops.reset_trace_log()
    obs.registry().reset()
    yield
    ops.clear_warm_keys()
    ops.reset_trace_log()


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(7)
    return Dataset(rng.random((4, 6_000), dtype=np.float32))


@pytest.fixture
def pipelined():
    """``make(engine, **kw)`` -> a pipelined server (no deadline flushes,
    no shedding unless asked), closed with a timeout at teardown."""
    made = []

    def make(engine, **kw):
        kw.setdefault("max_wait_s", float("inf"))
        kw.setdefault("latency_budget_s", 1e9)
        srv = serve_pipelined(engine, **kw)
        made.append(srv)
        return srv
    yield make
    for srv in made:
        srv.close(timeout=TIMEOUT)
        assert not srv._finalizer.is_alive()


def _queries(ds, n, seed=0):
    return synthetic.workload(ds, n, seed=seed)


def _engine(ds, structures=("scan",), **kw):
    return MDRQEngine(ds, structures=structures, tile_n=512, device="cpu",
                      **kw)


def _jspec(spec):
    if spec is None:
        return None
    return getattr(JT, type(spec).__name__)(
        **{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _serve(srv, qs):
    tickets = [srv.submit(q) for q in qs]
    srv.drain(TIMEOUT)
    return [t.result(timeout=TIMEOUT) for t in tickets]


# -- equivalence ---------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, Count(), TopK(k=3, dim=1)],
                         ids=["ids", "count", "topk"])
def test_pipelined_matches_sync_and_reference(ds, spec, pipelined):
    eng = _engine(ds, STRUCTURES)
    qs = _queries(ds, 30, seed=1)
    sync = MDRQServer(eng, max_batch=8, max_wait_s=float("inf"), spec=spec)
    expected = sync.serve_all(qs)
    srv = pipelined(eng, max_batch=8, spec=spec, warmup=False)
    got = _serve(srv, qs)
    _assert_same(got, expected)
    _assert_same(got, eng.query_batch(qs, spec=spec))
    assert srv.stats.method_counts == sync.stats.method_counts
    jeng = JEngine(JT.Dataset(ds.cols), structures=STRUCTURES, tile_n=512)
    jobs.registry().reset()
    want = JServer(jeng, max_batch=8, max_wait_s=float("inf"),
                   spec=_jspec(spec)).serve_all(
        [JT.RangeQuery(q.lower, q.upper) for q in qs])
    _assert_same(got, want)
    if spec is None:
        for g, q in zip(got, qs):
            np.testing.assert_array_equal(g, match_ids_np(ds.cols, q))


def test_pipelined_explicit_paths_match_oracle(ds, pipelined):
    eng = _engine(ds, STRUCTURES)
    qs = _queries(ds, 12, seed=2)
    for method in ("scan", "scan_vertical", "kdtree", "vafile"):
        srv = pipelined(eng, max_batch=4, method=method, warmup=False)
        for g, q in zip(_serve(srv, qs), qs):
            np.testing.assert_array_equal(g, match_ids_np(ds.cols, q))


def test_deprecated_mode_strings(ds, pipelined):
    eng = _engine(ds)
    with pytest.warns(DeprecationWarning, match="mode='count'"):
        srv = pipelined(eng, max_batch=4, mode="count", warmup=False)
    assert srv.spec == Count()
    with pytest.warns(DeprecationWarning):
        assert MDRQServer(eng, mode="ids").spec == Ids()
    with pytest.raises(ValueError, match="not both"):
        MDRQServer(eng, spec=Count(), mode="count")
    with pytest.raises(ValueError, match="unknown mode"):
        MDRQServer(eng, mode="topk")
    qs = _queries(ds, 4, seed=3)
    assert _serve(srv, qs) == [match_ids_np(ds.cols, q).size for q in qs]


# -- warm keys (the counterpart of the reference's AOT cache) ---------------

def test_warmup_runs_exactly_the_advertised_set(ds, pipelined):
    eng = _engine(ds)
    srv = pipelined(eng, max_batch=8, method="scan", warmup=True)
    rep = srv.last_warmup
    assert rep is not None
    assert rep.paths == ("scan",)
    assert rep.bucket_sizes == (1, 2, 4, 8)
    assert rep.n_runs == 4
    # the warm set was empty before construction (clean_ops): the
    # advertised key set IS the warm set
    assert set(rep.keys) == set(ops.warm_keys())
    assert len(rep.keys) > 0
    assert {k[0] for k in rep.keys} == {"multi_scan_reduce"}
    # idempotent: a second pass advertises the same set, adds nothing
    rep2 = srv.warmup()
    assert rep2.keys == ()
    assert rep2.bucket_sizes == rep.bucket_sizes


def test_auto_warmup_sweeps_every_plannable_path(ds, pipelined):
    eng = _engine(ds, STRUCTURES)
    srv = pipelined(eng, max_batch=4, warmup=True)
    rep = srv.last_warmup
    assert rep.paths == ("scan", "scan_vertical", "kdtree", "vafile")
    assert rep.dim_counts == (1, 2, 4)
    assert rep.n_runs == 3 * 3 + 3 * 3   # vertical: 3 dim counts
    ops_run = {k[0] for k in rep.keys}
    assert {"multi_scan_reduce", "multi_scan_vertical_reduce",
            "prune_hierarchy_batch", "multi_va_filter",
            "multi_visit_reduce"} <= ops_run


def test_no_new_key_after_warmup(ds, pipelined):
    """Post-warmup steady state finds every op key warm."""
    eng = _engine(ds)
    for method in ("scan", "scan_vertical"):
        srv = pipelined(eng, max_batch=8, method=method, spec=Count(),
                        warmup=True)
        ops.reset_trace_log()
        _serve(srv, _queries(ds, 25, seed=3))   # windows of 8, 8, 8, 1
        assert ops.trace_log() == ()


def test_cold_traffic_is_logged(ds, pipelined):
    eng = _engine(ds)
    srv = pipelined(eng, max_batch=8, method="scan", warmup=False)
    _serve(srv, _queries(ds, 9, seed=3))        # windows of 8 and 1
    assert [k[0] for k in ops.trace_log()] == ["multi_scan_reduce"] * 2


def test_backend_change_is_a_new_key_set(ds, pipelined):
    """The reference drops its AOT cache when the kernel backend changes;
    in the port the backend is an engine's, and it is part of every key: a
    server over a plain-backend engine is cold after another engine's
    warmup, and warm after its own."""
    pipelined(_engine(ds), max_batch=2, method="scan", warmup=True)
    plain = _engine(ds, backend="torch")
    srv = pipelined(plain, max_batch=2, method="scan", warmup=False)
    ops.reset_trace_log()
    _serve(srv, _queries(ds, 2, seed=4))
    assert ops.trace_log() != ()
    assert all(dict(k[2])["backend"] == "torch" for k in ops.trace_log())
    rep = srv.warmup()
    assert rep.keys and all(dict(k[2])["backend"] == "torch"
                            for k in rep.keys)
    ops.reset_trace_log()
    _serve(srv, _queries(ds, 2, seed=4))
    assert ops.trace_log() == ()


# -- launch / host-sync budgets under the split --------------------------------

@pytest.mark.parametrize("method,spec", [("scan", Ids()),
                                         ("auto", Count()),
                                         ("kdtree", Count())], ids=str)
def test_pipelined_budget_per_window(ds, method, spec, pipelined):
    """Each window costs what the synchronous server's flush costs."""
    eng = _engine(ds, STRUCTURES)
    qs = _queries(ds, 24, seed=4)
    sync = MDRQServer(eng, max_batch=8, max_wait_s=float("inf"),
                      method=method, spec=spec)
    ops.reset_counters()
    sync.serve_all(qs)
    want = ops.counters()
    srv = pipelined(eng, max_batch=8, method=method, spec=spec, warmup=True)
    ops.reset_counters()   # drop warmup traffic; count serving only
    _serve(srv, qs)        # three full windows of 8
    assert ops.counters() == want
    assert srv.stats.n_batches == 3
    if method == "scan":
        assert want == {"multi_scan_reduce": 3, "host_sync": 3}


# -- admission control -----------------------------------------------------------

def test_overloaded_shed_and_recovery(ds, pipelined):
    eng = _engine(ds)
    qs = _queries(ds, 8, seed=5)
    srv = pipelined(eng, max_batch=4, method="scan", warmup=False,
                    latency_budget_s=100.0)
    # cold start never sheds (EWMA unknown), even with a zero budget
    srv.latency_budget_s = 0.0
    t = srv.submit(qs[0])
    assert not t.shed
    srv.latency_budget_s = 100.0
    for q in qs[1:4]:
        srv.submit(q)          # window of 4 flushes (reason="size")
    srv.drain(TIMEOUT)         # EWMA now primed
    srv.latency_budget_s = 0.0
    shed = srv.submit(qs[4])
    assert shed.shed
    assert srv.n_pending == 0  # shed queries never enter the window
    with pytest.raises(Overloaded):
        shed.result(timeout=TIMEOUT)
    assert srv.stats.shed_counts == {"overloaded": 1}
    assert obs.registry().counter("mdrq_server_shed_total",
                                  reason="overloaded").value == 1
    # recovery: a sane budget admits again and serves correctly
    srv.latency_budget_s = 100.0
    ok = srv.submit(qs[5])
    srv.flush()
    np.testing.assert_array_equal(ok.result(timeout=TIMEOUT),
                                  match_ids_np(ds.cols, qs[5]))


# -- fault isolation -------------------------------------------------------------

def test_finalizer_fault_poisons_only_its_window(ds, monkeypatch, pipelined):
    eng = _engine(ds)
    qs = _queries(ds, 8, seed=6)
    orig = engine_mod.PendingBatch.finalize
    calls = []

    def flaky_finalize(self):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected finalize failure")
        return orig(self)

    monkeypatch.setattr(engine_mod.PendingBatch, "finalize", flaky_finalize)
    srv = pipelined(eng, max_batch=4, method="scan", warmup=False)
    first = [srv.submit(q) for q in qs[:4]]    # window 1: poisoned
    second = [srv.submit(q) for q in qs[4:]]   # window 2: healthy
    srv.drain(TIMEOUT)
    for t in first:
        with pytest.raises(RuntimeError, match="injected finalize"):
            t.result(timeout=TIMEOUT)
    for t, q in zip(second, qs[4:]):
        np.testing.assert_array_equal(t.result(timeout=TIMEOUT),
                                      match_ids_np(ds.cols, q))
    # the poisoned window contributed no stats; the healthy one did
    assert srv.stats.n_queries == 4
    assert srv.stats.n_batches == 1


def test_launch_failure_requeues_window_in_order(ds, pipelined):
    eng = _engine(ds)
    qs = _queries(ds, 3, seed=7)
    srv = pipelined(eng, max_batch=8, method="scan", warmup=False)
    tickets = [srv.submit(q) for q in qs]
    orig = eng.launch_batch

    def boom(*a, **k):
        raise RuntimeError("injected launch failure")

    eng.launch_batch = boom
    try:
        with pytest.raises(RuntimeError, match="injected launch"):
            srv.flush()
    finally:
        eng.launch_batch = orig
    # window restored in submission order, deadline clock re-anchored
    assert [t for _, t, _ in srv._pending] == tickets
    assert srv._oldest_t == srv._pending[0][2]
    srv.flush()
    srv.drain(TIMEOUT)
    for t, q in zip(tickets, qs):
        np.testing.assert_array_equal(t.result(timeout=TIMEOUT),
                                      match_ids_np(ds.cols, q))


# -- stats under overlap ---------------------------------------------------------

def test_stats_are_wall_clock_anchored(ds, pipelined):
    eng = _engine(ds)
    qs = _queries(ds, 20, seed=8)
    srv = pipelined(eng, max_batch=8, method="scan", warmup=False)
    srv.serve_all(qs)
    srv.drain(TIMEOUT)
    st = srv.stats
    assert st.n_queries == 20 and st.n_batches == 3
    assert st.wall_seconds > 0.0
    assert st.finalize_seconds > 0.0
    assert st.busy_seconds > 0.0
    assert st.flush_reasons == {"size": 2, "forced": 1}
    # qps divides by wall clock, not by the (overlapping) stage sum
    assert st.qps == pytest.approx(st.n_queries / st.wall_seconds)
    pct = st.latency_percentiles("ids")
    assert pct["queue"] and pct["execute"]
    # per-query execute latency is the device-stage wall, bounded by the
    # whole-window busy time (it excludes the finalize stage)
    assert pct["execute"]["p99"] <= st.busy_seconds
    # a fresh pass re-anchors the wall clock
    srv.reset_stats()
    assert srv.stats.wall_seconds == 0.0 and srv._wall_t0 is None
    # the synchronous server keeps qps over busy time
    sync = MDRQServer(eng, max_batch=8, method="scan")
    sync.serve_all(qs)
    assert sync.stats.wall_seconds == 0.0
    assert sync.stats.qps == pytest.approx(20 / sync.stats.busy_seconds)


# -- serve-while-ingest across the pipeline ----------------------------------------

def test_inflight_window_snapshot_survives_ingest_and_compact(ds, pipelined):
    eng = _engine(ds)
    qs = _queries(ds, 5, seed=9)
    rng = np.random.default_rng(10)
    new_rows = rng.random((64, ds.m), dtype=np.float32)
    srv = pipelined(eng, max_batch=8, method="scan", warmup=False)
    before = [srv.submit(q) for q in qs]
    srv.flush()                 # window launches against the pre-append
    srv.append(new_rows)        # snapshot while (possibly) in flight
    after = [srv.submit(q) for q in qs]
    srv.drain(TIMEOUT)
    for t, q in zip(before, qs):
        np.testing.assert_array_equal(t.result(timeout=TIMEOUT),
                                      match_ids_np(ds.cols, q))
    expected_after = eng.query_batch(qs, method="scan")
    for t, e in zip(after, expected_after):
        np.testing.assert_array_equal(t.result(timeout=TIMEOUT), e)
    # compact swaps the engine version; serving stays correct after
    srv.compact()
    assert eng.version == 1
    got = _serve(srv, qs)
    _assert_same(got, eng.query_batch(qs, method="scan"))


def test_compact_rewarms(ds, pipelined):
    eng = _engine(ds)
    srv = pipelined(eng, max_batch=2, method="scan", warmup=True)
    first = srv.last_warmup
    eng.append(np.random.default_rng(11).random(
        (2048, ds.m), dtype=np.float32))  # force a real shape change
    srv.compact()
    assert srv.last_warmup is not first   # warmup re-ran
    assert srv.last_warmup.keys           # on the new version's shapes
    ops.reset_trace_log()
    _serve(srv, _queries(ds, 4, seed=12))
    assert ops.trace_log() == ()


def test_closed_server_refuses_and_close_is_idempotent(ds):
    srv = PipelinedMDRQServer(_engine(ds), max_batch=2, warmup=False)
    srv.close(timeout=TIMEOUT)
    srv.close(timeout=TIMEOUT)
    assert not srv._finalizer.is_alive()
    assert srv.stream_scheme == "none"    # the CPU has no streams
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_queries(ds, 1)[0])


def test_op_counts_are_exact_across_threads():
    """The two serving threads bump the same counters: many threads, a
    short switch interval, and no lost update."""
    import sys
    import threading

    import torch
    mask = torch.ones((2, 8), dtype=torch.int8)
    n_threads, calls = 16, 500

    def work():
        for _ in range(calls):
            ops.device_get(ops.mask_counts(mask))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert ops.counters() == {"mask_counts": n_threads * calls,
                              "host_sync": n_threads * calls}
    assert len([k for k in ops.warm_keys() if k[0] == "mask_counts"]) == 1
