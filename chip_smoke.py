#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every result.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases, one status line each; any failed check raises and the script exits
non-zero without printing a result:

  1. device  — require CUDA (no fallback); print the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  3. data    — GMRQB, 10 M records x 19 attributes (seed 0); the engine under
               test and a second engine running the plain PyTorch versions
               (``backend="torch"``) on the same card, each with the
               reference's four structures — the columnar scan, the kd-tree,
               the STR R*-tree and the VA-file, each padded to
               (24, 10,000,384) float32 on the card (the trees permuted), plus
               the VA-file's packed codes — and the row-major scan
               (``rowscan=True``: (10,000,384, 24) float32). Each build's time
               is printed.
  4. kernels — each hand kernel against its plain version at the main paths'
               shapes (Q = 1 and Q = 128; the visit kernel at the visit list
               the kd-tree prunes the 128-query workload to; the row-major
               scan at Q = 1): masks exactly equal, aggregates within float32
               summation tolerance, repeated sums bit-identical; CUDA-event
               times of the kernel, its plain version and, where one exists,
               the one-call PyTorch equivalent.
  5. slice   — the main path: ``MDRQEngine.query_batch(method="auto")`` on the
               GMRQB mixed workload at B in {1, 8, 32, 128} under Ids, Count,
               Mask, two TopK and three Agg specs, plus ``engine.query`` singles.
               Every result equals the plain-backend engine's; a sample equals
               the numpy oracle; each bucket costs its path's budget (a scan
               bucket 1 fused launch + 1 host sync, a two-phase bucket 1 prune
               or filter + 1 fused visit launch + 2 host syncs); every kernel
               of the scan path was launched.
  6. index   — the two-phase paths: ``query_batch(method=m)`` for m in kdtree,
               rstar, vafile at B in {8, 128} under the same eight specs (Ids
               and Mask at B in {8, 32}: they are host-bound, and B=128 would
               take minutes), and ``engine.query`` singles (ids and Count) on
               each. The same checks, and every visit and VA-filter kernel was
               launched.
  7. server  — ``MDRQServer(max_batch=64).serve_all`` on 256 queries under
               Count, against ``query_batch``.
  8. rowscan — the row-major scan path: ``query_batch(method="rowscan")`` at
               B = 8 under the eight specs (one ``range_scan_rows`` launch and
               one host sync per query) and singles; the same checks, and
               ``range_scan_rows`` was launched.
  9. delta   — the mutable plane. Through ``MDRQServer.append``/``delete``
               on the engine under test (a query submitted before and after
               each call must see exactly the writes before it) and directly
               on the plain engine: 100,000 fresh GMRQB rows appended (seed 1,
               1% of the base), then 100,000 base ids and 10,000 of the new
               ids deleted (numpy seed 1). Every method at B = 128 and the
               row scan at B = 8, under the eight specs, against the plain
               engine, 16 queries against numpy over the live rows, each
               bucket at its frozen budget; warm qps of Count, Agg sum and
               TopK d3 per path, frozen and under the delta; the tombstone
               fold's time; ``compact()`` on both engines (id map, version 1,
               seconds, peak device memory), then the B = 128 checks again.

The last three lines are the kernel table (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 10_000_000
SEED = 0
TILE_N = 1024
BATCH_SIZES = (1, 8, 32, 128)
INDEX_METHODS = ("kdtree", "rstar", "vafile")
INDEX_BATCH_SIZES = (8, 128)
HOST_BOUND_BATCH_SIZES = (8, 32)   # Ids and Mask on the two-phase paths
DELTA_METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile", "auto")
ROWSCAN_BATCH = 8
DELTA_ROWS = 100_000      # appended: 1% of the base
DELTA_BASE_DEAD = 100_000
DELTA_NEW_DEAD = 10_000
TIMED_CALLS = 3           # warm query_batch calls per qps cell; median kept
ORACLE_SAMPLE = 16        # queries per (B, spec) checked against numpy
N_SINGLES = 8             # engine.query singles on the main path
SERVER_QUERIES = 256
TIMING_REPS = 10
# float32 sums taken in different orders (kernel tree vs torch vs numpy
# pairwise) over non-negative values: relative difference bound.
AGG_SUM_RTOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate outside
# the tensor cores, for the bound column. The VA filter's integer operations
# are counted against the float32 rate too (the data sheet states no int32
# rate outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def same_result(spec, a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape \
            and np.array_equal(a, b)
    if spec.kind == "agg":
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        if spec.op == "sum":
            return abs(a - b) <= AGG_SUM_RTOL * abs(b)
    return a == b


def expected_counts(eng, buckets, spec, delta: bool) -> dict[str, int]:
    """The budget of one ``query_batch`` over these buckets ({path: size}),
    as ``ops.counters()`` reports it — the same with or without a live delta
    (the delta scan rides each bucket's fused op): a scan bucket is 1 fused
    launch + 1 host sync; a two-phase bucket is 1 prune (filter) + its
    survivors' sync, then 1 fused visit launch + its payload's sync — unless
    nothing survived, when the visit launch and its sync are skipped (under
    a delta they become one delta-only scan and its sync); the row scan is
    one ``range_scan_rows`` + 1 host sync per query (+ 1 ``mask_counts``
    per query for a frozen Count)."""
    scan_ops = {"scan": "multi_scan_reduce",
                "scan_vertical": "multi_scan_vertical_reduce"}
    want: dict[str, int] = {}

    def add(name, k=1):
        want[name] = want.get(name, 0) + k
    for meth, size in buckets.items():
        if meth == "rowscan":
            add("range_scan_rows", size)
            add("host_sync", size)
            if spec.kind == "count" and not delta:
                add("mask_counts", size)
            continue
        add("host_sync")
        if meth in scan_ops:
            add(scan_ops[meth])
            continue
        add("multi_va_filter" if meth == "vafile" else "prune_hierarchy_batch")
        if getattr(eng, meth).last_visited_blocks:
            add("multi_visit_reduce")
            add("host_sync")
        elif delta:
            add("multi_scan_reduce")
            add("host_sync")
    return want


class Oracle:
    """Numpy ground truth: matching ids per query (cached), and each spec's
    result from them. On the trees, TopK orders equal values by leaf-order
    position (``inv_perm[id]``), as the reference does; elsewhere by id.

    Under a delta, ``cols`` holds the base columns with the delta rows
    appended, ``alive`` marks the rows not tombstoned and ``n_base`` where
    the delta starts: a tree's TopK is then the reference's merge — its base
    top k (leaf-order ties) and the delta's top k (id ties), re-ranked with
    ties by id."""

    def __init__(self, eng, cols, queries, alive=None, n_base=None):
        self.cols, self.queries = cols, queries
        self.alive, self.n_base = alive, n_base
        self._ids: dict[int, np.ndarray] = {}
        self._inv = {}
        for name in ("kdtree", "rstar"):
            perm = getattr(eng, name).perm
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            self._inv[name] = inv

    def ids(self, i: int) -> np.ndarray:
        from repro_torch.core import match_mask_np
        if i not in self._ids:
            mask = match_mask_np(self.cols, self.queries[i])
            if self.alive is not None:
                mask &= self.alive
            self._ids[i] = np.nonzero(mask)[0].astype(np.int64)
        return self._ids[i]

    def _topk(self, spec, ids, ties):
        vals = self.cols[spec.dim, ids]
        order = np.lexsort((ties, -vals if spec.largest else vals))
        return ids[order[: spec.k]].astype(np.int64)

    def result(self, spec, i: int, method: str):
        ids = self.ids(i)
        if spec.kind != "topk" or method not in self._inv:
            return spec.from_ids(ids, self.cols)
        inv = self._inv[method]
        if self.n_base is None:
            return self._topk(spec, ids, inv[ids])
        base, new = ids[ids < self.n_base], ids[ids >= self.n_base]
        cand = np.concatenate([self._topk(spec, base, inv[base]),
                               self._topk(spec, new, new)])
        return self._topk(spec, cand, cand)


def kernel_phase(eng, queries):
    """Hold each kernel against its plain version; measure all three times."""
    from repro_torch.core import QueryBatch
    from repro_torch.core.types import next_pow2
    from repro_torch.kernels import multi_scan, range_scan, ref, reducers

    data = eng.columnar.data_dev
    m_pad, n_pad = data.shape
    dev = data.device
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops, lib_ms):
        b, by = bound_ms(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                     "bound_by": by, "library_ms": lib_ms})
        print(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b:.4f} ({by}) library_ms={lib_ms}", flush=True)

    full = QueryBatch.from_queries(queries[:128])
    lo, up = (torch.as_tensor(a, device=dev)
              for a in full.bounds_columnar(m_pad, dtype=np.float32))
    partial = QueryBatch.from_queries(
        [q for q in queries[:128] if not q.is_complete_match])
    q_pad = next_pow2(len(partial))
    ids_np = partial.padded_dim_ids(q_pad)
    vlo, vup = (torch.as_tensor(a, device=dev)
                for a in partial.bounds_columnar(m_pad, q_pad, np.float32))
    ids = torch.as_tensor(ids_np, device=dev)
    print(f"  shapes: m_pad={m_pad} n_pad={n_pad} Q(scan)={full.lower.shape[0]} "
          f"Q(vertical)={q_pad} D_max={ids_np.shape[1]}", flush=True)

    # -- multi_scan_tiles: Q = 1 and Q = 128 --
    for q_n in (1, 128):
        got = multi_scan.multi_scan_tiles(data, lo[:, :q_n].contiguous(),
                                          up[:, :q_n].contiguous(), tile_n=TILE_N)
        want = ref.multi_scan_ref(data, lo[:, :q_n], up[:, :q_n])
        check(torch.equal(got, want), f"multi_scan_tiles Q={q_n} != plain")
    masks = multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N)
    q_n = masks.shape[0]
    row("multi_scan_tiles", "src/repro_torch/kernels/csrc/scan.cu",
        "src/repro/kernels/multi_scan.py:73", 0.0,
        time_ms(lambda: multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_ref(data, lo, up)),
        m_pad * n_pad * 4 + q_n * n_pad + 2 * m_pad * q_n * 4,
        2.0 * m_pad * q_n * n_pad, None)

    # -- multi_scan_vertical: Q = 1 and the main path's vertical bucket --
    one = multi_scan.multi_scan_vertical(data, ids[:1], vlo[:, :1].contiguous(),
                                         vup[:, :1].contiguous(), tile_n=TILE_N)
    check(torch.equal(one, ref.multi_scan_vertical_ref(data, ids[:1], vlo[:, :1],
                                                       vup[:, :1])),
          "multi_scan_vertical Q=1 != plain")
    got = multi_scan.multi_scan_vertical(data, ids, vlo, vup, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_vertical_ref(data, ids, vlo, vup)),
          f"multi_scan_vertical Q={q_pad} != plain")
    union = np.unique(ids_np).size
    listed = sum(np.unique(r).size for r in ids_np)
    row("multi_scan_vertical", "src/repro_torch/kernels/csrc/scan.cu",
        "src/repro/kernels/multi_scan.py:144", 0.0,
        time_ms(lambda: multi_scan.multi_scan_vertical(data, ids, vlo, vup,
                                                       tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_vertical_ref(data, ids, vlo, vup)),
        union * n_pad * 4 + q_pad * n_pad + ids.numel() * 4 + 2 * m_pad * q_pad * 4,
        2.0 * listed * n_pad, None)
    del got, one

    # -- masked_fill_tiles (TopK's front half) on the Q = 128 scan masks --
    values = data[3]
    for q_n in (1, 128):
        got = reducers.masked_fill_tiles(masks[:q_n], values, float("-inf"),
                                         tile_n=TILE_N)
        check(torch.equal(got, ref.masked_fill_ref(masks[:q_n], values,
                                                   float("-inf"))),
              f"masked_fill_tiles Q={q_n} != plain")
        del got
    mask_bool = masks.view(torch.bool)  # the 0/1 int8 masks, reinterpreted
    ninf = torch.tensor(float("-inf"), device=dev)
    q_n = masks.shape[0]
    row("masked_fill_tiles", "src/repro_torch/kernels/csrc/reducers.cu",
        "src/repro/kernels/reducers.py:77", 0.0,
        time_ms(lambda: reducers.masked_fill_tiles(masks, values, float("-inf"),
                                                   tile_n=TILE_N)),
        time_ms(lambda: ref.masked_fill_ref(masks, values, float("-inf"))),
        q_n * n_pad + n_pad * 4 + q_n * n_pad * 4, float(q_n * n_pad),
        time_ms(lambda: torch.where(mask_bool, values, ninf)))

    # -- masked_agg_tiles: sum / min / max, Q = 1 and 128; sums repeatable --
    err = 0.0
    for op in ("sum", "min", "max"):
        for q_n in (1, 128):
            got = reducers.masked_agg_tiles(masks[:q_n], values, op, tile_n=TILE_N)
            want = ref.masked_agg_ref(masks[:q_n], values, op)
            diff = (got - want).abs()
            diff = torch.where(torch.isfinite(want), diff, torch.zeros_like(diff))
            if op == "sum":
                ok = bool((diff <= AGG_SUM_RTOL * want.abs()).all())
                err = max(err, float(diff.max()))
            else:
                ok = torch.equal(got, want)
            check(ok, f"masked_agg_tiles {op} Q={q_n} != plain")
    again = reducers.masked_agg_tiles(masks, values, "sum", tile_n=TILE_N)
    check(torch.equal(again, reducers.masked_agg_tiles(masks, values, "sum",
                                                       tile_n=TILE_N)),
          "masked_agg_tiles sums differ between identical runs")
    q_n = masks.shape[0]
    row("masked_agg_tiles", "src/repro_torch/kernels/csrc/reducers.cu",
        "src/repro/kernels/reducers.py:132", err,
        time_ms(lambda: reducers.masked_agg_tiles(masks, values, "sum",
                                                  tile_n=TILE_N)),
        time_ms(lambda: ref.masked_agg_ref(masks, values, "sum")),
        q_n * n_pad + n_pad * 4 + q_n * (n_pad // 1024) * 4, float(q_n * n_pad),
        None)
    del masks, mask_bool

    # -- range_scan_tiles / range_scan_vertical: Q = 1 --
    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    got = range_scan.range_scan_tiles(data, lo1, up1, tile_n=TILE_N)
    check(torch.equal(got, ref.range_scan_ref(data, lo1, up1)),
          "range_scan_tiles != plain")
    row("range_scan_tiles", "src/repro_torch/kernels/csrc/scan.cu",
        "src/repro/kernels/range_scan.py:71", 0.0,
        time_ms(lambda: range_scan.range_scan_tiles(data, lo1, up1, tile_n=TILE_N)),
        time_ms(lambda: ref.range_scan_ref(data, lo1, up1)),
        m_pad * n_pad * 4 + n_pad + 2 * m_pad * 4, 2.0 * m_pad * n_pad, None)
    pq = next(q for q in queries if not q.is_complete_match)
    dims = torch.as_tensor(np.nonzero(pq.dims_mask)[0].astype(np.int32), device=dev)
    plo, pup = (torch.as_tensor(a, device=dev) for a in
                QueryBatch.from_queries([pq]).bounds_columnar(m_pad, dtype=np.float32))
    d = dims.long()
    got = range_scan.range_scan_vertical(data, dims, plo, pup, tile_n=TILE_N)
    check(torch.equal(got, ref.range_scan_ref(data[d], plo[d, 0], pup[d, 0])),
          "range_scan_vertical != plain")
    row("range_scan_vertical", "src/repro_torch/kernels/csrc/scan.cu",
        "src/repro/kernels/range_scan.py:142", 0.0,
        time_ms(lambda: range_scan.range_scan_vertical(data, dims, plo, pup,
                                                       tile_n=TILE_N)),
        time_ms(lambda: ref.range_scan_ref(data[d], plo[d, 0], pup[d, 0])),
        dims.numel() * n_pad * 4 + n_pad + dims.numel() * 12,
        2.0 * dims.numel() * n_pad, None)
    rows_row(eng, queries, row, got_columnar=range_scan.range_scan_tiles(
        data, lo1, up1, tile_n=TILE_N))
    visit_rows(eng, full, queries, row)
    return rows


def rows_row(eng, queries, row, got_columnar):
    """Kernel 11: the row-major scan at Q = 1 on the row scan's (10,000,384,
    24) copy, against its plain version — and against the columnar scan's
    mask of the same query (same data, other layout)."""
    from repro_torch.kernels import ops, range_scan, ref

    rs = eng.rowscan
    data = rs.data_dev
    n_pad, m_pad = data.shape
    lo, up = ops.query_bounds_device(queries[0], m_pad, data.dtype, data.device)
    lo, up = lo.T.contiguous(), up.T.contiguous()
    got = range_scan.range_scan_rows(data, lo, up, tile_rows=rs.tile_rows)
    check(torch.equal(got, ref.range_scan_rows_ref(data, lo, up)),
          "range_scan_rows != plain")
    check(torch.equal(got, got_columnar),
          "range_scan_rows != the columnar scan's mask")
    print(f"  row scan: data {tuple(data.shape)}, query 0 matches "
          f"{int(got.sum())} rows", flush=True)
    row("range_scan_rows", "src/repro_torch/kernels/csrc/rows.cu",
        "src/repro/kernels/range_scan.py:190", 0.0,
        time_ms(lambda: range_scan.range_scan_rows(data, lo, up,
                                                   tile_rows=rs.tile_rows)),
        time_ms(lambda: ref.range_scan_rows_ref(data, lo, up)),
        n_pad * m_pad * 4 + n_pad + 2 * m_pad * 4, 2.0 * m_pad * n_pad, None)


def visit_rows(eng, full, queries, row):
    """Kernels 7-10: the visit kernel at the kd-tree's visit list for the
    128-query workload (and one query's), the VA filter at Q = 128 and 1."""
    from repro_torch.core import blockindex
    from repro_torch.core.types import next_pow2
    from repro_torch.kernels import multi_scan, range_scan, ref, va_filter

    kd = eng.kdtree
    data = kd.data_dev
    m_pad, n_pad = data.shape
    dev = data.device
    blocks = range_scan.blocks_view(data, TILE_N)
    q_n = len(full)
    qlo, qhi = (torch.as_tensor(a, device=dev)
                for a in full.bounds_columnar(kd.m, q_n))
    leaf = blockindex.prune_hierarchy_batch(kd.levels_lo, kd.levels_hi, qlo,
                                            qhi, fanout=kd.fanout)
    qids_np, bids_np = np.nonzero(leaf.cpu().numpy())
    real_v = int(qids_np.size)
    qids_p, bids_p = blockindex._pad_visit_list(qids_np.astype(np.int32),
                                                bids_np.astype(np.int32))
    qids = torch.as_tensor(qids_p, device=dev)
    bids = torch.as_tensor(bids_p, device=dev)
    lo, up = (torch.as_tensor(a, device=dev)
              for a in full.bounds_columnar(m_pad, q_n, np.float32))
    n_vis = qids.numel()
    distinct = int(np.unique(bids_np).size)
    print(f"  kdtree visits for Q={q_n}: {real_v} (padded {n_vis}), "
          f"{distinct} distinct of {n_pad // TILE_N} blocks", flush=True)
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
          f"multi_scan_visit V={n_vis} != plain")
    del got
    # bound: each distinct visited block read once, the whole padded output
    # written once; two compares per element of the real visits
    row("multi_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/multi_scan.py:206", 0.0,
        time_ms(lambda: multi_scan.multi_scan_visit(data, qids, bids, lo, up,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
        distinct * m_pad * TILE_N * 4 + n_vis * TILE_N + n_vis * 8
        + 2 * m_pad * q_n * 4,
        2.0 * m_pad * TILE_N * real_v, None)

    # -- range_scan_visit: Q = 1, the kd-tree's survivors of one query --
    q0 = queries[0]
    b1 = np.nonzero(leaf[0].cpu().numpy())[0].astype(np.int32)
    ids1 = np.full((next_pow2(b1.size),), -1, np.int32)
    ids1[: b1.size] = b1
    ids1 = torch.as_tensor(ids1, device=dev)
    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    zeros = torch.zeros_like(ids1)
    got = range_scan.range_scan_visit(data, ids1, lo1, up1, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(blocks, zeros, ids1, lo1,
                                                     up1)),
          "range_scan_visit != plain")
    print(f"  kdtree visits for query 0 ({q0.n_queried_dims} dims): {b1.size} "
          f"(padded {ids1.numel()})", flush=True)
    row("range_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/range_scan.py:248", 0.0,
        time_ms(lambda: range_scan.range_scan_visit(data, ids1, lo1, up1,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, zeros, ids1, lo1,
                                                  up1)),
        b1.size * m_pad * TILE_N * 4 + ids1.numel() * (TILE_N + 4)
        + 2 * m_pad * 4,
        2.0 * m_pad * TILE_N * b1.size, None)

    # -- multi_va_filter_packed: Q = 128; va_filter_packed: Q = 1 --
    va = eng.vafile
    packed = va.packed_dev
    w = packed.shape[0]
    clo, chi = (torch.as_tensor(a, device=dev)
                for a in va.query_cells_batch(full, q_n))
    got = va_filter.multi_va_filter_packed(packed, clo, chi, va.m)
    check(torch.equal(got, ref.multi_va_filter_packed_ref(packed, clo, chi, va.m)),
          f"multi_va_filter_packed Q={q_n} != plain")
    print(f"  VA candidates at Q={q_n}: {float(got.float().mean()):.4f} of "
          f"objects; {w} packed words", flush=True)
    del got
    row("multi_va_filter_packed", "src/repro_torch/kernels/csrc/va_filter.cu",
        "src/repro/kernels/va_filter.py:144", 0.0,
        time_ms(lambda: va_filter.multi_va_filter_packed(packed, clo, chi, va.m)),
        time_ms(lambda: ref.multi_va_filter_packed_ref(packed, clo, chi, va.m)),
        w * n_pad * 4 + q_n * n_pad + 2 * clo.numel() * 4,
        4.0 * q_n * n_pad * va.m, None)
    c1, h1 = clo[:, :1].contiguous(), chi[:, :1].contiguous()
    got = va_filter.va_filter_packed(packed, c1, h1, va.m)
    check(torch.equal(got, ref.va_filter_packed_ref(packed, c1[:, 0], h1[:, 0],
                                                    va.m)),
          "va_filter_packed != plain")
    row("va_filter_packed", "src/repro_torch/kernels/csrc/va_filter.cu",
        "src/repro/kernels/va_filter.py:97", 0.0,
        time_ms(lambda: va_filter.va_filter_packed(packed, c1, h1, va.m)),
        time_ms(lambda: ref.va_filter_packed_ref(packed, c1[:, 0], h1[:, 0],
                                                 va.m)),
        w * n_pad * 4 + n_pad + 2 * c1.numel() * 4, 4.0 * n_pad * va.m, None)


def result_specs() -> tuple:
    """The eight result specs every query phase runs under."""
    from repro_torch.core import Agg, Count, Ids, Mask, TopK
    return (Ids(), Count(), Mask(), TopK(k=10, dim=3),
            TopK(k=10, dim=4, largest=False), Agg("sum", 3), Agg("min", 2),
            Agg("max", 18))


def run_checked(eng, eng_plain, oracle, qs, method, spec, label,
                delta=False):
    """One ``query_batch`` under the counters, held against its budget, the
    plain engine and a numpy sample -> (results, method_counts)."""
    from repro_torch.kernels import ops
    ops.reset_counters()
    got = eng.query_batch(qs, method=method, spec=spec)
    counts = ops.counters()
    stats = eng.last_batch_stats
    want_counts = expected_counts(eng, stats.method_counts, spec, delta)
    check(counts == want_counts,
          f"{label}: counters {counts} != {want_counts}")
    plain = eng_plain.query_batch(qs, method=method, spec=spec)
    check(eng_plain.last_batch_stats.methods == stats.methods,
          f"{label}: plans differ from the plain engine's")
    for k, (x, y) in enumerate(zip(got, plain)):
        check(same_result(spec, x, y),
              f"{label} query {k}: kernel {x!r} != plain {y!r}")
    for k in range(min(len(qs), ORACLE_SAMPLE)):
        want = oracle.result(spec, k, stats.methods[k])
        check(same_result(spec, got[k], want),
              f"{label} query {k}: {got[k]!r} != oracle {want!r}")
    return got, dict(stats.method_counts)


def warm_qps(eng, qs, method, spec) -> float:
    """Queries per second of ``query_batch``: the median of ``TIMED_CALLS``
    warm calls, host clock (the call ends in its host sync)."""
    times = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        eng.query_batch(qs, method=method, spec=spec)
        times.append(time.perf_counter() - t0)
    return len(qs) / float(np.median(times))


def slice_phase(eng, eng_plain, oracle, queries):
    """The main path, checked against the plain engine and numpy; warm qps
    as in ``warm_qps``."""
    from repro_torch.core import Count

    topk_peak = None
    for b in BATCH_SIZES:
        qs = queries[:b]
        for spec in result_specs():
            if b == 128 and spec.kind == "topk":
                torch.cuda.reset_peak_memory_stats()
            _, buckets = run_checked(eng, eng_plain, oracle, qs, "auto", spec,
                                     f"auto B={b} {spec}")
            if b == 128 and spec.kind == "topk":
                topk_peak = max(topk_peak or 0, torch.cuda.max_memory_allocated())
            qps = warm_qps(eng, qs, "auto", spec)
            print(f"  B={b:<3} {str(spec):<38} warm qps={qps:10.1f} "
                  f"method_counts={buckets}", flush=True)

    # Singles: planned, and on the scans by name (their single-query
    # kernels; "auto" may send a single to a two-phase path).
    k = next(k for k, q in enumerate(queries) if q.is_complete_match)
    for i in (*range(N_SINGLES), k):
        q = queries[i]
        want = oracle.ids(i)
        for method in ("auto", "scan") + (
                () if q.is_complete_match else ("scan_vertical",)):
            check(np.array_equal(eng.query(q, method=method), want),
                  f"single {i} {method}: ids != oracle")
            check(eng.query(q, method=method, spec=Count()) == want.size,
                  f"single {i} {method}: count != oracle")
    return topk_peak


def index_phase(eng, eng_plain, oracle, queries):
    """The two-phase paths by name, checked like the main path; warm qps as
    in ``warm_qps``."""
    from repro_torch.core import Count

    for method in INDEX_METHODS:
        for b in sorted(set(INDEX_BATCH_SIZES) | set(HOST_BOUND_BATCH_SIZES)):
            qs = queries[:b]
            for spec in result_specs():
                host_bound = spec.kind in ("ids", "mask")
                if b not in (HOST_BOUND_BATCH_SIZES if host_bound
                             else INDEX_BATCH_SIZES):
                    continue
                run_checked(eng, eng_plain, oracle, qs, method, spec,
                            f"{method} B={b} {spec}")
                visits = getattr(eng, method).last_visited_blocks
                qps = warm_qps(eng, qs, method, spec)
                print(f"  {method:<6} B={b:<3} {str(spec):<38} warm qps="
                      f"{qps:10.1f} visits={visits}", flush=True)
        for i in range(N_SINGLES):
            want = oracle.ids(i)
            check(np.array_equal(eng.query(queries[i], method=method), want),
                  f"{method} single {i}: ids != oracle")
            check(eng.query(queries[i], method=method, spec=Count())
                  == want.size, f"{method} single {i}: count != oracle")


def server_phase(eng, ds):
    from repro_torch.core import Count
    from repro_torch.data import gmrqb
    from repro_torch.serve import MDRQServer

    queries = [q for _, q in gmrqb.mixed_workload(ds, SERVER_QUERIES, seed=SEED)]
    srv = MDRQServer(eng, max_batch=64, spec=Count())
    got = srv.serve_all(queries)
    want = eng.query_batch(queries, method="auto", spec=Count())
    check(got == want, "server results != query_batch")
    st = srv.stats
    print(f"  server: {st.n_queries} queries in {st.n_batches} batches, "
          f"qps={st.qps:.1f}, flushes={st.flush_reasons}, "
          f"methods={st.method_counts}", flush=True)


def rowscan_phase(eng, eng_plain, oracle, queries):
    """The row-major scan path by name, checked like the main path."""
    from repro_torch.core import Count

    qs = queries[:ROWSCAN_BATCH]
    for spec in result_specs():
        run_checked(eng, eng_plain, oracle, qs, "rowscan", spec,
                    f"rowscan B={ROWSCAN_BATCH} {spec}")
        qps = warm_qps(eng, qs, "rowscan", spec)
        print(f"  rowscan B={ROWSCAN_BATCH} {str(spec):<38} warm qps="
              f"{qps:10.1f}", flush=True)
    for i in range(N_SINGLES):
        want = oracle.ids(i)
        check(np.array_equal(eng.query(queries[i], method="rowscan"), want),
              f"rowscan single {i}: ids != oracle")
        check(eng.query(queries[i], method="rowscan", spec=Count())
              == want.size, f"rowscan single {i}: count != oracle")


def qps_specs() -> tuple:
    """The three specs whose warm qps the delta phase records per path."""
    from repro_torch.core import Agg, Count, TopK
    return Count(), Agg("sum", 3), TopK(k=10, dim=3)


def path_qps(eng, queries) -> dict:
    """{(path, spec): warm qps} for every method, B = 128 (rowscan B = 8)."""
    out = {}
    for method in (*DELTA_METHODS, "rowscan"):
        qs = queries[:ROWSCAN_BATCH if method == "rowscan" else 128]
        for spec in qps_specs():
            eng.query_batch(qs, method=method, spec=spec)   # warm
            out[(method, str(spec))] = warm_qps(eng, qs, method, spec)
    return out


def delta_checks(eng, eng_plain, oracle, queries, delta, label):
    """Every method at B = 128 and the row scan at B = 8, under the eight
    specs, checked like the main path."""
    for method in (*DELTA_METHODS, "rowscan"):
        qs = queries[:ROWSCAN_BATCH if method == "rowscan" else 128]
        for spec in result_specs():
            _, buckets = run_checked(eng, eng_plain, oracle, qs, method, spec,
                                     f"{label} {method} {spec}", delta=delta)
        print(f"  {label}: {method} B={len(qs)} ok under 8 specs "
              f"(last buckets {buckets})", flush=True)


def fold_time(eng, queries) -> float:
    """CUDA-event ms of the tombstone fold: the (128, n_pad) scan masks of
    the workload times the scan's base-tombstone vector. (A function, so
    no tensor of this version outlives it into the compaction check.)"""
    from repro_torch.core import QueryBatch
    from repro_torch.kernels import multi_scan, reducers

    data = eng.columnar.data_dev
    lo, up = (torch.as_tensor(a, device=data.device) for a in
              QueryBatch.from_queries(queries[:128]).bounds_columnar(
                  data.shape[0]))
    masks = multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N)
    tomb = eng.delta.snapshot().base_tomb_dev(data.shape[1], data.device)
    fold_ms = time_ms(lambda: reducers.fold_tombstones(masks, tomb))
    print(f"  tombstone fold, (128, {data.shape[1]}) int8 masks: "
          f"{fold_ms:.4f} ms", flush=True)
    return fold_ms


def delta_phase(eng, eng_plain, ds, queries):
    """Ingest through the server, serve under the delta, compact, serve."""
    from repro_torch.core import Count, RangeQuery
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer

    frozen_qps = path_qps(eng, queries)
    extra = gmrqb.build(DELTA_ROWS, seed=1).rows()
    rng = np.random.default_rng(1)
    dead = np.concatenate([
        rng.choice(N, DELTA_BASE_DEAD, replace=False),
        N + rng.choice(DELTA_ROWS, DELTA_NEW_DEAD, replace=False)])

    # -- ingest: the server orders writes against the queries around them --
    srv = MDRQServer(eng, max_batch=64, spec=Count())
    everything = RangeQuery.partial(ds.m, {})
    t0 = time.perf_counter()
    before = srv.submit(everything)
    new_ids = srv.append(extra)
    after_append = srv.submit(everything)
    deleted = srv.delete(dead)
    after_delete = srv.submit(everything)
    ingest_s = time.perf_counter() - t0
    check(np.array_equal(new_ids, N + np.arange(DELTA_ROWS)),
          "append: unexpected ids")
    check(deleted == dead.size, f"delete: {deleted} != {dead.size}")
    live = N + DELTA_ROWS - dead.size
    counts = [t.result() for t in (before, after_append, after_delete)]
    check(counts == [N, N + DELTA_ROWS, live],
          f"server ingest ordering: counts {counts}")
    check(srv.stats.ingest_counts == {"append": 1, "delete": 1}
          and srv.stats.flush_reasons.get("ingest") == 2,
          f"server ingest stats {srv.stats.ingest_counts} "
          f"{srv.stats.flush_reasons}")
    check(np.array_equal(eng_plain.append(extra), new_ids),
          "plain engine: append ids differ")
    eng_plain.delete(dead)
    print(f"  ingest through the server: {DELTA_ROWS} rows appended, "
          f"{dead.size} deleted in {ingest_s:.2f} s; live rows {live}; "
          f"memory_report delta {eng.memory_report()['delta']} bytes",
          flush=True)

    alive = np.ones(N + DELTA_ROWS, bool)
    alive[dead] = False
    cols = np.concatenate([ds.cols, np.ascontiguousarray(extra.T)], axis=1)
    oracle = Oracle(eng, cols, queries, alive=alive, n_base=N)
    ops.reset_kernel_launches()
    delta_checks(eng, eng_plain, oracle, queries, True, "delta")
    launches = ops.kernel_launches()
    print(f"  kernel launches under the delta: {launches}")
    for name in ("multi_scan_tiles", "multi_scan_vertical", "masked_fill_tiles",
                 "masked_agg_tiles", "multi_scan_visit",
                 "multi_va_filter_packed", "range_scan_rows"):
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched under the delta")
    delta_qps = path_qps(eng, queries)
    for key, q_frozen in frozen_qps.items():
        print(f"  qps {key[0]:<13} {key[1]:<38} frozen {q_frozen:10.1f} "
              f"delta {delta_qps[key]:10.1f}", flush=True)

    fold_ms = fold_time(eng, queries)

    # -- compaction: both versions on the card until the swap --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    id_map = srv.compact()
    compact_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    plain_map = eng_plain.compact()
    plain_s = time.perf_counter() - t0
    check(np.array_equal(id_map, plain_map), "compact: id maps differ")
    check(eng.version == eng_plain.version == 1, "compact: version != 1")
    check(np.array_equal(np.nonzero(id_map < 0)[0], np.sort(dead)),
          "compact: -1 not exactly on the deleted ids")
    check(np.array_equal(id_map[id_map >= 0], np.arange(live)),
          "compact: live ids not renumbered in order")
    check(eng.dataset.n == live and eng.delta.d == 0, "compact: sizes")
    after_bytes = torch.cuda.memory_allocated()
    check(after_bytes <= before_bytes,
          f"compact: {after_bytes} bytes allocated after, {before_bytes} "
          f"before — a replaced version is still on the card")
    print(f"  compact: {compact_s:.1f} s (engine, through the server), "
          f"{plain_s:.1f} s (plain engine); build seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in eng.build_seconds.items())
          + f"; device memory {before_bytes / 1e9:.2f} GB before, peak "
          f"{peak / 1e9:.2f} GB during, {after_bytes / 1e9:.2f} GB after",
          flush=True)
    check(srv.submit(everything).result() == live,
          "count after compaction != live rows")
    oracle = Oracle(eng, eng.dataset.cols, queries)
    delta_checks(eng, eng_plain, oracle, queries, False, "compacted")
    return fold_ms, compact_s, peak


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core import MDRQEngine
    from repro_torch.data import gmrqb
    from repro_torch.kernels import _build, ops

    with phase("device"):
        smi = nvidia_smi_line()
        print(f"  {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices "
              f"{torch.cuda.device_count()}", flush=True)

    with phase("build"):
        _build.build()
        print(f"  nvcc build: {_build.BUILD_SECONDS:.1f} s")
        for src, log in _build.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"  {src}: {line.strip()}")

    with phase("data"):
        ds = gmrqb.build(N, seed=SEED)
        eng = MDRQEngine(ds, tile_n=TILE_N, rowscan=True)
        eng_plain = MDRQEngine(ds, tile_n=TILE_N, rowscan=True,
                               backend="torch")
        queries = [q for _, q in gmrqb.mixed_workload(ds, 128, seed=SEED)]
        oracle = Oracle(eng, ds.cols, queries)
        print(f"  GMRQB n={ds.n} m={ds.m}; device array "
              f"{tuple(eng.columnar.data_dev.shape)} float32 per structure; "
              f"packed VA codes {tuple(eng.vafile.packed_dev.shape)} int32",
              flush=True)
        for name, e in (("engine", eng), ("plain engine", eng_plain)):
            print(f"  {name} build seconds: " + ", ".join(
                f"{k} {v:.1f}" for k, v in e.build_seconds.items()), flush=True)
        print(f"  device memory allocated: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    with phase("kernels"):
        rows = kernel_phase(eng, queries)

    # The kernels of each path, counted over that path's phase alone.
    scan_kernels = [r for r in rows if r["name"] in (
        "multi_scan_tiles", "multi_scan_vertical", "masked_fill_tiles",
        "masked_agg_tiles", "range_scan_tiles", "range_scan_vertical")]
    rowscan_kernels = [r for r in rows if r["name"] == "range_scan_rows"]
    index_kernels = [r for r in rows
                     if r not in scan_kernels and r not in rowscan_kernels]

    def read_launches(kernels, path):
        launches = ops.kernel_launches()
        print(f"  kernel launches on the {path}: {launches}")
        for r in kernels:
            r["launches"] = launches.get(r["name"], 0)
            check(r["launches"] > 0,
                  f"kernel {r['name']} was not launched on the {path}")

    with phase("slice"):
        ops.reset_kernel_launches()
        topk_peak = slice_phase(eng, eng_plain, oracle, queries)
        read_launches(scan_kernels, "main path")
        print(f"  TopK B=128 peak device memory: {topk_peak / 1e9:.2f} GB")

    with phase("index"):
        ops.reset_kernel_launches()
        index_phase(eng, eng_plain, oracle, queries)
        read_launches(index_kernels, "two-phase paths")

    with phase("server"):
        server_phase(eng, ds)

    with phase("rowscan"):
        ops.reset_kernel_launches()
        rowscan_phase(eng, eng_plain, oracle, queries)
        read_launches(rowscan_kernels, "row-scan path")

    with phase("delta"):
        delta_phase(eng, eng_plain, ds, queries)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
