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
               shapes (Q = 1 and Q = 128, with the ``m`` and ``rows``
               arguments ``ColumnarScan`` passes, each scan also timed
               without them; the columnar scans also at the scan bucket
               ``auto`` makes of the B = 128 batch and at Q = 8, printed
               but not listed in the kernels line, whose launch counts are
               per kernel; the visit kernel at the visit lists the kd-tree
               and the VA-file prune the 128-query workload to, each row's
               real and padded visits printed; the row-major scan at Q = 1):
               masks exactly equal, aggregates within float32 summation
               tolerance, repeated sums bit-identical; CUDA-event times of
               the kernel, its plain version and, where one exists, the
               one-call PyTorch equivalent. The bound of a compare kernel
               counts two compares per object per (query or visit, real dim
               its query constrains) — the full scan and the visits also one
               finiteness test per object per real row read — at the compare
               issue rate (``COMPARES_PER_CLOCK_PER_SM``; printed with its
               source), the others' operations at ``PEAK_F32_OPS_PER_S``.
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
               launched (each path's launches printed; the VA-file list's
               visit row counts the vafile path's alone).
  7. server  — ``MDRQServer(max_batch=64).serve_all`` on 256 queries under
               Count, against ``query_batch``; the host cost of the op
               layer's warm-key record per counted call.
  8. calibrate — trace -> audit -> calibrate: the 128 mixed queries under
               Count on each plannable path by name and under ``auto`` at
               B in {1, 8, 32, 128} (each shape warmed, then traced); the
               drift audit of both trace sets; ``auto`` B = 128's plan and
               execute-span seconds, its per-bucket breakdown (host launch,
               device, wait, copy, finalize) and the device ops of one
               B = 128 batch by ``auto``, ``scan`` and ``scan_vertical``
               (``torch.profiler``); ``Planner.calibrate`` on every trace's
               sample and its report; ``auto`` at B in {8, 128} under the
               placeholder and the fitted constants (warm qps and
               ``method_counts``, every result equal to the plain engine's,
               each bucket at its budget) beside each path by name; the
               constants restored and ``auto`` planning as before. The scan,
               visit and VA-filter kernels were launched.
  9. pipeline — 2,048 Count queries of the mixed workload (seed 0), then the
               first 256 under Ids, in windows of 128 through
               ``MDRQServer`` and ``serve_pipelined(backlog=4)``: every
               result equal to the synchronous server's and to
               ``query_batch`` over the same windows, the same op counts,
               no new warm key after ``warmup()`` (Count), shedding at a
               1 us latency budget and serving again, correctly, once it
               is raised; qps of both, finalize share, flush reasons, the
               warmup report and the stream scheme. The scan kernels were
               launched.
 10. dist    — horizontal partitioning: ``MDRQEngine(structures=("scan",),
               mesh=...)`` over the data phase's GMRQB at D = 1 (cuda:0) and
               D = 8 (cuda:0 listed eight times: 8 shards of 1,250,304
               objects), and a D = 8 engine on the plain backend.
               ``query_batch`` by ``scan`` and ``auto`` at B in {1, 8, 128}
               under Count, two TopK and three Agg, Ids and Mask at B in
               {8, 32}, and ``engine.query`` singles (ids and Count): every
               result equal to the unmeshed engine's scan and the plain
               meshed engine's, a sample to numpy, repeated sums
               bit-identical; one ``distributed_multi_reduce`` (or one
               ``distributed_mask`` / ``distributed_count``) + one host sync
               per bucket and single, and D launches of the scan kernel.
               ``MDRQServer`` (256 Count queries) and ``serve_pipelined`` on
               the D = 8 engine equal to ``query_batch``. Then 10,000 rows
               appended and 10,000 ids deleted (tombstones in every shard)
               on the D = 8 engine and its plain twin: B = 128 under the
               eight specs against each other and numpy over the live rows,
               then ``compact()`` (the mesh kept) and the same checks.
               Printed: each mesh's layout, warm qps of Count, Agg sum and
               TopK d3 at B = 128 beside the unmeshed ``scan``, the merge's
               device ms, peak memory.
 11. rowscan — the row-major scan path: ``query_batch(method="rowscan")`` at
               B = 8 under the eight specs (one ``range_scan_rows`` launch and
               one host sync per query) and singles; the same checks, and
               ``range_scan_rows`` was launched.
 12. delta   — the mutable plane. Through ``MDRQServer.append``/``delete``
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
 13. lm      — the LM decode-serving path, after both engines are freed.
               Qwen3-8B at full width and depth (36 layers, d_model 4096,
               random bf16 weights from a torch.Generator, seed 0):
               ``BatchServer(slots=4, max_len=1024)`` serves 8 requests
               (seed 0; prompts of 4-15 tokens, 16 new tokens) through the
               MDRQ admission filter with ``kv_block_prune=4``,
               ``kv_block_size=32`` (``launch.serve --kv-prune 4``); every
               admitted request completes at its length, with the logits
               (within ``LOGIT_ATOL``) and token ids of the same server on
               the plain backend, up to the first step whose plain top-2
               logit margin is under twice that step's logit difference.
               Then 8 more requests (seed 1; prompts of 40-120 tokens, 24
               new, all admitted): positions cross blocks 0-4, refilled
               slots decode on stale zone maps (both must be reached).
               Both sets are replayed teacher-forced on the plain backend:
               logits within ``LOGIT_ATOL`` at every generated token, greedy
               tokens equal where the plain top-2 margin is at least 2 *
               ``TOKEN_TIE``, and a planted fault (the last listed block
               dropped in every call; its replay's launches are not
               counted) must be rejected. Then long-context
               decode: B = 4 at 32,768 slots, blocks of 512 keys,
               16 of 64 kept, K/V caches from a generator (seed 1), positions
               32,759 - 64 b (the last block partial), 8 teacher-forced steps
               on each backend on its own cache copy: every kernel call
               (here and in the server) within ``KV_RTOL`` of its plain
               version on the same inputs, every visit list the top 16 by a
               numpy stable sort of its bounds, logits within
               ``LOGIT_ATOL``, layer-0 visit lists of the two backends
               equal; warm ms per step and tokens/s with the kernel and
               with ``kv_block_prune=0`` on the same state; a profile of
               three steps (device busy over device events, the idle share
               against the warm step without the profiler, top ops,
               ``kv_visit_attention``'s device ms per step);
               ``kv_visit_attention`` on the inputs of one more step's
               layer-0 call: against its plain version, int32 against int64
               ids and positions, two planted faults (which the ``KV_RTOL``
               check must reject), one device kernel per call, eager,
               device and host time, and ``scaled_dot_product_attention``
               over the whole cache; and the same times at the server shape
               (the multi-block set's call with the most valid keys).

The last three lines are the kernel table (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import re
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
# The calibrate phase: the plannable paths traced by name (and "auto"), at
# BATCH_SIZES; "auto" rerun under the fitted constants at these sizes.
CAL_METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile")
REFIT_BATCH_SIZES = (8, 128)
# The pipeline phase: one stream served synchronously and pipelined.
PIPE_BATCH = 128
PIPE_BACKLOG = 4
PIPE_COUNT_QUERIES = 2048
PIPE_IDS_QUERIES = 256
PIPE_TIMEOUT_S = 300.0    # any wait on the finalizer; also the main budget
# The dist phase: meshes of D shards on the card (a mesh listing cuda:0 D
# times); reduced specs at DIST_BATCH_SIZES, Ids and Mask at the host-bound
# sizes; writes that put tombstones in every shard.
DIST_SHARDS = (1, 8)
DIST_BATCH_SIZES = (1, 8, 128)
DIST_SERVER_QUERIES = 256
DIST_DELTA_ROWS = 10_000
DIST_DELTA_DEAD = 10_000  # 9,000 base ids and 1,000 of the new rows
# float32 sums taken in different orders (kernel tree vs torch vs numpy
# pairwise) over non-negative values: relative difference bound.
AGG_SUM_RTOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate outside
# the tensor cores, for the bound column. The VA filter's 32-bit logical
# operations are counted against the float32 rate too (the data sheet states
# no int32 rate outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# The compare rows' operations term (the scan, visit and row-scan kernels):
# two float32 compares per (object, query, compared dim), which issue at 64
# results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput table, row "compare, minimum,
# maximum"; the 67e12 above counts an FFMA, at 128 per clock, as two
# operations). The rate is that times the card's SMs and its
# ``clocks.max.sm`` as nvidia-smi reports it.
COMPARES_PER_CLOCK_PER_SM = 64
COMPARE_RATE_SOURCE = ("CUDA C++ Programming Guide, arithmetic instruction "
                       "throughput, compute capability 9.0: compare, "
                       "minimum, maximum = 64 per clock per SM")

# -- the LM phase --
LM_ARCH = "qwen3_8b"
LM_SEED = 0
LM_REQUESTS, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 8, 4, 1024, 16
LM_PRUNE, LM_BLOCK = 4, 32          # what launch.serve --kv-prune 4 sets
# The multi-block request set: prompts of 40-120 tokens and 24 new tokens, so
# positions cross blocks 0-4 of 32 keys; every request admitted, 8 on 4 slots,
# so refilled slots decode on their predecessors' zone maps.
LM_MB_REQUESTS, LM_MB_PROMPT, LM_MB_NEW = 8, (40, 121), 24
LONG_B, LONG_SLOTS, LONG_BLOCK, LONG_PRUNE = 4, 32_768, 512, 16
LONG_STEPS = 8
LONG_TIMED_STEPS = 10
# The kernel against its plain version on the same bf16 inputs: both sides
# accumulate in float32 and round the output once to bf16, so they may differ
# by one bf16 ulp of a value, at most 2**-7 of the largest |output|. The limit
# is two such ulps of the largest |plain output| of the call. kv_visit_row
# plants two faults at the long-context shape (the last listed block dropped;
# the keys of the partial 128-key tile masked) and requires the check to
# reject each (readings in PERF.md).
KV_RTOL = 2.0 ** -6
# End to end, both backends compute in bf16 and differ only where the
# attention output rounds, but a one-ulp difference in one layer grows
# through 36 layers of a random-init network (and through the caches the
# steps write): on an H100 the two backends' logits come out 0.08 (server) to
# 0.18 (long context) apart at |logit| < 5 (PERF.md). The kernel's own
# faults are caught per call (KV_RTOL); this limit bounds the drift of the
# whole path.
LOGIT_ATOL = 0.5
# The teacher-forced token check: with both backends fed one token stream,
# the kernel's greedy token must equal the plain backend's wherever the plain
# top-2 margin is at least 2 * TOKEN_TIE. A backend whose logits are within
# TOKEN_TIE of the plain ones cannot pick another token there; the two
# backends' logits drift 0.08-0.18 apart on an H100 (PERF.md), so a sound
# kernel stays clear of it, while a fault that moves logits by more than
# TOKEN_TIE (even within LOGIT_ATOL) is seen at every decisive step it flips.
# (The margin test against each step's own logit difference can never fail:
# margin >= 2 d forces the same argmax.)
TOKEN_TIE = 0.25


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


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


@functools.cache
def compare_rate() -> float:
    """Float32 compares per second the card can issue (see
    ``COMPARES_PER_CLOCK_PER_SM``); read once, printed with its source."""
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = COMPARES_PER_CLOCK_PER_SM * sms * mhz * 1e6
    print(f"  compare rate: {COMPARES_PER_CLOCK_PER_SM} x {sms} SMs x "
          f"{mhz:.0f} MHz (clocks.max.sm) = {rate:.4e}/s "
          f"({COMPARE_RATE_SOURCE})", flush=True)
    return rate


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


def bound_ms(nbytes: float, ops: float,
             rate: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / rate
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
    from repro_torch.kernels import range_scan

    data = eng.columnar.data_dev
    m_pad = data.shape[0]
    dev = data.device
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops, lib_ms,
            rate=PEAK_F32_OPS_PER_S, shape=False):
        # shape: another shape of a listed kernel, printed but not listed
        # (the launch counts are per kernel, not per shape)
        b, by = bound_ms(nbytes, ops, rate)
        if not shape:
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b, "bound_by": by, "library_ms": lib_ms})
        print(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b:.4f} ({by}) library_ms={lib_ms}"
              + (" (a shape of a listed kernel)" if shape else ""), flush=True)

    full = QueryBatch.from_queries(queries[:128])
    lo, up = (torch.as_tensor(a, device=dev)
              for a in full.bounds_columnar(m_pad, dtype=np.float32))
    reducer_rows(eng, scan_rows(eng, queries, row), row)

    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    rows_row(eng, queries, row, got_columnar=range_scan.range_scan_tiles(
        data, lo1, up1, tile_n=TILE_N, **scan_rows_kw(eng, queries[:1])))
    visit_rows(eng, full, queries, row)
    return rows


def reducer_rows(eng, masks, row) -> None:
    """Kernels 3 and 4 on the Q = 128 scan masks (``scan_rows``' return):
    against their plain versions (fills exactly, sums within AGG_SUM_RTOL
    and bit-identical when repeated, min / max exactly), then timed."""
    from repro_torch.kernels import ref, reducers
    data = eng.columnar.data_dev
    n_pad = data.shape[1]
    dev = data.device
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


def scan_rows_kw(eng, qs, ids_np=None) -> dict:
    """What ``ColumnarScan`` passes the scan wrappers beyond the reference's
    arguments for the queries ``qs``: ``m=`` and ``rows=`` (the dims any
    query constrains) to the full scan, ``rows=`` (the distinct dims of
    ``ids_np``) to the vertical one."""
    from repro_torch.core import QueryBatch
    if ids_np is None:
        return {"m": eng.columnar.m,
                "rows": int(QueryBatch.from_queries(qs).dims_mask.any(axis=0).sum())}
    return {"rows": int(np.unique(ids_np).size)}


def compared_dims(lo, up, m: int) -> np.ndarray:
    """Per query, the real dims its full-scan bounds constrain: a dim whose
    bounds are the float32 extrema is open (its compare holds exactly for
    the finite values, which one test per object settles)."""
    fmax = float(np.finfo(np.float32).max)
    lo, up = lo[:m].cpu().numpy(), up[:m].cpu().numpy()
    return (~((lo == -fmax) & (up == fmax))).sum(axis=0)


def scan_compares(lo, up, m: int) -> tuple[int, int]:
    """(constrained, all) (query, real dim) pairs of full-scan bounds."""
    return int(compared_dims(lo, up, m).sum()), m * lo.shape[1]


def scan_rows(eng, queries, row):
    """Kernels 1, 2, 5 and 6, the columnar scans: ``multi_scan_tiles`` at the
    first 128 queries (all their bounds), at the scan bucket ``auto`` makes
    of the B = 128 mixed batch and at Q = 8; ``multi_scan_vertical`` at the
    partial-match queries among the first 128 (pow2-padded: the B = 128
    vertical bucket) and among the first 8 partial ones; both at Q = 1.
    Each against its plain version (masks exactly equal), then timed; the
    bucket shapes are printed, not listed (``shape=True``). Operations: two
    compares per object per (query, distinct compared real dim), plus one
    finiteness test per object per real row for the full scan, at
    ``compare_rate()``. Each full or vertical scan is also timed without
    the ``m`` / ``rows`` hints (the reference's call). Returns the Q = 128
    full-scan masks."""
    from repro_torch.core import Count, QueryBatch
    from repro_torch.core.scan import bucketed_batch_bounds
    from repro_torch.core.types import next_pow2
    from repro_torch.kernels import multi_scan, range_scan, ref

    data = eng.columnar.data_dev
    m = eng.columnar.m
    m_pad, n_pad = data.shape
    dev = data.device
    rate = compare_rate()
    scan_src = "src/repro_torch/kernels/csrc/scan.cu"

    eng.query_batch(queries[:128], method="auto", spec=Count())
    plan = eng.last_batch_stats.methods
    scan_b = [q for q, meth in zip(queries[:128], plan) if meth == "scan"]
    partial = [q for q in queries[:128] if not q.is_complete_match]
    vert_b = [q for q, meth in zip(queries[:128], plan)
              if meth == "scan_vertical"]
    print(f"  auto at B=128: {len(scan_b)} scan, {len(vert_b)} scan_vertical "
          f"(the vertical bucket is the 128-query row's batch: "
          f"{vert_b == partial})", flush=True)

    def tiles_row(name, qs, bucket, shape=False):
        if bucket:
            _, lo, up = bucketed_batch_bounds(QueryBatch.from_queries(qs),
                                              m_pad, data.dtype, dev)
        else:
            lo, up = (torch.as_tensor(a, device=dev) for a in
                      QueryBatch.from_queries(qs).bounds_columnar(m_pad))
        q_n = lo.shape[1]
        kw = scan_rows_kw(eng, qs)
        got = multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N, **kw)
        check(torch.equal(got, ref.multi_scan_ref(data, lo, up)),
              f"{name} Q={q_n} != plain")
        pairs, every = scan_compares(lo, up, m)
        print(f"  {name}: Q={q_n}, {pairs} of {every} (query, real dim) "
              f"pairs constrained; every real dim compared would bound it at "
              f"{2.0 * every * n_pad / rate * 1e3:.4f} ms", flush=True)
        row(name, scan_src, "src/repro/kernels/multi_scan.py:73", 0.0,
            time_ms(lambda: multi_scan.multi_scan_tiles(data, lo, up,
                                                        tile_n=TILE_N, **kw)),
            time_ms(lambda: ref.multi_scan_ref(data, lo, up)),
            m * n_pad * 4 + q_n * n_pad + 2 * m_pad * q_n * 4,
            (2.0 * pairs + m) * n_pad, None, rate, shape)
        no_hint(name, kw, lambda: multi_scan.multi_scan_tiles(
            data, lo, up, tile_n=TILE_N))
        return got

    def no_hint(name, kw, fn):
        hints = ", ".join(f"{k}={v}" for k, v in kw.items())
        print(f"  {name} without {hints}: ms={time_ms(fn):.4f}", flush=True)

    def vertical_row(name, qs, shape=False):
        batch = QueryBatch.from_queries(qs)
        q_pad, lo, up = bucketed_batch_bounds(batch, m_pad, data.dtype, dev)
        ids_np = batch.padded_dim_ids(q_pad)
        ids = torch.as_tensor(ids_np, device=dev)
        vkw = scan_rows_kw(eng, qs, ids_np)
        got = multi_scan.multi_scan_vertical(data, ids, lo, up, tile_n=TILE_N,
                                             **vkw)
        check(torch.equal(got, ref.multi_scan_vertical_ref(data, ids, lo, up)),
              f"{name} Q={q_pad} != plain")
        del got
        union = np.unique(ids_np).size
        listed = sum(np.unique(r).size for r in ids_np)
        print(f"  {name}: Q={q_pad}, D_max={ids_np.shape[1]}, {listed} "
              f"distinct (query, dim) pairs, {union} rows", flush=True)
        row(name, scan_src, "src/repro/kernels/multi_scan.py:144", 0.0,
            time_ms(lambda: multi_scan.multi_scan_vertical(data, ids, lo, up,
                                                           tile_n=TILE_N,
                                                           **vkw)),
            time_ms(lambda: ref.multi_scan_vertical_ref(data, ids, lo, up)),
            union * n_pad * 4 + q_pad * n_pad + ids.numel() * 4
            + 2 * m_pad * q_pad * 4,
            2.0 * listed * n_pad, None, rate, shape)
        no_hint(name, vkw, lambda: multi_scan.multi_scan_vertical(
            data, ids, lo, up, tile_n=TILE_N))

    # -- multi_scan_tiles: the first 128 queries; Q = 1 checked here too --
    one = QueryBatch.from_queries(queries[:1])
    lo1, up1 = (torch.as_tensor(a, device=dev)
                for a in one.bounds_columnar(m_pad))
    kw = scan_rows_kw(eng, queries[:1])
    check(torch.equal(multi_scan.multi_scan_tiles(data, lo1, up1,
                                                  tile_n=TILE_N, **kw),
                      ref.multi_scan_ref(data, lo1, up1)),
          "multi_scan_tiles Q=1 != plain")
    masks = tiles_row("multi_scan_tiles", queries[:128], bucket=False)
    if scan_b:
        tiles_row("multi_scan_tiles[B=128 scan bucket]", scan_b, bucket=True,
                  shape=True)
    tiles_row("multi_scan_tiles[Q=8]", queries[:8], bucket=False, shape=True)

    # -- multi_scan_vertical: Q = 1 checked, the B = 128 bucket, Q = 8 --
    pq = partial[0]
    b1 = QueryBatch.from_queries([pq])
    ids1 = torch.as_tensor(b1.padded_dim_ids(), device=dev)
    vlo, vup = (torch.as_tensor(a, device=dev)
                for a in b1.bounds_columnar(m_pad))
    check(torch.equal(multi_scan.multi_scan_vertical(data, ids1, vlo, vup,
                                                     tile_n=TILE_N),
                      ref.multi_scan_vertical_ref(data, ids1, vlo, vup)),
          "multi_scan_vertical Q=1 != plain")
    vertical_row("multi_scan_vertical", partial)
    vertical_row("multi_scan_vertical[Q=8]", partial[:8], shape=True)

    # -- range_scan_tiles / range_scan_vertical: Q = 1 --
    got = range_scan.range_scan_tiles(data, lo1, up1, tile_n=TILE_N, **kw)
    check(torch.equal(got, ref.range_scan_ref(data, lo1, up1)),
          "range_scan_tiles != plain")
    pairs, _ = scan_compares(lo1, up1, m)
    row("range_scan_tiles", scan_src, "src/repro/kernels/range_scan.py:71",
        0.0,
        time_ms(lambda: range_scan.range_scan_tiles(data, lo1, up1,
                                                    tile_n=TILE_N, **kw)),
        time_ms(lambda: ref.range_scan_ref(data, lo1, up1)),
        m * n_pad * 4 + n_pad + 2 * m_pad * 4, (2.0 * pairs + m) * n_pad,
        None, rate)
    no_hint("range_scan_tiles", kw, lambda: range_scan.range_scan_tiles(
        data, lo1, up1, tile_n=TILE_N))
    dims = torch.as_tensor(np.nonzero(pq.dims_mask)[0].astype(np.int32),
                           device=dev)
    d = dims.long()
    got = range_scan.range_scan_vertical(data, dims, vlo, vup, tile_n=TILE_N)
    check(torch.equal(got, ref.range_scan_ref(data[d], vlo[d, 0], vup[d, 0])),
          "range_scan_vertical != plain")
    row("range_scan_vertical", scan_src, "src/repro/kernels/range_scan.py:142",
        0.0,
        time_ms(lambda: range_scan.range_scan_vertical(data, dims, vlo, vup,
                                                       tile_n=TILE_N)),
        time_ms(lambda: ref.range_scan_ref(data[d], vlo[d, 0], vup[d, 0])),
        dims.numel() * n_pad * 4 + n_pad + dims.numel() * 12,
        2.0 * dims.numel() * n_pad, None, rate)
    return masks


def rows_row(eng, queries, row, got_columnar=None):
    """Kernel 11: the row-major scan at Q = 1 on the row scan's (10,000,384,
    24) copy, against its plain version — and against the columnar scan's
    mask of the same query (same data, other layout), where given."""
    from repro_torch.kernels import ops, range_scan, ref

    rs = eng.rowscan
    data = rs.data_dev
    n_pad, m_pad = data.shape
    lo, up = ops.query_bounds_device(queries[0], m_pad, data.dtype, data.device)
    lo, up = lo.T.contiguous(), up.T.contiguous()
    got = range_scan.range_scan_rows(data, lo, up, tile_rows=rs.tile_rows)
    check(torch.equal(got, ref.range_scan_rows_ref(data, lo, up)),
          "range_scan_rows != plain")
    check(got_columnar is None or torch.equal(got, got_columnar),
          "range_scan_rows != the columnar scan's mask")
    print(f"  row scan: data {tuple(data.shape)}, query 0 matches "
          f"{int(got.sum())} rows", flush=True)
    row("range_scan_rows", "src/repro_torch/kernels/csrc/rows.cu",
        "src/repro/kernels/range_scan.py:190", 0.0,
        time_ms(lambda: range_scan.range_scan_rows(data, lo, up,
                                                   tile_rows=rs.tile_rows)),
        time_ms(lambda: ref.range_scan_rows_ref(data, lo, up)),
        n_pad * m_pad * 4 + n_pad + 2 * m_pad * 4,
        (2.0 * int(compared_dims(lo.reshape(-1, 1), up.reshape(-1, 1),
                                 rs.m)[0]) + rs.m) * n_pad, None,
        compare_rate())


def visit_rows(eng, full, queries, row):
    """Kernels 7-10: the visit kernel at the kd-tree's and the VA-file's
    visit lists for the 128-query workload (and the kd-tree's for one
    query), the VA filter at Q = 128 and 1.

    The visit rows are bounded as the full scan is: bytes, each distinct
    visited block's real rows read once and the whole padded output written
    once; operations, two compares per object of each real visit per real
    dim its query constrains, plus one finiteness test per object per real
    row of each distinct visited block (what rejects +inf and NaN where the
    query leaves a dim open), at ``compare_rate()``."""
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
    m = kd.m
    cdims = compared_dims(lo, up, m)
    pairs = int(cdims[qids_np].sum())
    print(f"  kdtree visits for Q={q_n}: {real_v} (padded {n_vis}), "
          f"{distinct} distinct of {n_pad // TILE_N} blocks; {pairs} "
          f"(visit, constrained real dim) pairs of {real_v * m}", flush=True)
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
          f"multi_scan_visit V={n_vis} != plain")
    del got
    row("multi_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/multi_scan.py:206", 0.0,
        time_ms(lambda: multi_scan.multi_scan_visit(data, qids, bids, lo, up,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
        distinct * m * TILE_N * 4 + n_vis * TILE_N + n_vis * 8
        + 2 * m_pad * q_n * 4,
        (2.0 * pairs + m * distinct) * TILE_N, None, compare_rate())

    # -- multi_scan_visit at the VA-file's list for the same 128 queries --
    va = eng.vafile
    vq, vb = va._candidate_blocks_batch(full)
    vqids_p, vbids_p = blockindex._pad_visit_list(vq, vb)
    vqids = torch.as_tensor(vqids_p, device=dev)
    vbids = torch.as_tensor(vbids_p, device=dev)
    vdata = va.data_dev
    vblocks = range_scan.blocks_view(vdata, TILE_N)
    v_real, v_pad = int(vq.size), vqids.numel()
    v_distinct = int(np.unique(vb).size)
    v_pairs = int(cdims[vq].sum())
    print(f"  vafile visits for Q={q_n}: {v_real} (padded {v_pad}), "
          f"{v_distinct} distinct of {n_pad // TILE_N} blocks; {v_pairs} "
          f"(visit, constrained real dim) pairs of {v_real * m}", flush=True)
    got = multi_scan.multi_scan_visit(vdata, vqids, vbids, lo, up, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(vblocks, vqids, vbids, lo,
                                                     up)),
          f"multi_scan_visit V={v_pad} (VA-file list) != plain")
    del got
    row("multi_scan_visit[vafile]", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/multi_scan.py:206", 0.0,
        time_ms(lambda: multi_scan.multi_scan_visit(vdata, vqids, vbids, lo, up,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(vblocks, vqids, vbids, lo,
                                                  up)),
        v_distinct * m * TILE_N * 4 + v_pad * TILE_N + v_pad * 8
        + 2 * m_pad * q_n * 4,
        (2.0 * v_pairs + m * v_distinct) * TILE_N, None, compare_rate())

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
    print(f"  kdtree visits for query 0 ({q0.n_queried_dims} dims, "
          f"{int(cdims[0])} constrained): {b1.size} (padded {ids1.numel()})",
          flush=True)
    row("range_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/range_scan.py:248", 0.0,
        time_ms(lambda: range_scan.range_scan_visit(data, ids1, lo1, up1,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, zeros, ids1, lo1,
                                                  up1)),
        b1.size * m * TILE_N * 4 + ids1.numel() * (TILE_N + 4)
        + 2 * m_pad * 4,
        (2.0 * int(cdims[0]) + m) * TILE_N * b1.size, None, compare_rate())

    # -- multi_va_filter_packed: Q = 128; va_filter_packed: Q = 1 --
    # Operations: four 32-bit logical operations per (query, object, packed
    # word) — the word-parallel test of 16 fields at once.
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
        4.0 * q_n * n_pad * w, None)
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
        w * n_pad * 4 + n_pad + 2 * c1.numel() * 4, 4.0 * n_pad * w, None)


def result_specs() -> tuple:
    """The eight result specs every query phase runs under."""
    from repro_torch.core import Agg, Count, Ids, Mask, TopK
    return (Ids(), Count(), Mask(), TopK(k=10, dim=3),
            TopK(k=10, dim=4, largest=False), Agg("sum", 3), Agg("min", 2),
            Agg("max", 18))


def run_checked(eng, eng_plain, oracle, qs, method, spec, label,
                delta=False, same_plan=True):
    """One ``query_batch`` under the counters, held against its budget, the
    plain engine (and its plan, unless ``same_plan`` is False: the engine
    under test plans with other constants) and a numpy sample -> (results,
    method_counts)."""
    from repro_torch.kernels import ops
    ops.reset_counters()
    got = eng.query_batch(qs, method=method, spec=spec)
    counts = ops.counters()
    stats = eng.last_batch_stats
    want_counts = expected_counts(eng, stats.method_counts, spec, delta)
    check(counts == want_counts,
          f"{label}: counters {counts} != {want_counts}")
    plain = eng_plain.query_batch(qs, method=method, spec=spec)
    check(not same_plan or eng_plain.last_batch_stats.methods == stats.methods,
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


def index_phase(eng, eng_plain, oracle, queries) -> dict:
    """The two-phase paths by name, checked like the main path; warm qps as
    in ``warm_qps``. Returns each path's kernel launches."""
    from repro_torch.core import Count
    from repro_torch.kernels import ops

    by_method = {}
    for method in INDEX_METHODS:
        before = ops.kernel_launches()
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
        after = ops.kernel_launches()
        by_method[method] = {k: v - before.get(k, 0) for k, v in after.items()
                             if v > before.get(k, 0)}
        print(f"  kernel launches on the {method} path: {by_method[method]}",
              flush=True)
    return by_method


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
    print(f"  warm-key record: {warm_key_us(eng):.3f} us per counted op "
          f"call (host)", flush=True)


def warm_key_us(eng, calls: int = 20_000) -> float:
    """Host microseconds ``ops.counted`` spends per call on the warm-key
    record (the key of a B = 128 full-scan call, hashed and looked up in
    the warm set); the counter bump it shares a lock with predates it."""
    from repro_torch.core import Count
    from repro_torch.kernels import ops
    data = eng.columnar.data_dev
    bounds = torch.zeros((data.shape[0], 128), device=data.device)
    args = (data, bounds, bounds, None, None)
    kw = dict(spec=Count(), tile_n=TILE_N, m=eng.dataset.m, rows=19,
              backend="auto")
    warm = set(ops.warm_keys())
    t0 = time.perf_counter()
    for _ in range(calls):
        _ = ops.warm_key("multi_scan_reduce", args, kw) in warm
    return (time.perf_counter() - t0) / calls * 1e6


def indented(text: str) -> str:
    return "\n".join("    " + line for line in text.splitlines())


def bucket_breakdown(eng, qs, spec, reps: int = TIMED_CALLS) -> dict:
    """Where one ``auto`` batch's time goes -> {"plan": s, path: {part: s}}.
    Per bucket: the host's preparation and launches (``launch``), the
    card's time from the first to the last queued operation (``device``,
    CUDA events; it includes any gap the host leaves), the host's wait for
    it after launching (``wait``), the counted copy (``copy``) and the host
    finalizer (``finalize``). Medians of ``reps`` warm runs."""
    from repro_torch.core import QueryBatch
    from repro_torch.kernels import ops
    batch = QueryBatch.from_queries(qs)
    runs: dict = {}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        methods = eng.planner.plan_batch(batch, spec=spec).methods
        runs.setdefault("plan", []).append(time.perf_counter() - t0)
        buckets: dict = {}
        for k, meth in enumerate(methods):
            buckets.setdefault(meth, []).append(k)
        for meth, idxs in buckets.items():
            sub = QueryBatch(batch.lower[idxs], batch.upper[idxs])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            payload, fin = eng.paths[meth].launch_batch(sub, spec=spec)
            end.record()
            t1 = time.perf_counter()
            end.synchronize()
            t2 = time.perf_counter()
            host = ops.device_get(payload)
            t3 = time.perf_counter()
            fin(host)
            t4 = time.perf_counter()
            runs.setdefault((meth, len(idxs)), []).append(
                (t1 - t0, start.elapsed_time(end) / 1e3, t2 - t1, t3 - t2,
                 t4 - t3))
    out = {"plan": float(np.median(runs.pop("plan")))}
    for key, rows in runs.items():
        med = np.median(np.asarray(rows), axis=0)
        out[key] = dict(zip(("launch", "device", "wait", "copy", "finalize"),
                            map(float, med)))
    return out


def batch_device_ops(eng, qs, method, spec) -> tuple[float, list]:
    """torch.profiler over one warm ``query_batch`` -> (the summed device
    ms of its device events, [(name, calls, device ms)] by device ms).
    The profiler can drop a device event (``device_kernels``): a reading
    with fewer events than another of the same batch lost some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.query_batch(qs, method=method, spec=spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.query_batch(qs, method=method, spec=spec)
        torch.cuda.synchronize()
    ops_ms: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, ms = ops_ms.get(e.name, (0, 0.0))
            ops_ms[e.name] = (calls + 1, ms + e.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, c, ms) for k, (c, ms) in ops_ms.items()),
                  key=lambda r: -r[2])
    return sum(ms for _, _, ms in rows), rows


def calibrate_phase(eng, eng_plain, oracle, queries):
    """Trace -> audit -> calibrate on the card, then restore the constants.

    The 128 mixed queries under Count on each plannable path by name and
    under ``auto`` at B in ``BATCH_SIZES`` (each shape warmed, then traced);
    the drift audit of both trace sets; ``auto`` B = 128's plan and
    execute-span seconds, ``bucket_breakdown`` and the device ops of one
    B = 128 batch by ``auto``, ``scan`` and ``scan_vertical`` (profiler);
    the calibration samples
    of every trace fitted by ``Planner.calibrate``; ``auto`` at
    ``REFIT_BATCH_SIZES`` under the placeholder and the fitted constants
    (warm qps, ``method_counts``, every result equal to the plain engine's,
    each bucket at its budget) beside each path by name; then the saved
    constants back, and ``auto`` B = 128 planning as the plain engine does
    again."""
    from repro_torch import obs
    from repro_torch.core import Count

    spec = Count()
    model = eng.planner.model
    saved = dataclasses.asdict(model)
    traces = []
    for method in (*CAL_METHODS, "auto"):
        for b in BATCH_SIZES:
            qs = queries[:b]
            eng.query_batch(qs, method=method, spec=spec)   # warm the shape
            eng.query_batch(qs, method=method, spec=spec, trace=True)
            traces.append((method, eng.last_trace))
    named = [t for m, t in traces if m != "auto"]
    auto = [t for m, t in traces if m == "auto"]
    print("  audit, the paths by name (Count, B in 1, 8, 32, 128):")
    print(indented(obs.audit(named).summary()))
    print("  audit, auto:")
    print(indented(obs.audit(auto).summary()), flush=True)
    bt = auto[-1]
    spans = [s for root in bt.spans for s in root.find("execute")]
    print(f"  auto B=128 traced: plan {bt.plan_seconds * 1e3:.3f} ms of "
          f"{bt.seconds * 1e3:.3f} ms; execute spans " + ", ".join(
              f"{s.attrs['path']} ({s.attrs['bucket']} queries) "
              f"{s.seconds * 1e3:.3f} ms" for s in spans), flush=True)
    parts = bucket_breakdown(eng, queries[:128], spec)
    print(f"  auto B=128 breakdown (median of {TIMED_CALLS}, ms): plan "
          f"{parts.pop('plan') * 1e3:.3f}", flush=True)
    for (meth, size), p in parts.items():
        print(f"    {meth} ({size} queries): " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in p.items()), flush=True)
    for method in ("auto", "scan", "scan_vertical"):
        total, rows = batch_device_ops(eng, queries[:128], method, spec)
        print(f"  device ops of one {method} B=128 Count batch "
              f"(torch.profiler): {total:.3f} ms in "
              f"{sum(c for _, c, _ in rows)} events", flush=True)
        for name, calls, ms in rows[:8]:
            print(f"    {ms:8.3f} ms {calls:3d}x {name[:90]}", flush=True)

    def auto_runs(label, same_plan):
        out = {}
        for b in REFIT_BATCH_SIZES:
            qs = queries[:b]
            _, counts = run_checked(eng, eng_plain, oracle, qs, "auto", spec,
                                    f"calibrate {label} auto B={b}",
                                    same_plan=same_plan)
            out[b] = (warm_qps(eng, qs, "auto", spec), counts)
        return out

    placeholder = auto_runs("placeholder", True)
    by_name = {(m, b): warm_qps(eng, queries[:b], m, spec)
               for m in CAL_METHODS for b in REFIT_BATCH_SIZES}
    samples = obs.calibration_samples([t for _, t in traces], model)
    report = eng.planner.calibrate(samples)
    print(f"  calibrate: {report.n_samples} samples from {report.methods}, "
          f"rms_rel_err {report.rms_rel_err:.4g}", flush=True)
    for f in report.fits:
        print(f"    {f.constant}: fitted {f.fitted:.6g} "
              f"({'accepted' if f.accepted else 'rejected'}: {f.reason}); "
              f"placeholder {saved[f.constant]:.6g}", flush=True)
    try:
        fitted = auto_runs("fitted", False)
    finally:
        for name, value in saved.items():
            setattr(model, name, value)
    for b in REFIT_BATCH_SIZES:
        print(f"  auto B={b:<3} placeholder {placeholder[b][0]:10.1f} qps "
              f"{placeholder[b][1]}; fitted {fitted[b][0]:10.1f} qps "
              f"{fitted[b][1]}", flush=True)
        print("    by name: " + ", ".join(
            f"{m} {by_name[(m, b)]:.1f}" for m in CAL_METHODS), flush=True)
    check(dataclasses.asdict(model) == saved,
          "calibrate: the saved constants were not restored")
    run_checked(eng, eng_plain, oracle, queries, "auto", spec,
                "calibrate restored auto B=128")


def pipeline_phase(eng, ds):
    """The same stream through ``MDRQServer`` and ``serve_pipelined``.

    ``PIPE_COUNT_QUERIES`` Count queries of the mixed workload, then the
    first ``PIPE_IDS_QUERIES`` of them under Ids, in windows of
    ``PIPE_BATCH`` (no deadline flushes, so both servers cut the same
    windows). Gates: every pipelined result equals the synchronous server's
    and ``query_batch``'s over the same windows; the op counters of the
    stream equal the synchronous server's; after ``warmup()`` the Count
    stream adds no warm key; a latency budget far below one window's time
    sheds, and the raised budget serves again, correctly. The Ids server is
    not warmed: the warm batch matches every row, and at 10 M rows its Ids
    would be ~80 MB per query.
    """
    from repro_torch.core import Count, Ids
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer, Overloaded, serve_pipelined

    stream = [q for _, q in gmrqb.mixed_workload(ds, PIPE_COUNT_QUERIES,
                                                 seed=SEED)]
    for spec, qs in ((Count(), stream), (Ids(), stream[:PIPE_IDS_QUERIES])):
        label = f"pipeline {spec.kind}"
        want = []
        for i in range(0, len(qs), PIPE_BATCH):
            want += eng.query_batch(qs[i:i + PIPE_BATCH], method="auto",
                                    spec=spec)
        sync = MDRQServer(eng, max_batch=PIPE_BATCH,
                          max_wait_s=float("inf"), spec=spec)
        ops.reset_counters()
        t0 = time.perf_counter()
        got = sync.serve_all(qs)
        sync_wall = time.perf_counter() - t0
        sync_counts = ops.counters()
        check(all(same_result(spec, x, y) for x, y in zip(got, want)),
              f"{label}: synchronous server != query_batch")
        warm = spec.kind == "count"
        srv = serve_pipelined(eng, max_batch=PIPE_BATCH,
                              max_wait_s=float("inf"), spec=spec,
                              backlog=PIPE_BACKLOG,
                              latency_budget_s=PIPE_TIMEOUT_S, warmup=warm)
        try:
            ops.reset_counters()
            ops.reset_trace_log()
            t0 = time.perf_counter()
            tickets = [srv.submit(q) for q in qs]
            srv.drain(PIPE_TIMEOUT_S)
            got = [t.result(timeout=PIPE_TIMEOUT_S) for t in tickets]
            pipe_wall = time.perf_counter() - t0
            counts, new_keys = ops.counters(), ops.trace_log()
            check(len(got) == len(want) and all(
                same_result(spec, x, y) for x, y in zip(got, want)),
                f"{label}: pipelined results != the synchronous server's")
            check(counts == sync_counts,
                  f"{label}: counters {counts} != synchronous {sync_counts}")
            st, ss = srv.stats, sync.stats
            check(st.n_batches == ss.n_batches == -(-len(qs) // PIPE_BATCH),
                  f"{label}: windows {st.n_batches} / {ss.n_batches}")
            n = len(qs)
            print(f"  {label}: {n} queries, {st.n_batches} windows of "
                  f"{PIPE_BATCH}, backlog {PIPE_BACKLOG}, streams: "
                  f"{srv.stream_scheme}; methods {st.method_counts}",
                  flush=True)
            print(f"    sync      qps {ss.qps:10.1f} (busy), "
                  f"{n / sync_wall:10.1f} (wall {sync_wall:.4f} s); "
                  f"plan {ss.plan_seconds:.4f} s", flush=True)
            print(f"    pipelined qps {st.qps:10.1f} (wall_seconds "
                  f"{st.wall_seconds:.4f}), {n / pipe_wall:10.1f} (wall "
                  f"{pipe_wall:.4f} s); busy {st.busy_seconds:.4f} s, "
                  f"plan {st.plan_seconds:.4f} s, finalize "
                  f"{st.finalize_seconds:.4f} s (share of the wall "
                  f"{st.finalize_seconds / st.wall_seconds:.3f}); flushes "
                  f"{st.flush_reasons}; ratio pipelined / sync (wall) "
                  f"{sync_wall / pipe_wall:.3f}", flush=True)
            print(f"    counters per stream (both servers): {counts}",
                  flush=True)
            if not warm:
                continue
            rep = srv.last_warmup
            print(f"    warmup: {rep.n_runs} runs over {rep.paths}, buckets "
                  f"{rep.bucket_sizes}, vertical dims {rep.dim_counts}, "
                  f"{len(rep.keys)} keys, {rep.seconds:.2f} s; new keys in "
                  f"the stream: {len(new_keys)}", flush=True)
            check(new_keys == (),
                  f"{label}: the warmed stream added keys {new_keys[:4]}")
            srv.latency_budget_s = 1e-6    # far below one window's time
            shed = [srv.submit(q) for q in qs[:PIPE_BATCH]]
            check(srv.stats.shed_counts.get("overloaded", 0) > 0
                  and all(t.shed for t in shed) and srv.n_pending == 0,
                  f"{label}: a 1 us budget shed {srv.stats.shed_counts}")
            with contextlib.suppress(Overloaded):
                shed[0].result(timeout=PIPE_TIMEOUT_S)
                check(False, f"{label}: a shed ticket returned a result")
            srv.latency_budget_s = PIPE_TIMEOUT_S
            tickets = [srv.submit(q) for q in qs[:PIPE_BATCH]]
            srv.drain(PIPE_TIMEOUT_S)
            check(all(same_result(spec, t.result(timeout=PIPE_TIMEOUT_S), y)
                      for t, y in zip(tickets, want)),
                  f"{label}: results after recovery != query_batch")
            print(f"    shed at a 1 us budget: {srv.stats.shed_counts}; "
                  f"recovered at {PIPE_TIMEOUT_S:.0f} s: {PIPE_BATCH} "
                  f"queries served, equal", flush=True)
        finally:
            srv.close(PIPE_TIMEOUT_S)


def dist_specs() -> tuple:
    """The reduced specs of the dist phase (the eight less Ids and Mask)."""
    return tuple(s for s in result_specs() if s.kind not in ("ids", "mask"))


def dist_checked(eng, d, qs, method, spec, label, want, plain, oracle,
                 extra_scans=0):
    """One ``query_batch`` of a meshed engine: one bucket on the sharded
    scan at 1 ``distributed_multi_reduce`` + 1 host sync, ``d`` launches of
    the scan kernel (one per shard; ``extra_scans`` for a delta block), and
    every result equal to ``want`` (the unmeshed scan's), to ``plain`` (the
    plain meshed engine's) and, on a sample, to ``oracle``."""
    from repro_torch.kernels import ops
    ops.reset_counters()
    ops.reset_kernel_launches()
    got = eng.query_batch(qs, method=method, spec=spec)
    counts, launches = ops.counters(), ops.kernel_launches()
    check(counts == {"distributed_multi_reduce": 1, "host_sync": 1},
          f"{label}: counters {counts}")
    check(eng.last_batch_stats.method_counts == {"scan": len(qs)},
          f"{label}: buckets {eng.last_batch_stats.method_counts}")
    check(launches.get("multi_scan_tiles", 0) == d + extra_scans,
          f"{label}: multi_scan_tiles launched "
          f"{launches.get('multi_scan_tiles', 0)} times, not {d}"
          + (f" + {extra_scans}" if extra_scans else ""))
    for k, (x, y, z) in enumerate(zip(got, want, plain)):
        check(same_result(spec, x, y),
              f"{label} query {k}: {x!r} != unmeshed {y!r}")
        check(same_result(spec, x, z),
              f"{label} query {k}: {x!r} != plain meshed {z!r}")
    for k in range(min(len(qs), ORACLE_SAMPLE)):
        w = oracle.result(spec, k, "scan")
        check(same_result(spec, got[k], w),
              f"{label} query {k}: {got[k]!r} != oracle {w!r}")
    return got


def dist_merge_ms(eng, qs) -> dict:
    """CUDA-event ms of the merges on the mesh's first device at this batch
    (Count's sum, Agg sum's sum, TopK d3's final top-k), from the shards'
    partials; the shards' own kernels are not in these times."""
    from repro_torch.core import QueryBatch
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import reducers

    dsc = eng.dist
    mesh = dsc.mesh
    _, lo, up, rows = dsc._batch_bounds(QueryBatch.from_queries(qs))
    masks = dist_mod._distributed_multi_mask(mesh, dsc.shards, lo, up,
                                             **dsc._op_kw(rows))
    counts = [x.ne(0).sum(dim=-1, dtype=torch.int32) for x in masks]
    aggs = [reducers.masked_agg(x, s[3], "sum", tile_n=TILE_N,
                                backend="auto")[0]
            for x, s in zip(masks, dsc.shards)]
    tops = [reducers.masked_topk(x, s[3], 10, True, tile_n=TILE_N,
                                 backend="auto")
            for x, s in zip(masks, dsc.shards)]
    return {
        "count": time_ms(lambda: torch.stack(mesh.gather(counts)).sum(
            dim=0, dtype=torch.int32)),
        "agg sum": time_ms(lambda: torch.stack(mesh.gather(aggs)).sum(dim=0)),
        "topk": time_ms(lambda: reducers.merge_shard_topk(
            [mesh.gather(p) for p in tops], dsc.n_local, 10, True)),
    }


def dist_phase(eng, ds, oracle, queries):
    """Horizontal partitioning: ``MDRQEngine(mesh=...)`` at D shards of the
    card against the unmeshed engine under test, the plain meshed engine
    and numpy; the servers on the eight-shard engine; writes and
    ``compact()``. Returns the launches of the path's kernels."""
    from repro_torch.core import Count, MDRQEngine, make_data_mesh
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer, serve_pipelined

    torch.cuda.reset_peak_memory_stats()
    dev = eng.device
    meshes = {d: make_data_mesh(device=[dev] * d) for d in DIST_SHARDS}
    t0 = time.perf_counter()
    engines = {d: MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                             mesh=meshes[d]) for d in DIST_SHARDS}
    d_max = max(DIST_SHARDS)
    plain = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                       mesh=meshes[d_max], backend="torch")
    for d, e in engines.items():
        dsc = e.dist
        check(e._columnar is None and e.planner.model.n_devices == d
              and dsc.n_local * d == dsc.n_pad and dsc.n_local % TILE_N == 0,
              f"D={d}: engine layout")
        print(f"  D={d}: n padded to {dsc.n_pad:,}, {d} shard(s) of "
              f"{dsc.n_local:,} objects on {dsc.mesh.distinct}; per-shard "
              f"multi_scan_tiles data ({dsc.m_pad}, {dsc.n_local:,}) float32, "
              f"bounds ({dsc.m_pad}, q_pad), {d} launch(es) per bucket; "
              f"planner n_devices {e.planner.model.n_devices}", flush=True)
    print(f"  three meshed engines (D = 1, {d_max}, {d_max} plain) built in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    phase_launches: dict[str, int] = {}

    def tally():
        for k, v in ops.kernel_launches().items():
            phase_launches[k] = phase_launches.get(k, 0) + v

    # -- batches and singles, frozen --
    sizes = [(b, spec) for b in DIST_BATCH_SIZES for spec in dist_specs()]
    sizes += [(b, spec) for b in HOST_BOUND_BATCH_SIZES
              for spec in result_specs() if spec.kind in ("ids", "mask")]
    for b, spec in sizes:
        t0 = time.perf_counter()
        qs = queries[:b]
        want = eng.query_batch(qs, method="scan", spec=spec)
        want_plain = plain.query_batch(qs, method="scan", spec=spec)
        for d, e in engines.items():
            for method in ("scan", "auto"):
                got = dist_checked(e, d, qs, method, spec,
                                   f"D={d} {method} B={b} {spec}", want,
                                   want_plain, oracle)
                tally()
            if spec.kind == "agg" and spec.op == "sum":
                again = e.query_batch(qs, method="scan", spec=spec)
                check([np.float32(x).tobytes() for x in again]
                      == [np.float32(x).tobytes() for x in got],
                      f"D={d} B={b} {spec}: repeated sums differ in bits")
        print(f"  B={b:<3} {str(spec):<38} D={DIST_SHARDS} scan and auto: "
              f"equal to the unmeshed scan, the plain meshed engine and "
              f"numpy; 1 op + 1 sync, D scan launches per bucket "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    for d, e in engines.items():
        for i in range(N_SINGLES):
            w = oracle.ids(i)
            for method in ("scan", "auto"):
                for spec, op in ((None, "distributed_mask"),
                                 (Count(), "distributed_count")):
                    ops.reset_counters()
                    ops.reset_kernel_launches()
                    got = e.query(queries[i], method=method, spec=spec)
                    counts, launches = ops.counters(), ops.kernel_launches()
                    tally()
                    check(counts == {op: 1, "host_sync": 1},
                          f"D={d} single {i} {method}: counters {counts}")
                    check(launches.get("range_scan_tiles", 0) == d,
                          f"D={d} single {i}: range_scan_tiles launched "
                          f"{launches.get('range_scan_tiles', 0)} times")
                    check(np.array_equal(got, w) if spec is None
                          else got == w.size,
                          f"D={d} single {i} {method} {spec}: != oracle")
    print(f"  singles: {N_SINGLES} queries x (ids, Count) x (scan, auto) "
          f"on each mesh equal numpy, 1 op + 1 sync, D range_scan_tiles "
          f"launches each ({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- warm qps at B = 128 --
    qs = queries[:128]
    for spec in qps_specs():
        row = {"unmeshed scan": warm_qps(eng, qs, "scan", spec)}
        for d, e in engines.items():
            row[f"D={d}"] = warm_qps(e, qs, "scan", spec)
        print(f"  warm qps B=128 {str(spec):<38} " + ", ".join(
            f"{k} {v:10.1f}" for k, v in row.items()), flush=True)

    # -- serving on the eight-shard engine --
    t0 = time.perf_counter()
    e8 = engines[d_max]
    stream = [q for _, q in gmrqb.mixed_workload(ds, DIST_SERVER_QUERIES,
                                                 seed=SEED)]
    want = eng.query_batch(stream, method="scan", spec=Count())
    check(e8.query_batch(stream, method="auto", spec=Count()) == want,
          f"D={d_max}: query_batch of the server stream != unmeshed")
    srv = MDRQServer(e8, max_batch=64, spec=Count())
    ops.reset_kernel_launches()
    check(srv.serve_all(stream) == want,
          f"D={d_max}: MDRQServer results != query_batch")
    tally()
    print(f"  MDRQServer on D={d_max}: {srv.stats.n_queries} Count queries "
          f"in {srv.stats.n_batches} batches, qps={srv.stats.qps:.1f}, "
          f"equal to query_batch", flush=True)
    pipe = serve_pipelined(e8, max_batch=PIPE_BATCH, max_wait_s=float("inf"),
                           spec=Count(), backlog=PIPE_BACKLOG,
                           latency_budget_s=PIPE_TIMEOUT_S, warmup=False)
    try:
        ops.reset_counters()
        ops.reset_kernel_launches()
        tickets = [pipe.submit(q) for q in stream]
        pipe.drain(PIPE_TIMEOUT_S)
        got = [t.result(timeout=PIPE_TIMEOUT_S) for t in tickets]
        counts = ops.counters()
        tally()
    finally:
        pipe.close(PIPE_TIMEOUT_S)
    windows = -(-len(stream) // PIPE_BATCH)
    check(got == want, f"D={d_max}: pipelined results != query_batch")
    check(counts == {"distributed_multi_reduce": windows,
                     "host_sync": windows},
          f"D={d_max}: pipelined counters {counts}")
    print(f"  serve_pipelined on D={d_max}: {len(stream)} Count queries in "
          f"{windows} windows of {PIPE_BATCH}, equal to query_batch, "
          f"counters {counts}, streams: {pipe.stream_scheme} (serving "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    merge = dist_merge_ms(e8, queries[:128])
    print(f"  merge on the first device, B=128, D={d_max} (CUDA events): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in merge.items()),
          flush=True)

    # -- writes, then compaction --
    extra = gmrqb.build(DIST_DELTA_ROWS, seed=2).rows()
    rng = np.random.default_rng(2)
    n_new_dead = DIST_DELTA_DEAD // 10
    dead = np.concatenate([
        rng.choice(N, DIST_DELTA_DEAD - n_new_dead, replace=False),
        N + rng.choice(DIST_DELTA_ROWS, n_new_dead, replace=False)])
    for e in (e8, plain):
        check(np.array_equal(e.append(extra), N + np.arange(DIST_DELTA_ROWS)),
              "dist: append ids")
        check(e.delete(dead) == dead.size, "dist: delete count")
    hit = np.unique(dead[dead < N] // e8.dist.n_local).size
    check(hit >= 3, f"dist: tombstones in {hit} shards")
    alive = np.ones(N + DIST_DELTA_ROWS, bool)
    alive[dead] = False
    cols = np.concatenate([ds.cols, np.ascontiguousarray(extra.T)], axis=1)
    for label, orc, extra_scans in (
            ("delta", Oracle(eng, cols, queries, alive=alive, n_base=N), 1),
            ("compacted", None, 0)):
        t0 = time.perf_counter()
        if orc is None:
            t0 = time.perf_counter()
            id_map = e8.compact()
            compact_s = time.perf_counter() - t0
            check(np.array_equal(plain.compact(), id_map),
                  "dist compact: id maps differ")
            check(e8.version == plain.version == 1 and e8.dist is not None
                  and e8.dist.mesh == meshes[d_max] and e8._columnar is None,
                  "dist compact: the mesh was not kept")
            check(np.array_equal(np.nonzero(id_map < 0)[0], np.sort(dead)),
                  "dist compact: -1 not exactly on the deleted ids")
            orc = Oracle(eng, e8.dataset.cols, queries)
            print(f"  compact on D={d_max}: {compact_s:.1f} s; "
                  f"{e8.dataset.n:,} live rows, shards of "
                  f"{e8.dist.n_local:,}", flush=True)
        qs = queries[:128]
        for spec in result_specs():
            got_plain = plain.query_batch(qs, method="scan", spec=spec)
            dist_checked(e8, d_max, qs, "scan", spec,
                         f"{label} D={d_max} B=128 {spec}", got_plain,
                         got_plain, orc, extra_scans=extra_scans)
            tally()
        print(f"  {label}: D={d_max} B=128 under 8 specs equal to the plain "
              f"meshed engine and numpy ({ORACLE_SAMPLE} queries); "
              f"{d_max}{' + 1' if extra_scans else ''} scan launches per "
              f"bucket ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"  dist peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return phase_launches


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


def lm_requests(cfg, seed: int, n: int, prompt: tuple[int, int], max_new: int,
                admit_all: bool = False) -> list:
    """``n`` requests (numpy seed ``seed``) with prompts of [lo, hi) tokens;
    random admission features, or ones the admission filter takes."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, int(rng.integers(*prompt)))
        feats = [0.5, toks.size, 100.0, 0.5] if admit_all else \
            [rng.random(), 8, 100.0, rng.random()]
        reqs.append(Request(rid=i, prompt=toks.astype(np.int32),
                            max_new=max_new,
                            features=np.array(feats, np.float32)))
    return reqs


def lm_server(model, params, reqs, logits=None, steps=None):
    """Serve ``reqs`` through ``BatchServer(slots=LM_SLOTS,
    max_len=LM_MAX_LEN)``; with ``logits`` (a dict), record the logits row
    of every generated token per request id; with ``steps`` (a list), record
    each step's (tokens, positions, generating slots, their logits rows)
    -> (done, steps, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchServer, admission_query

    cfg = model.cfg
    srv = BatchServer(model, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    if logits is not None or steps is not None:
        step = srv.step_fn

        def recording_step(params, cache, toks, pos):
            out, cache = step(params, cache, toks, pos)
            rows = out[:, 0, :cfg.vocab_size].float().cpu().numpy()
            gen = [s for s, req in enumerate(srv.active)
                   if req is not None and not srv.to_feed[s]]
            for s in gen:
                if logits is not None:
                    logits.setdefault(srv.active[s].rid, []).append(rows[s])
            if steps is not None:
                steps.append((toks.cpu().numpy().copy(),
                              pos.cpu().numpy().copy(), gen, rows[gen]))
            return out, cache
        srv.step_fn = recording_step
    ops.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.serve(reqs, admission_query())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_steps = ops.counter("host_sync") - 1   # one per step, plus the admission's
    feats = np.stack([r.features for r in reqs])
    admitted = {r.rid for r in reqs if 0.2 <= r.features[0] <= 1.0
                and 0.0 <= r.features[3] <= 0.8}
    check({r.rid for r in done} == admitted,
          f"served {sorted(r.rid for r in done)} != admitted {sorted(admitted)}"
          f" (features {feats.tolist()})")
    for r in done:
        check(r.output is not None and r.output.shape == (r.max_new,),
              f"request {r.rid}: output {r.output!r}")
    return done, n_steps, seconds


def replay(model, params, steps, fault=None, stop=None) -> list:
    """Teacher forcing: feed the recorded steps' tokens and positions through
    ``model``'s serve step on a fresh server cache (what ``BatchServer``
    starts from) -> each step's logits rows of the generating slots.
    ``fault`` alters every call of ``ops.kv_visit_attention`` (a planted
    fault); ``stop(rows)`` True ends the replay early."""
    from repro_torch.kernels import ops
    from repro_torch.serve.serve_step import make_serve_step

    cache = model.init_cache(LM_SLOTS, LM_MAX_LEN, model.dtype)
    step = make_serve_step(model)
    vocab = model.cfg.vocab_size
    op, rows = ops.kv_visit_attention, []
    if fault is not None:
        ops.kv_visit_attention = lambda *a, **kw: op(*fault(*a), **kw)
    try:
        for toks, pos, gen, _ in steps:
            out, cache = step(params, cache, torch.as_tensor(toks, device="cuda"),
                              torch.as_tensor(pos, device="cuda"))
            rows.append(out[gen, 0, :vocab].float().cpu().numpy())
            if stop is not None and stop(rows):
                break
    finally:
        ops.kv_visit_attention = op
    return rows


def token_reading(rows_k, rows_p) -> dict:
    """The kernel side's logits rows against the plain side's, both fed one
    token stream: the largest difference, and at the decisive steps (plain
    top-2 margin >= 2 * TOKEN_TIE) how many greedy tokens differ."""
    worst, decisive, differ, own_rule, tokens = 0.0, 0, 0, 0, 0
    for lk_rows, lp_rows in zip(rows_k, rows_p):
        for lk, lp in zip(lk_rows, lp_rows):
            tokens += 1
            d = float(np.abs(lk - lp).max())
            worst = max(worst, d)
            top2 = np.sort(lp)[-2:]
            margin = float(top2[1] - top2[0])
            own_rule += margin >= 2 * d
            if margin >= 2 * TOKEN_TIE:
                decisive += 1
                differ += int(np.argmax(lk) != np.argmax(lp))
    return {"tokens": tokens, "worst": worst, "decisive": decisive,
            "differ": differ, "own_rule": own_rule}


def rejections(r: dict) -> list[str]:
    """What the teacher-forced check rejects in a ``token_reading``."""
    out = []
    if r["worst"] > LOGIT_ATOL:
        out.append(f"logits differ by {r['worst']:.4g} > {LOGIT_ATOL}")
    if r["differ"]:
        out.append(f"{r['differ']} of {r['decisive']} decisive greedy tokens "
                   f"differ from the plain backend's")
    return out


def teacher_forced_check(label, plain, params, steps) -> tuple[dict, list]:
    """Replay the kernel server's token stream on the plain backend: logits
    within LOGIT_ATOL at every generated token, greedy tokens equal at every
    decisive step -> (the reading, the plain logits rows)."""
    rows_p = replay(plain, params, steps)
    r = token_reading([s[3] for s in steps], rows_p)
    faults = rejections(r)
    check(not faults, f"{label}: " + "; ".join(faults))
    check(r["decisive"] > 0, f"{label}: no decisive step to compare")
    print(f"  {label}, teacher-forced on the kernel's tokens: {r['tokens']} "
          f"generated tokens, max |logit kernel - plain| {r['worst']:.4g} "
          f"(limit {LOGIT_ATOL}); {r['decisive']} decisive (plain top-2 "
          f"margin >= {2 * TOKEN_TIE}), all equal; {r['own_rule']} with "
          f"margin >= 2 x their own logit difference", flush=True)
    return r, rows_p


def lm_server_part(model, plain, params) -> dict:
    """The server with the kernel against the same server on the plain
    backend, on two request sets -> (the inputs of the multi-block set's
    kernel call with the most valid keys, for the kernel row's server shape;
    the multi-block set's recorded steps, the plain side's logits rows of
    their replay and that reading, for ``served_fault``).

    Short prompts (seed LM_SEED, positions in block 0): token j of a request
    is compared while both sides have generated the same tokens before it:
    its logits must agree within LOGIT_ATOL, and its token must be equal
    unless the plain side's top-2 margin is under twice the step's largest
    logit difference (then the step is printed and the request compared no
    further). Both sets: every kernel call within KV_RTOL of its plain
    version, and the plain backend teacher-forced on the kernel server's
    tokens (``teacher_forced_check``). The multi-block set must reach block
    4, lists of more than one valid block and refilled slots."""
    cfg = model.cfg
    reqs = lm_requests(cfg, LM_SEED, LM_REQUESTS, (4, 16), LM_MAX_NEW)
    done, steps, seconds = lm_server(model, params, reqs)
    rec_k: dict[int, list] = {}
    rec_p: dict[int, list] = {}
    tf_steps: list = []
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    with plain_shadow(shadow):
        again, _, _ = lm_server(model, params, reqs, rec_k, tf_steps)
    check(shadow["calls"] == steps * cfg.n_layers,
          f"{shadow['calls']} server kernel calls held against the plain "
          f"version, not one per layer and step")
    check([r.output.tolist() for r in again] == [r.output.tolist() for r in done],
          "the kernel server gave other tokens on a second run")
    plain_done, _, plain_seconds = lm_server(plain, params, reqs, rec_p)
    check([r.rid for r in done] == [r.rid for r in plain_done],
          "completion order differs from the plain backend's")
    compared, worst = 0, 0.0
    for r, p in zip(done, plain_done):
        for j, (a, b) in enumerate(zip(r.output, p.output)):
            lk, lp = rec_k[r.rid][j], rec_p[r.rid][j]
            d = float(np.abs(lk - lp).max())
            worst = max(worst, d)
            check(d <= LOGIT_ATOL, f"request {r.rid} token {j}: logits differ "
                                   f"by {d} > {LOGIT_ATOL}")
            top2 = np.sort(lp)[-2:]
            margin = float(top2[1] - top2[0])
            if margin < 2 * d:
                print(f"  request {r.rid} token {j}: plain top-2 margin "
                      f"{margin:.4g} < 2 x logit difference {d:.4g}; compared "
                      f"no further", flush=True)
                break
            check(a == b, f"request {r.rid} token {j}: kernel {a} != plain {b}")
            compared += 1
    tokens = sum(r.output.size for r in done)
    print(f"  server: {len(done)} of {LM_REQUESTS} requests admitted and "
          f"completed, {tokens} tokens in {steps} steps, {seconds:.2f} s "
          f"({seconds / steps * 1e3:.1f} ms/step, {tokens / seconds:.1f} "
          f"generated tokens/s; plain backend, recording, "
          f"{plain_seconds:.2f} s); {compared} of {tokens} tokens compared "
          f"equal; max |logit kernel - plain| {worst:.4g}; each of "
          f"{shadow['calls']} kv_visit_attention calls within "
          f"{shadow['err']:.4g} ({shadow['rel']:.4g} of its max |plain|; "
          f"limit {KV_RTOL:.4g}) of its plain version", flush=True)
    for r in done:
        print(f"  request {r.rid}: prompt {r.prompt.size} tokens -> "
              f"{r.output[:8].tolist()}...", flush=True)
    teacher_forced_check("server, short prompts", plain, params, tf_steps)
    del rec_k, rec_p, tf_steps

    # The multi-block set: positions past block 0, refilled slots.
    reqs = lm_requests(cfg, LM_SEED + 1, LM_MB_REQUESTS, LM_MB_PROMPT,
                       LM_MB_NEW, admit_all=True)
    tf_steps = []
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    with plain_shadow(shadow):
        done, steps, seconds = lm_server(model, params, reqs, steps=tf_steps)
    refills = len(done) - LM_SLOTS
    print(f"  server, multi-block set: {len(done)} requests (prompts "
          f"{sorted(r.prompt.size for r in reqs)} tokens, {LM_MB_NEW} new) on "
          f"{LM_SLOTS} slots, {refills} refilled slots, {steps} steps in "
          f"{seconds:.2f} s; largest position {shadow['max_pos']} (block "
          f"{shadow['max_pos'] // LM_BLOCK}); {shadow['multi']} of "
          f"{shadow['calls']} kv_visit_attention calls list more than one "
          f"block with valid keys, each within {shadow['err']:.4g} "
          f"({shadow['rel']:.4g} of its max |plain|; limit {KV_RTOL:.4g}) of "
          f"its plain version", flush=True)
    check(len(done) == LM_MB_REQUESTS, "the multi-block set was not all served")
    check(shadow["calls"] == steps * cfg.n_layers,
          f"{shadow['calls']} multi-block kernel calls held against the plain "
          f"version, not one per layer and step")
    check(shadow["max_pos"] >= 4 * LM_BLOCK and shadow["multi"] > 0
          and refills > 0,
          "the multi-block set did not reach block 4, multi-block lists and "
          "refilled slots")
    sound, rows_p = teacher_forced_check("server, multi-block set", plain,
                                         params, tf_steps)
    return shadow["widest"], (tf_steps, rows_p, sound)


def served_fault(model, params, tf_steps, rows_p, sound) -> None:
    """A planted fault (the last listed block dropped in every kernel call)
    replayed on the multi-block set's token stream must fail the
    teacher-forced check (``lm_server_part``'s reading ``sound`` passed)."""
    def drop_last(q, k_blocks, v_blocks, block_ids, pos):
        ids = block_ids.clone()
        ids[..., -1] = -1
        return q, k_blocks, v_blocks, ids, pos
    rows_f = replay(model, params, tf_steps, drop_last,   # to the first rejection
                    stop=lambda rows: rejections(token_reading(
                        rows[-1:], rows_p[len(rows) - 1:len(rows)])))
    fault = token_reading(rows_f, rows_p)
    caught = rejections(fault)
    check(caught, f"planted fault (last listed block dropped) passes the "
                  f"teacher-forced check: {fault}")
    print(f"  planted fault, last listed block dropped in every call: "
          f"rejected at step {len(rows_f)} of {len(tf_steps)} "
          f"({'; '.join(caught)}); reading: {fault['differ']} of "
          f"{fault['decisive']} decisive greedy tokens differ (sound: 0 of "
          f"{sound['decisive']}), max |logit - plain| {fault['worst']:.4g} "
          f"(sound {sound['worst']:.4g}, limit {LOGIT_ATOL})", flush=True)


def long_cache(model, start: torch.Tensor) -> dict:
    """A long-context cache: K/V from a generator (seed 1, bf16) in the
    slots before each row's start position, zeros after; zone maps over the
    written slots."""
    from repro_torch import numerics
    cfg = model.cfg
    cache = model.init_cache(LONG_B, LONG_SLOTS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    written = (torch.arange(LONG_SLOTS, device="cuda")[None, :]
               < start[:, None])                                  # (B, S)
    nb = LONG_SLOTS // LONG_BLOCK
    big = numerics.finite_max(torch.bfloat16)
    w5 = written.view(LONG_B, nb, LONG_BLOCK, 1, 1)
    for layer in range(cfg.n_layers):
        for name in ("k", "v"):
            t = cache[name][layer]
            t.normal_(generator=gen)
            t.mul_(written[:, :, None, None])
        kb = cache["k"][layer].view(LONG_B, nb, LONG_BLOCK, cfg.n_kv_heads,
                                    -1).float()
        cache["kmin"][layer] = torch.where(w5, kb, big).amin(dim=2)
        cache["kmax"][layer] = torch.where(w5, kb, -big).amax(dim=2)
        del kb
    return cache


def kv_err(got, want) -> tuple[float, float]:
    """(max |kernel - plain|, max |plain|) of one kv_visit_attention output;
    the check is err <= KV_RTOL * scale."""
    want = want.float()
    return (float((got.float() - want).abs().max()),
            float(want.abs().max()))


@contextlib.contextmanager
def plain_shadow(stats):
    """Within the block, hold every kernel call of ``ops.kv_visit_attention``
    against the plain version on the same inputs (before the next layer can
    change them); the plain calls launch no kernel and are not counted.
    ``stats`` collects the calls, the largest error and the largest error
    over its call's max |plain output|, the largest position, the calls
    whose list holds more than one block with valid keys (``multi``) and the
    inputs of the call with the most valid keys (``widest``)."""
    from repro_torch.kernels import ops, ref
    op = ops.kv_visit_attention
    stats.update(max_pos=-1, multi=0, keys=-1, widest=None)

    def checked(q, k_blocks, v_blocks, block_ids, pos, *, backend="auto"):
        out = op(q, k_blocks, v_blocks, block_ids, pos, backend=backend)
        if backend == "auto":
            err, scale = kv_err(out, ref.kv_visit_attention_ref(
                q, k_blocks, v_blocks, block_ids, pos))
            check(err <= KV_RTOL * scale,
                  f"kv_visit_attention call {stats['calls']}: {err} from its "
                  f"plain version > {KV_RTOL} x max |plain| {scale}")
            stats["calls"] += 1
            stats["err"] = max(stats["err"], err)
            stats["rel"] = max(stats["rel"], err / scale)
            bs = k_blocks.shape[3]
            first = block_ids.long() * bs
            p = pos.long()[:, None, None]
            live = (block_ids >= 0) & (first <= p)
            keys = int(((p - first + 1).clamp(0, bs) * live).sum())
            stats["max_pos"] = max(stats["max_pos"], int(pos.max()))
            stats["multi"] += int((live.sum(-1) > 1).any())
            if keys > stats["keys"]:
                stats["keys"] = keys
                stats["widest"] = (q.clone(), k_blocks, v_blocks,
                                   block_ids.clone(), pos.clone())
        return out
    ops.kv_visit_attention = checked
    try:
        yield
    finally:
        ops.kv_visit_attention = op


def profile_steps(model, params, cache, tok, pos, step_ms: float,
                  steps: int = 3) -> None:
    """torch.profiler over ``steps`` warm decode steps: device busy time (the
    device events' durations) against ``step_ms``, the warm step's wall time
    without the profiler (the idle share), and against the profiled steps'
    own wall time (which the profiler's host work lengthens); the ops that
    take the most device and host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows_us = sum(dev_us(e) for e in events)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    if busy <= 0:
        print("  profiler: no device time recorded; idle share not measured",
              flush=True)
        return
    busy_ms = busy / steps / 1e3
    print(f"  profiler, {steps} pruned decode steps: device busy "
          f"{busy_ms:.2f} ms/step (its {len(kernels) // steps} device events; "
          f"the sum over all profiler rows, ops and kernels, "
          f"{rows_us / steps / 1e3:.2f}); idle share {1 - busy_ms / step_ms:.3f}"
          f" of the warm step without the profiler ({step_ms:.2f} ms); under "
          f"the profiler the step took {wall_us / steps / 1e3:.2f} ms (share "
          f"{1 - busy / wall_us:.3f})", flush=True)
    kv = [e for e in kernels if "kv_visit" in e.name]
    print(f"  kv_visit_attention in the decode step: "
          f"{sum(e.time_range.elapsed_us() for e in kv) / steps / 1e3:.4f} "
          f"device ms/step in {len(kv) // steps} kernels/step "
          f"({sorted({e.name[:60] for e in kv})})", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"    device {dev_us(e) / steps / 1e3:8.3f} ms/step  calls "
              f"{e.count // steps:5d}  {e.key[:70]}", flush=True)
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / steps / 1e3:8.3f} ms/step  "
              f"calls {e.count // steps:5d}  {e.key[:70]}", flush=True)


def lm_long_part(params):
    """Teacher-forced long-context decode on both backends; step times with
    and without the prune on the same state -> (the kernel's cache, the
    inputs of the layer-0 kernel call of one more step)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(LM_ARCH).replace(kv_block_prune=LONG_PRUNE,
                                      kv_block_size=LONG_BLOCK)
    model = build_model(cfg)
    plain = build_model(cfg, backend="torch")
    start = torch.tensor([LONG_SLOTS - 1 - LONG_STEPS - 64 * b
                          for b in range(LONG_B)], device="cuda")
    t0 = time.perf_counter()
    cache = long_cache(model, start)
    cache_p = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    print(f"  long-context caches: 2 x {2 * cache['k'].nbytes / 1e9:.2f} GB "
          f"(K + V) + zone maps, filled in {time.perf_counter() - t0:.1f} s; "
          f"positions {start.tolist()}; device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (LONG_STEPS, LONG_B, 1)), device="cuda")
    worst, rows, differ = 0.0, 0, 0
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    for t in range(LONG_STEPS):
        vk, vp = [], []
        with plain_shadow(shadow):
            lk, _ = model.decode_step(params, cache, toks[t], start + t,
                                      visits=vk)
        lp, _ = plain.decode_step(params, cache_p, toks[t], start + t,
                                  visits=vp)
        worst = max(worst, float((lk - lp).abs().max()))
        for layer, ((top_k, ub_k), (top_p, _)) in enumerate(zip(vk, vp)):
            # the selection on the card against numpy's stable sort: the
            # largest bounds first, ties to the lower block id
            want = np.argsort(-ub_k.cpu().numpy(), axis=-1,
                              kind="stable")[..., :top_k.shape[-1]]
            check(np.array_equal(top_k.cpu().numpy(), want),
                  f"step {t} layer {layer}: the visit list is not the top "
                  f"{LONG_PRUNE} blocks by bound with ties to the lower id")
            rows += top_k.shape[0] * top_k.shape[1]
            n = int((top_k != top_p).any(dim=-1).sum())
            # layer 0's bounds come from the same inputs on both sides
            check(layer > 0 or n == 0,
                  f"step {t}: layer-0 visit lists differ ({n} rows)")
            differ += n
    check(shadow["calls"] == LONG_STEPS * cfg.n_layers,
          f"{shadow['calls']} kernel calls held against the plain version")
    check(worst <= LOGIT_ATOL,
          f"long-context logits differ by {worst} > {LOGIT_ATOL}")
    print(f"  {LONG_STEPS} teacher-forced steps: each of {shadow['calls']} "
          f"kv_visit_attention calls within {shadow['err']:.4g} of its plain "
          f"version on the same inputs ({shadow['rel']:.4g} of its max "
          f"|plain|; limit {KV_RTOL:.4g}), each visit list the top "
          f"{LONG_PRUNE} by a numpy stable sort; max |logit kernel - plain| "
          f"{worst:.4f} (tolerance {LOGIT_ATOL}, |logit| <= "
          f"{float(lk.abs().max()):.2f}); visit lists: {rows} (b, kv) "
          f"selections, layer 0 equal, {differ} differ past layer 0",
          flush=True)
    del cache_p
    torch.cuda.empty_cache()

    pos = start + LONG_STEPS - 1
    tok = toks[-1]
    dense = build_model(cfg.replace(kv_block_prune=0))
    times = {}
    for name, m in (("pruned", model), ("full", dense)):
        for _ in range(2):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_TIMED_STEPS):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / LONG_TIMED_STEPS * 1e3
        print(f"  warm decode step, B={LONG_B} at {LONG_SLOTS} slots, "
              f"kv_block_prune={m.cfg.kv_block_prune}: {times[name]:.2f} ms "
              f"({LONG_B * 1e3 / times[name]:.1f} tokens/s)", flush=True)
    profile_steps(model, params, cache, tok, pos, times["pruned"])
    return cache, decode_call(model, params, cache, tok, pos)


def decode_call(model, params, cache, tok, pos) -> tuple:
    """One more decode step; the inputs of its layer-0 kv_visit_attention
    call, as the model passes them (int64 ids from the selection, the
    strided views of the cache)."""
    from repro_torch.kernels import ops
    op, calls = ops.kv_visit_attention, []

    def recording(*args, **kw):
        calls.append(args)
        return op(*args, **kw)
    ops.kv_visit_attention = recording
    try:
        model.decode_step(params, cache, tok, pos)
    finally:
        ops.kv_visit_attention = op
    q, kb, vb, ids, p = calls[0]
    return q.clone(), kb, vb, ids.clone(), p.clone()


def device_kernels(fn, reps: int = TIMING_REPS,
                   tries: int = 5) -> tuple[float, float, list]:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm one -> (the
    device ms per call: the summed durations of its device events, the
    device events per call, their names).

    The profiler loses device events now and then: on the H100 a kernel's
    device timestamp can read earlier than its own launch on the host
    clock, and a kernel that then falls before the window's start is
    dropped; a window can also come back with no kernel at all. Every call
    of ``fn`` launches at least one kernel, so a window with fewer device
    events than calls is incomplete: it is printed and taken again, up to
    ``tries`` windows in all. A window with as many events as calls or
    more is returned as it was read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for window in range(1, tries + 1):
        # a warm-up step first: without one the trace can miss more events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]   # the step's span
        if len(dev) >= reps:
            break
        print(f"  profiler window {window} of {tries} kept {len(dev)} device "
              f"events for {reps} calls: incomplete", flush=True)
    us = sum(e.time_range.elapsed_us() for e in dev)
    return us / reps / 1e3, len(dev) / reps, sorted({e.name for e in dev})


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` (the enqueue: Python, checks,
    launch), the device left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def kv_visit_timing(q, kb, vb, ids, pos) -> dict:
    """``kv_visit.kv_visit_attention`` on these inputs: the eager CUDA-event
    ms (``time_ms``), the device ms and device kernels per call
    (``device_kernels``) and the wrapper's host us per call."""
    from repro_torch.kernels import kv_visit

    def call():
        return kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    device_ms, per_call, names = device_kernels(call)
    return {"ms": time_ms(call), "device_ms": device_ms,
            "kernels_per_call": per_call, "kernel_names": names,
            "host_us": host_us(call)}


def kv_bound(q, ids, pos, bs: int) -> tuple[float, str, int]:
    """Bound of one call: the valid keys (ids >= 0, slot <= pos) of the
    listed blocks, their K and V rows read once; q, the ids and the output
    once; 4 * G * hd flops per key -> (ms, by, keys)."""
    _, _, g, hd = q.shape
    first = ids.long() * bs
    keys = int(((pos.long()[:, None, None] - first + 1).clamp(0, bs)
                * (ids >= 0)).sum())
    nbytes = (keys * hd * 2 + 2 * q.numel()) * q.element_size() \
        + ids.numel() * ids.element_size()
    return (*bound_ms(nbytes, 4.0 * g * hd * keys), keys)


def decode_kv_case(pos: list, slots: int, block: int, prune: int,
                   seed: int = 1) -> tuple:
    """One layer of a Qwen3-8B decode step, without the model: token-major
    K/V (B, slots, KV, hd) bf16 from a generator (seed), zeros past each
    row's position; q from the same generator; the visit list as the
    model's prune makes it (the top ``prune`` blocks by the zone-map bound,
    blocks with no valid key last, the block being written first) -> (q, k
    view, v view, ids int64, pos int64), the views block-major. The
    long-context shape: ``pos`` as ``lm_long_part``'s last step, LONG_SLOTS,
    LONG_BLOCK, LONG_PRUNE."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.reducers import topk_ascending_ties
    from repro_torch.models import layers

    cfg = get_config(LM_ARCH)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    b, g, nb = len(pos), cfg.n_heads // kv, slots // block
    pos = torch.tensor(pos, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    written = torch.arange(slots, device="cuda")[None, :] <= pos[:, None]
    k, v = (torch.randn((b, slots, kv, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            .mul_(written[:, :, None, None]) for _ in range(2))
    q = torch.randn((b, kv, g, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kb = k.view(b, nb, block, kv, hd).float()
    w5 = written.view(b, nb, block, 1, 1)
    big = float(torch.finfo(torch.bfloat16).max)
    kmin = torch.where(w5, kb, big).amin(dim=2)
    kmax = torch.where(w5, kb, -big).amax(dim=2)
    del kb
    ub = layers.block_upper_bounds(q.float(), kmin, kmax)
    ub = torch.where(written.view(b, nb, block).any(-1)[:, None, :], ub,
                     float("-inf"))
    cur = torch.arange(nb, device="cuda")[None, :] == (pos // block)[:, None]
    ub = torch.where(cur[:, None, :], float("inf"), ub)
    ids = topk_ascending_ties(ub.reshape(b * kv, nb), prune,
                              largest=True).view(b, kv, prune)

    def view(c):
        return c.view(b, nb, block, kv, hd).permute(0, 3, 1, 2, 4)
    return q, view(k), view(v), ids, pos


def kv_visit_row(cfg, cache, call, server_call) -> dict:
    """Kernel 12 at the long-context shape, on the inputs of the last decode
    step's layer-0 call: against its plain version, two planted faults and
    SDPA over the whole cache with a mask of the same keys; its eager,
    device and host times; the same at the server shape (the multi-block
    set's call with the most valid keys)."""
    import torch.nn.functional as F
    from repro_torch.kernels import kv_visit, ref

    q, kb, vb, ids, pos = call
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    nb = LONG_SLOTS // LONG_BLOCK
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    want = ref.kv_visit_attention_ref(q, kb, vb, ids, pos)
    err, scale = kv_err(got, want)
    check(err <= KV_RTOL * scale, f"kv_visit_attention differs from plain by "
                                  f"{err} > {KV_RTOL} x max |plain| {scale}")
    check(torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids, pos)),
          "kv_visit_attention differs between identical calls")
    check(torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids.int(),
                                                       pos.int())),
          "kv_visit_attention differs between int64 and int32 ids")
    # Planted faults: the kernel on altered inputs, held against the plain
    # output of the true ones, as a kernel with that fault would be. The
    # check above must reject each.
    dropped = ids.clone()
    dropped[..., -1] = -1                      # the last listed block
    tile_start = pos - pos % 128               # the keys of the partial tile
    for fault, args in (("last listed block dropped", (dropped, pos)),
                        ("partial 128-key tile masked", (ids, tile_start - 1))):
        f_err, _ = kv_err(kv_visit.kv_visit_attention(q, kb, vb, *args), want)
        check(f_err > KV_RTOL * scale,
              f"planted fault ({fault}) passes the check: {f_err}")
        print(f"  planted fault, {fault}: max |kernel - plain| {f_err:.4g} "
              f"= {f_err / scale:.4g} of max |plain| {scale:.4g} (limit "
              f"{KV_RTOL:.4g}; sound reading {err / scale:.4g})", flush=True)

    # The library yardstick reads the whole cache: SDPA with a mask of the
    # selected, valid slots per (b, query head).
    slots = torch.arange(LONG_SLOTS, device="cuda")
    sel = torch.zeros((LONG_B, kv, nb), dtype=torch.bool, device="cuda")
    sel.scatter_(2, ids.long(), True)
    mask = sel.repeat_interleave(LONG_BLOCK, dim=2) \
        & (slots[None, None, :] <= pos[:, None, None])
    mask = mask.repeat_interleave(g, dim=1)[:, :, None, :]      # (B, H, 1, S)
    qh = q.reshape(LONG_B, kv * g, 1, hd)
    kf = cache["k"][0].permute(0, 2, 1, 3)                       # (B, KV, S, hd)
    vf = cache["v"][0].permute(0, 2, 1, 3)

    def library():
        return F.scaled_dot_product_attention(qh, kf, vf, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((library().reshape(got.shape).float() - got.float())
                    .abs().max())
    b_ms, by, keys = kv_bound(q, ids, pos, LONG_BLOCK)
    t = kv_visit_timing(q, kb, vb, ids, pos)
    t32 = kv_visit_timing(q, kb, vb, ids.int(), pos.int())
    check(t["kernels_per_call"] == 1 and t32["kernels_per_call"] == 1,
          f"kv_visit_attention launched {t['kernels_per_call']} / "
          f"{t32['kernels_per_call']} device kernels per call (int64 / int32 "
          f"ids and positions): {t['kernel_names']}")
    row = {"name": "kv_visit_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kv_visit.cu",
           "replaces": "src/repro/kernels/kv_visit.py:110", "launches": 0,
           "max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(lambda: ref.kv_visit_attention_ref(q, kb, vb,
                                                                  ids, pos)),
           "bound_ms": b_ms, "bound_by": by, "library_ms": time_ms(library)}
    print(f"  kv_visit_attention, B={LONG_B} KV={kv} G={g} hd={hd}, "
          f"{ids.shape[-1]} of {nb} blocks of {LONG_BLOCK} ({keys} valid keys; "
          f"ids {ids.dtype}, pos {pos.dtype} as the decode step passes them): "
          f"err={err} ms={t['ms']:.4f} device_ms={t['device_ms']:.4f} "
          f"host_us={t['host_us']:.1f} ({t['kernels_per_call']:g} device "
          f"kernel per call: {t['kernel_names']}); int32 ids and pos: "
          f"ms={t32['ms']:.4f} device_ms={t32['device_ms']:.4f}; "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.4f} ({by}) "
          f"library_ms={row['library_ms']:.4f} (SDPA over all {LONG_SLOTS} "
          f"slots; max |SDPA - kernel| {lib_err:.4g})", flush=True)

    q, kb, vb, ids, pos = server_call
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    err, scale = kv_err(got, ref.kv_visit_attention_ref(q, kb, vb, ids, pos))
    check(err <= KV_RTOL * scale, f"server shape: {err} from plain > "
                                  f"{KV_RTOL} x {scale}")
    s_ms, s_by, s_keys = kv_bound(q, ids, pos, kb.shape[3])
    ts = kv_visit_timing(q, kb, vb, ids, pos)
    check(ts["kernels_per_call"] == 1,
          f"server shape: {ts['kernels_per_call']} device kernels per call")
    print(f"  kv_visit_attention at the server shape (B={q.shape[0]} KV="
          f"{q.shape[1]} G={q.shape[2]}, {ids.shape[-1]} of {kb.shape[2]} "
          f"blocks of {kb.shape[3]}, positions {pos.tolist()}, {s_keys} valid "
          f"keys; ids {ids.dtype}, pos {pos.dtype} as the server passes them): "
          f"err={err} ms={ts['ms']:.4f} device_ms="
          f"{ts['device_ms']:.4f} host_us={ts['host_us']:.1f} "
          f"bound_ms={s_ms:.5f} ({s_by})", flush=True)
    return row


def lm_phase() -> dict:
    """The LM decode-serving path at Qwen3-8B's full width and depth ->
    the kernel table's row of kv_visit_attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params
    from repro_torch.models.registry import build_model

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH).replace(kv_block_prune=LM_PRUNE,
                                      kv_block_size=LM_BLOCK)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(LM_SEED))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {count_params(params) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    # The launches of the main path: the served request sets and the
    # long-context decode, each counted from 0; not the planted fault's
    # replay between them (the kernel on altered inputs).
    ops.reset_kernel_launches()
    server_call, fault_case = lm_server_part(
        model, build_model(cfg, backend="torch"), params)
    served = ops.kernel_launches()
    served_fault(model, params, *fault_case)
    del fault_case
    ops.reset_kernel_launches()
    cache, call = lm_long_part(params)
    decoded = ops.kernel_launches()
    launches = {k: served.get(k, 0) + decoded.get(k, 0)
                for k in sorted({*served, *decoded})}
    print(f"  kernel launches on the LM path: {launches} (served sets "
          f"{served}, long-context decode {decoded})", flush=True)
    check(launches.get("kv_visit_attention", 0) > 0,
          "kernel kv_visit_attention was not launched on the LM path")
    row = kv_visit_row(cfg, cache, call, server_call)
    row["launches"] = launches["kv_visit_attention"]
    print(f"  LM phase peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return row


def kv_build_check() -> None:
    """kv_visit.cu's instances: 0 spills in each (``ptxas -v``, from the
    build log kept beside the library), the keys per tile the wrapper plans
    with equal to the kernel's, and the dynamic shared memory (the ring) of
    each per thread block, as the built library reports them."""
    from repro_torch.kernels import _build, kv_visit
    log = _build.BUILD_LOG.get("kv_visit.cu")
    check(log is not None, "kv_visit.cu: no build log (ptxas -v) to read")
    n = len(kv_visit.DTYPES) * len(kv_visit.HEAD_DIMS)
    spills = [int(k) for k in re.findall(r"(\d+) bytes spill stores", log)]
    check(len(spills) == n and not any(spills),
          f"kv_visit.cu spills (ptxas -v, {n} instances): {spills}")
    smem = []
    for dt in kv_visit.DTYPES:
        for hd in kv_visit.HEAD_DIMS:
            tile, nbytes = kv_visit.instance_shape(hd, dt)
            check(tile == kv_visit.tile_keys(hd, dt),
                  f"kv_visit {dt} hd {hd}: the kernel's tile is {tile} keys, "
                  f"the wrapper plans with {kv_visit.tile_keys(hd, dt)}")
            smem.append(f"{str(dt)[6:]} hd {hd}: {nbytes}")
    print(f"  kv_visit.cu: {n} instances, 0 bytes spill stores; dynamic "
          f"shared memory per block (B, as the library reports it): "
          f"{', '.join(smem)}", flush=True)


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
        kv_build_check()

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
        for name, secs in (("engine", eng.build_seconds),
                           ("plain engine", eng_plain.build_seconds)):
            print(f"  {name} build seconds: " + ", ".join(
                f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
        print(f"  device memory allocated: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    with phase("kernels"):
        rows = kernel_phase(eng, queries)

    # The kernels of each path, counted over that path's phase alone.
    scan_kernels = [r for r in rows if r["name"].partition("[")[0] in (
        "multi_scan_tiles", "multi_scan_vertical", "masked_fill_tiles",
        "masked_agg_tiles", "range_scan_tiles", "range_scan_vertical")]
    rowscan_kernels = [r for r in rows if r["name"] == "range_scan_rows"]
    index_kernels = [r for r in rows
                     if r not in scan_kernels and r not in rowscan_kernels]

    def read_launches(kernels, path, by_method=None):
        launches = ops.kernel_launches()
        print(f"  kernel launches on the {path}: {launches}")
        for r in kernels:
            # "multi_scan_visit[vafile]": the multi_scan_visit launches of
            # the vafile path alone
            name, _, method = r["name"].partition("[")
            counts = by_method[method[:-1]] if method else launches
            r["launches"] = counts.get(name, 0)
            check(r["launches"] > 0,
                  f"kernel {r['name']} was not launched on the {path}")

    with phase("slice"):
        ops.reset_kernel_launches()
        topk_peak = slice_phase(eng, eng_plain, oracle, queries)
        read_launches(scan_kernels, "main path")
        print(f"  TopK B=128 peak device memory: {topk_peak / 1e9:.2f} GB")

    with phase("index"):
        ops.reset_kernel_launches()
        by_method = index_phase(eng, eng_plain, oracle, queries)
        read_launches(index_kernels, "two-phase paths", by_method)

    with phase("server"):
        server_phase(eng, ds)

    # The serving slice: the kernels its paths run, counted over each phase.
    def slice_launches(path, names):
        launches = ops.kernel_launches()
        print(f"  kernel launches on the {path}: {launches}", flush=True)
        for name in names:
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was not launched on the {path}")

    with phase("calibrate"):
        ops.reset_kernel_launches()
        calibrate_phase(eng, eng_plain, oracle, queries)
        slice_launches("calibrate phase", (
            "multi_scan_tiles", "multi_scan_vertical", "multi_scan_visit",
            "multi_va_filter_packed"))

    with phase("pipeline"):
        ops.reset_kernel_launches()
        pipeline_phase(eng, ds)
        slice_launches("pipeline phase", ("multi_scan_tiles",
                                          "multi_scan_vertical"))

    with phase("dist"):
        launches = dist_phase(eng, ds, oracle, queries)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  kernel launches on the dist path: {launches}", flush=True)
        for name in ("multi_scan_tiles", "range_scan_tiles",
                     "masked_fill_tiles", "masked_agg_tiles"):
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was not launched on the dist path")

    with phase("rowscan"):
        ops.reset_kernel_launches()
        rowscan_phase(eng, eng_plain, oracle, queries)
        read_launches(rowscan_kernels, "row-scan path")

    with phase("delta"):
        delta_phase(eng, eng_plain, ds, queries)

    # The LM phase needs the card's memory: free both engines first.
    del eng, eng_plain, oracle
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  engines freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated", flush=True)
    with phase("lm"):
        rows.append(lm_phase())

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
