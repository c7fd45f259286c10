#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every result.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases, one status line each; any failed check raises and the script exits
non-zero without printing a result:

  1. device  — require CUDA (no fallback); print the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  3. data    — GMRQB, 10 M records x 19 attributes (seed 0), padded to
               (24, 10,000,384) float32 on the card; the engine under test and
               a second engine running the plain PyTorch versions
               (``backend="torch"``) on the same card.
  4. kernels — each hand kernel against its plain version at the main path's
               shapes (Q = 1 and Q = 128): masks exactly equal, aggregates
               within float32 summation tolerance, repeated sums bit-identical;
               CUDA-event times of the kernel, its plain version and, where one
               exists, the one-call PyTorch equivalent.
  5. slice   — the main path: ``MDRQEngine.query_batch(method="auto")`` on the
               GMRQB mixed workload at B in {1, 8, 32, 128} under Ids, Count,
               Mask, two TopK and three Agg specs, plus ``engine.query`` singles.
               Every result equals the plain-backend engine's; a sample equals
               the numpy oracle; each bucket costs exactly one fused launch and
               one host sync; every kernel of the path was launched.
  6. server  — ``MDRQServer(max_batch=64).serve_all`` on 256 queries under
               Count, against ``query_batch``.

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
ORACLE_SAMPLE = 16        # queries per (B, spec) checked against numpy
N_SINGLES = 8             # engine.query singles on the main path
SERVER_QUERIES = 256
TIMING_REPS = 10
# float32 sums taken in different orders (kernel tree vs torch vs numpy
# pairwise) over non-negative values: relative difference bound.
AGG_SUM_RTOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate outside
# the tensor cores, for the bound column.
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
    return rows


def slice_phase(eng, eng_plain, ds, queries):
    """The main path, checked against the plain engine and numpy."""
    from repro_torch.core import Agg, Count, Ids, Mask, TopK, match_ids_np
    from repro_torch.kernels import ops

    specs = (Ids(), Count(), Mask(), TopK(k=10, dim=3),
             TopK(k=10, dim=4, largest=False), Agg("sum", 3), Agg("min", 2),
             Agg("max", 18))
    oracle: dict[int, np.ndarray] = {}

    def oracle_ids(i):
        if i not in oracle:
            oracle[i] = match_ids_np(ds.cols, queries[i])
        return oracle[i]

    bucket_op = {"scan": "multi_scan_reduce",
                 "scan_vertical": "multi_scan_vertical_reduce"}
    topk_peak = None
    for b in BATCH_SIZES:
        qs = queries[:b]
        for spec in specs:
            if b == 128 and spec.kind == "topk":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_counters()
            got = eng.query_batch(qs, method="auto", spec=spec)
            counts = ops.counters()
            buckets = eng.last_batch_stats.method_counts
            want_counts = {bucket_op[m]: 1 for m in buckets}
            want_counts["host_sync"] = len(buckets)
            check(counts == want_counts,
                  f"B={b} {spec}: counters {counts} != {want_counts}")
            if b == 128 and spec.kind == "topk":
                topk_peak = max(topk_peak or 0, torch.cuda.max_memory_allocated())
            plain = eng_plain.query_batch(qs, method="auto", spec=spec)
            for k, (x, y) in enumerate(zip(got, plain)):
                check(same_result(spec, x, y),
                      f"B={b} {spec} query {k}: kernel {x!r} != plain {y!r}")
            for k in range(min(b, ORACLE_SAMPLE)):
                want = spec.from_ids(oracle_ids(k), ds.cols)
                check(same_result(spec, got[k], want),
                      f"B={b} {spec} query {k}: {got[k]!r} != oracle {want!r}")
            t0 = time.perf_counter()
            eng.query_batch(qs, method="auto", spec=spec)
            dt = time.perf_counter() - t0
            print(f"  B={b:<3} {str(spec):<38} warm qps={b / dt:10.1f} "
                  f"methods={buckets}", flush=True)

    for i in range(N_SINGLES):
        q = queries[i]
        want = oracle_ids(i)
        check(np.array_equal(eng.query(q), want), f"single {i}: ids != oracle")
        check(eng.query(q, spec=Count()) == want.size,
              f"single {i}: count != oracle")
    complete = next(q for q in queries if q.is_complete_match)
    check(np.array_equal(eng.query(complete),
                         match_ids_np(ds.cols, complete)),
          "single complete-match query != oracle")
    return topk_peak


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
        eng = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N)
        eng_plain = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                               backend="torch")
        queries = [q for _, q in gmrqb.mixed_workload(ds, 128, seed=SEED)]
        print(f"  GMRQB n={ds.n} m={ds.m}; device array "
              f"{tuple(eng.columnar.data_dev.shape)} float32", flush=True)

    with phase("kernels"):
        rows = kernel_phase(eng, queries)

    with phase("slice"):
        ops.reset_kernel_launches()
        topk_peak = slice_phase(eng, eng_plain, ds, queries)
        launches = ops.kernel_launches()
        print(f"  kernel launches on the main path: {launches}")
        print(f"  TopK B=128 peak device memory: {topk_peak / 1e9:.2f} GB")
        for r in rows:
            r["launches"] = launches.get(r["name"], 0)
            check(r["launches"] > 0,
                  f"kernel {r['name']} was not launched on the main path")

    with phase("server"):
        server_phase(eng, ds)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
