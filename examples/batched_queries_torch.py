"""Batched MDRQ execution on the PyTorch/CUDA port: fused query batches and
the throughput server.

Runs a GMRQB mixed workload three ways — per-query, as one
``MDRQEngine.query_batch`` call, and through the ``MDRQServer`` batching
window — verifies all three agree, and prints the planner's batched
break-even shift (the cost-model result single-query analysis cannot see).
The counterpart of ``examples/batched_queries.py``.

  PYTHONPATH=src python examples/batched_queries_torch.py [n_objects] [--device cpu]

The engine runs on ``cuda`` unless ``--device`` names another device; with
no GPU the default raises. Every timed call ends in the engine's counted
host sync and follows one warm call of the same shapes.
"""
import argparse
import time

import numpy as np

from repro_torch.core import Agg, Count, Ids, MDRQEngine, TopK
from repro_torch.core.planner import CostModel, Planner
from repro_torch.data import gmrqb
from repro_torch.serve.mdrq_server import MDRQServer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=200_000,
                    help="GMRQB records (default 200,000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.n
    print(f"building GMRQB ({n} records, 19 attributes) on {args.device} ...")
    ds = gmrqb.build(n, seed=0)
    eng = MDRQEngine(ds, structures=("scan", "kdtree", "vafile"),
                     device=args.device)
    queries = [q for _, q in gmrqb.mixed_workload(ds, 64, seed=1)]

    # 1) per-query (warm first so we time steady state)
    for q in queries[:8]:
        eng.query(q, "auto")
    t0 = time.perf_counter()
    singles = [eng.query(q, "auto") for q in queries]
    t_single = time.perf_counter() - t0

    # 2) one fused batch (warm once with the same shapes: launch shapes are
    # per pow2 bucket size, so the timed pass measures steady state)
    eng.query_batch(queries)
    t0 = time.perf_counter()
    batched = eng.query_batch(queries)
    t_batch = time.perf_counter() - t0
    stats = eng.last_batch_stats
    assert all(np.array_equal(a, b) for a, b in zip(singles, batched))

    # 3) through the serving window (warm the B=32 bucket shapes, then count)
    server = MDRQServer(eng, max_batch=32, max_wait_s=float("inf"))
    server.serve_all(queries)
    server.reset_stats()
    served = server.serve_all(queries)
    assert all(np.array_equal(a, b) for a, b in zip(singles, served))

    # 4) reduced result shapes (the ResultSpec layer): counts, top-k by an
    # attribute, and aggregates reduce on the device — only the payload
    # crosses to the host, the per-query nonzero never runs
    eng.query_batch(queries, spec=Count())
    t0 = time.perf_counter()
    counts = eng.query_batch(queries, spec=Count())
    t_count = time.perf_counter() - t0
    assert counts == [ids.size for ids in singles]

    top3 = eng.query_batch(queries, spec=TopK(k=3, dim=0))      # oldest 3
    sums = eng.query_batch(queries, spec=Agg("sum", dim=0))     # SUM(age)
    for ids, t3, sm in zip(singles, top3, sums):
        assert set(t3.tolist()) <= set(ids.tolist()) and t3.size <= 3
        assert ids.size == 0 or abs(sm) >= 0.0

    print(f"\nper-query : {len(queries)/t_single:8.1f} qps")
    print(f"one batch  : {len(queries)/t_batch:8.1f} qps  "
          f"(buckets: {stats.method_counts})")
    print(f"count mode : {len(queries)/t_count:8.1f} qps  "
          f"(ints only, {sum(counts)} total matches)")
    k = next(i for i, ids in enumerate(singles) if ids.size)
    print(f"top-3 by age (query {k}): ids {top3[k].tolist()}, "
          f"sum(age) = {sums[k]:.1f}")
    print(f"server B=32: {server.stats.qps:8.1f} qps  "
          f"({server.stats.n_batches} batches, "
          f"mean size {server.stats.mean_batch_size:.1f})")

    print("\nscan-vs-index break-even selectivity vs batch size "
          "(cost model, paper-like n=10M, m=5):")
    p = Planner(eng.hist, CostModel(n=10_000_000, m=5))
    shift = {}
    for b in (1, 8, 32, 128):
        shift[b] = p.break_even_selectivity(batch_size=b)
        print(f"  batch {b:>3}: {shift[b]:.4%}")
    print("result-shape shift at batch 128: "
          f"Ids {p.break_even_selectivity(batch_size=128, spec=Ids()):.4%} "
          f"vs Count {p.break_even_selectivity(batch_size=128, spec=Count()):.4%}")
    return {"counts": counts, "break_even": shift,
            "method_counts": dict(stats.method_counts)}


if __name__ == "__main__":
    main()
