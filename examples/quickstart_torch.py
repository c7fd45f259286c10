"""Quickstart on the PyTorch/CUDA port: the paper in five minutes.

Builds a 300k x 5 uniform dataset (the shape of the paper's Fig. 6 runs),
runs the same range query through every access path, shows they agree, and
asks the planner where the scan/index break-even sits — the paper's headline
~1%. The counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [n_objects] [--device cpu]

The engine runs on ``cuda`` unless ``--device`` names another device; with
no GPU the default raises. Times are host-clock milliseconds around
``engine.query``, which ends in the engine's counted host sync, after one
warm call of the same method.
"""
import argparse
import time

import numpy as np

from repro_torch.core import MDRQEngine
from repro_torch.data import synthetic

METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=300_000,
                    help="objects (default 300,000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    n, m = args.n, 5
    print(f"building SYNT-UNI {n} x {m} and all access paths on "
          f"{args.device} ...")
    ds = synthetic.synt_uni(n, m, seed=0)
    eng = MDRQEngine(ds, device=args.device)

    rng = np.random.default_rng(1)
    plans = []
    for target in (0.0001, 0.01, 0.3):
        q = synthetic.selectivity_targeted_query(ds, target, rng)
        sel = ds.selectivity(q)
        print(f"\nquery with measured selectivity {sel:.4%}:")
        results = {}
        for meth in METHODS:
            eng.query(q, meth)              # warm: the same launch shapes
            t0 = time.perf_counter()
            ids = eng.query(q, meth)
            dt = (time.perf_counter() - t0) * 1e3
            results[meth] = ids
            extra = ""
            if meth in ("kdtree", "rstar"):
                idx = getattr(eng, meth)
                extra = (f" (visited {idx.last_visited_blocks}/"
                         f"{idx.n_leaves} blocks)")
            print(f"  {meth:14s} {ids.size:7d} ids in {dt:7.2f} ms{extra}")
        assert all(np.array_equal(v, results["scan"])
                   for v in results.values())
        plan = eng.planner.explain(q)
        plans.append((sel, plan.method, int(results["scan"].size)))
        print(f"  planner: est sel {plan.est_selectivity:.4%} -> choose "
              f"{plan.method!r}")

    be = eng.planner.break_even_selectivity()
    print(f"\ncost-model break-even at this scale: {be:.3%}"
          f"  (paper, 1M scale: ~1%; scans win everything below ~1e5 objects)")
    print("memory overhead per structure:", eng.memory_report())
    return {"plans": plans, "break_even": be}


if __name__ == "__main__":
    main()
