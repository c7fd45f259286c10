"""GMRQB on the PyTorch/CUDA port: the paper's genomic benchmark end to end
(paper §6, Fig. 10).

Builds the 19-dimensional shape-faithful GMRQB stand-in, measures Table 1
selectivities, and runs each template through scan / vertical scan /
kd-tree / VA-file with the planner's choice last. The counterpart of
``examples/gmrqb_demo.py``.

  PYTHONPATH=src python examples/gmrqb_demo_torch.py [n_objects] [--device cpu]

The engine runs on ``cuda`` unless ``--device`` names another device; with
no GPU the default raises. Times are host-clock milliseconds around
``engine.query`` calls, each ending in the engine's counted host sync, after
one warm call of each method.
"""
import argparse
import time

import numpy as np

from repro_torch.core import MDRQEngine
from repro_torch.data import gmrqb

METHODS = ("scan", "scan_vertical", "kdtree", "vafile")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=300_000,
                    help="variation records (default 300,000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.n
    print(f"building GMRQB ({n} variation records, 19 attributes) on "
          f"{args.device} ...")
    ds = gmrqb.build(n, seed=0)
    eng = MDRQEngine(ds, structures=("scan", "kdtree", "vafile"),
                     device=args.device)
    rng = np.random.default_rng(1)

    print(f"\n{'T':>2} {'dims':>5} {'sel (measured)':>15} {'paper':>9}  "
          f"{'scan':>9} {'vertical':>9} {'kdtree':>9} {'vafile':>9}  planner")
    rows = []
    for k in range(1, 9):
        qs = [gmrqb.template(k, rng, ds) for _ in range(5)]
        sel = float(np.mean([ds.selectivity(q) for q in qs]))
        times, answers = {}, {}
        for meth in METHODS:
            eng.query(qs[0], meth)          # warm: the same launch shapes
            t0 = time.perf_counter()
            answers[meth] = [eng.query(q, meth) for q in qs]
            times[meth] = (time.perf_counter() - t0) / len(qs) * 1e3
        assert all(np.array_equal(a, b)
                   for meth in METHODS
                   for a, b in zip(answers[meth], answers["scan"]))
        choice = eng.planner.choose(qs[0])
        paper = gmrqb.PAPER_TABLE1[k - 1].avg_selectivity
        rows.append((k, qs[0].n_queried_dims, sel, choice))
        print(f"{k:>2} {qs[0].n_queried_dims:>5} {sel:>14.5%} {paper:>8.4%}  "
              f"{times['scan']:>7.1f}ms {times['scan_vertical']:>7.1f}ms "
              f"{times['kdtree']:>7.1f}ms {times['vafile']:>7.1f}ms  {choice}")

    mixed = [q for _, q in gmrqb.mixed_workload(ds, 20, seed=3)]
    eng.query(mixed[0], "auto")             # warm
    t0 = time.perf_counter()
    for q in mixed:
        eng.query(q, "auto")
    dt = (time.perf_counter() - t0) / len(mixed) * 1e3
    print(f"\nmixed workload via planner: {dt:.1f} ms/query "
          f"({1000/dt:.0f} qps)")
    return {"templates": rows, "mixed_ms_per_query": dt}


if __name__ == "__main__":
    main()
