#!/usr/bin/env python3
"""Time the scan and two-phase kernels and the query paths of one checkout,
for A/B runs.

    python3 tools/kernel_ab.py --root DIR --label NAME --out FILE.json
    python3 tools/kernel_ab.py --compare FILE.json [FILE.json ...]

The first form imports ``repro_torch`` from ``DIR/src`` (a checkout of this
repository, for example the parent commit unpacked with ``git archive``) and
drives it with the helpers of the ``chip_smoke.py`` that sits beside this
tool, so every checkout is timed by the same code. It builds the checkout's
CUDA kernels, builds GMRQB at 10 M x 19 (seed 0) into one engine (scan,
kd-tree, R*-tree, VA-file; tile_n = 1024) and measures, on one card:

- kernels 1, 2, 5 and 6 as ``chip_smoke.scan_rows`` measures them (the
  columnar scans at the first 128 queries of ``mixed_workload(seed=0)``,
  at the bucket shapes of the main path and at Q = 1) and kernels 7-10 as
  ``chip_smoke.visit_rows`` does (the visit kernel at the kd-tree's and the
  VA-file's lists for the first 128 queries, ``range_scan_visit`` for one
  query, the VA filter at Q = 128 and 1): each output held equal to its
  plain version, then the mean device ms of 10 launches after a warm one
  (CUDA events);
- ``query_batch(method=m)`` for m = auto at B in {1, 8, 128} and for m in
  scan, scan_vertical, kdtree, rstar, vafile at B in {8, 128}, under
  Count, TopK(k=10, dim=3) and Agg(sum, 3): ``chip_smoke.warm_qps``
  (median of 5 warm calls, 41 at B <= 8) after one call that records the
  op and host-sync counts, the CUDA launches per wrapper and the results,
  so runs of two checkouts can be held equal.

It writes one JSON object to ``--out`` and prints the card's name and power
limit as nvidia-smi gives them. The second form prints each number of the
runs side by side (runs in the order given) and fails unless every run's
results, op counts and launches per call are equal. Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (method, batch sizes) of the qps cells
CELLS = (("auto", (1, 8, 128)), ("scan", (8, 128)),
         ("scan_vertical", (8, 128)), ("kdtree", (8, 128)), ("rstar", (8, 128)),
         ("vafile", (8, 128)))
Q_N = 128
TIMED_CALLS = 5   # warm calls per qps cell (chip_smoke's own cells take 3)
# ... and per cell at B <= 8: a call takes 2-5 ms on the host, whose noise
# is largest there, so its median takes more calls
TIMED_CALLS_SMALL_B = 41


def load(root: Path):
    """Import the package under test from ``root``, then ``chip_smoke`` from
    this tool's checkout; chip_smoke's own imports of ``repro_torch`` then
    resolve to the package already loaded."""
    src = root / "src"
    sys.path.insert(0, str(src))
    import repro_torch

    sys.path.insert(0, str(HERE))
    import chip_smoke

    got = Path(repro_torch.__file__).resolve().parent
    if got != (src / "repro_torch").resolve():
        raise SystemExit(f"kernel_ab: imported repro_torch from {got}")
    drop_scan_hints()
    return chip_smoke


def drop_scan_hints() -> None:
    """A checkout from before the scan wrappers took ``m=`` and ``rows=``
    (the parent of the columnar scan redesign) gets the reference's call:
    the wrappers that lack both keywords are wrapped to drop them. Delete
    once every checkout compared has them."""
    import inspect

    from repro_torch.kernels import multi_scan, range_scan
    for mod, name in ((multi_scan, "multi_scan_tiles"),
                      (multi_scan, "multi_scan_vertical"),
                      (range_scan, "range_scan_tiles")):
        fn = getattr(mod, name)
        params = inspect.signature(fn).parameters
        if "rows" in params:
            continue
        if "m" in params:
            raise SystemExit(f"kernel_ab: {name} takes m= but not rows=")
        print(f"kernel_ab: {name} takes no m= / rows=; they are dropped",
              flush=True)

        def without_hints(*args, _fn=fn, m=None, rows=None, **kw):
            return _fn(*args, **kw)
        setattr(mod, name, without_hints)


def measure(root: Path, label: str) -> dict:
    cs = load(root)
    np, torch = cs.np, cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    from repro_torch.core import Agg, Count, MDRQEngine, QueryBatch, TopK
    from repro_torch.data import gmrqb
    from repro_torch.kernels import _build, ops

    smi = cs.nvidia_smi_line()
    print(f"[{label}] {smi}; root {root}", flush=True)
    _build.build()
    ds = gmrqb.build(cs.N, seed=cs.SEED)
    eng = MDRQEngine(ds, tile_n=cs.TILE_N)
    queries = [q for _, q in gmrqb.mixed_workload(ds, Q_N, seed=cs.SEED)]
    out = {"label": label, "root": str(root), "smi": smi, "ms": {},
           "qps": {}, "counts": {}, "launches": {}, "results": {}}

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops_n, lib_ms,
            rate=cs.PEAK_F32_OPS_PER_S, shape=False):
        out["ms"][name] = ms
        print(f"[{label}] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
              f"{cs.bound_ms(nbytes, ops_n, rate)[0]:.4f})", flush=True)

    cs.scan_rows(eng, queries, row)
    cs.visit_rows(eng, QueryBatch.from_queries(queries[:Q_N]), queries, row)

    for method, sizes in CELLS:
        for b in sizes:
            cs.TIMED_CALLS = TIMED_CALLS_SMALL_B if b <= 8 else TIMED_CALLS
            qs = queries[:b]
            for spec in (Count(), TopK(k=10, dim=3), Agg("sum", 3)):
                key = f"{method} B={b} {spec}"
                ops.reset_counters()
                ops.reset_kernel_launches()
                res = eng.query_batch(qs, method=method, spec=spec)
                out["counts"][key] = ops.counters()
                out["launches"][key] = ops.kernel_launches()
                out["results"][key] = [json.dumps(np.asarray(r).tolist())
                                       for r in res]
                out["qps"][key] = cs.warm_qps(eng, qs, method, spec)
                print(f"[{label}] {key}: {out['qps'][key]:.1f} qps", flush=True)
    return out


def compare(paths: list[str]) -> int:
    runs = [json.loads(Path(p).read_text()) for p in paths]
    labels = [r["label"] for r in runs]
    print("runs: " + ", ".join(f"{r['label']} ({r['smi']})" for r in runs))
    for section, fmt in (("ms", "{:.4f}"), ("qps", "{:.1f}")):
        keys = [k for k in runs[0][section] if all(k in r[section] for r in runs)]
        for k in keys:
            print(f"{section:<4} {k:<48} " + "  ".join(
                f"{lab}={fmt.format(r[section][k])}" for lab, r in zip(labels, runs)))
    ok = True
    for section in ("results", "counts", "launches"):
        for r in runs[1:]:
            if r[section] != runs[0][section]:
                diff = [k for k in runs[0][section]
                        if r[section].get(k) != runs[0][section][k]]
                print(f"MISMATCH {section}: {r['label']} vs {runs[0]['label']}: {diff}")
                ok = False
    print("results, op counts and launches equal across runs" if ok else "FAILED")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--label")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    if not (args.root and args.label and args.out):
        ap.error("--root, --label and --out are required")
    result = measure(args.root.resolve(), args.label)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
