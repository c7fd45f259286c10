#!/usr/bin/env python3
"""Time the kernels and the query paths of one checkout, for A/B runs.

    python3 tools/kernel_ab.py --root DIR --label NAME --out FILE.json [--kv-only]
    python3 tools/kernel_ab.py --compare FILE.json [FILE.json ...]

The first form imports ``repro_torch`` from ``DIR/src`` (a checkout of this
repository, for example the parent commit unpacked with ``git archive``) and
drives it with the helpers of the ``chip_smoke.py`` that sits beside this
tool, so every checkout is timed by the same code. It builds the checkout's
CUDA kernels and measures, on one card:

- kernel 12, ``kv_visit_attention``, without building Qwen3-8B: one
  layer's token-major K/V from seed 1 and the visit list the model's prune
  makes (``chip_smoke.decode_kv_case``) at the long-context shape (2 x 268
  MB, the decode's last step: 16 of 64 blocks of 512 keys) and at the
  server shape (4 slots of 1,024, 4 of 32 blocks of 32 keys, positions
  ``SERVER_POS``), timed by ``chip_smoke.kv_visit_timing`` (eager
  CUDA-event ms, device ms and device kernels per call by torch.profiler,
  host us per call) with int64 ids and positions (as the decode step
  passes them), with int32 ones, and with int64 ids and int32 positions
  (``mixed``: as the server passes them); the outputs and the plain
  version's are kept for ``--compare``.

With ``--kv-only`` it stops there. Otherwise it builds GMRQB at 10 M x 19 (seed 0) into one engine (scan,
kd-tree, R*-tree, VA-file and the row scan; tile_n = 1024) and measures:

- kernels 1, 2, 5 and 6 as ``chip_smoke.scan_rows`` measures them (the
  columnar scans at the first 128 queries of ``mixed_workload(seed=0)``,
  at the bucket shapes of the main path and at Q = 1), kernels 3 and 4 on
  those masks (``chip_smoke.reducer_rows``), kernel 11 on the row scan's
  copy (``chip_smoke.rows_row``) and kernels 7-10 as
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
results, op counts and launches per call are equal, and every run's
kernel-12 output is within ``chip_smoke.KV_RTOL`` of the first run's plain
output (itself equal in every run). Exits non-zero without a CUDA device.
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
# kernel 12 at the server shape: the positions of chip_smoke's multi-block
# server call with the most valid keys (4 slots, blocks 0-4)
SERVER_POS = [77, 127, 80, 97]
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


def kv_shapes(cs) -> dict:
    """Kernel 12's shapes: (positions, slots, block, prune)."""
    return {"long": ([cs.LONG_SLOTS - 2 - 64 * b for b in range(cs.LONG_B)],
                     cs.LONG_SLOTS, cs.LONG_BLOCK, cs.LONG_PRUNE),
            "server": (SERVER_POS, cs.LM_MAX_LEN, cs.LM_BLOCK, cs.LM_PRUNE)}


def measure_kv(cs, label: str, out: dict) -> None:
    """Kernel 12 at the long-context and the server shape (see the module
    docstring)."""
    from repro_torch.kernels import kv_visit, ref
    out["kv"], out["kv_out"], out["kv_plain"] = {}, {}, {}
    for shape, case in kv_shapes(cs).items():
        q, kb, vb, ids, pos = cs.decode_kv_case(*case)
        got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
        want = ref.kv_visit_attention_ref(q, kb, vb, ids, pos)
        err, scale = cs.kv_err(got, want)
        kv = {"err": err, "bound_ms": cs.kv_bound(q, ids, pos, case[2])[0]}
        for tag, args in (("", (ids, pos)), (" int32", (ids.int(), pos.int())),
                          (" mixed", (ids, pos.int()))):
            t = cs.kv_visit_timing(q, kb, vb, *args)
            for key in ("ms", "device_ms", "host_us", "kernels_per_call"):
                kv[key + tag] = t[key]
            print(f"[{label}] kv_visit_attention {shape}{tag or ' int64'}: "
                  f"ms {t['ms']:.4f} device_ms {t['device_ms']:.4f} host_us "
                  f"{t['host_us']:.1f}, {t['kernels_per_call']:g} device "
                  f"kernels per call {t['kernel_names']}", flush=True)
        out["kv"].update({f"{shape} {k}": v for k, v in kv.items()})
        out["kv_out"][shape] = got.float().flatten().tolist()
        out["kv_plain"][shape] = want.float().flatten().tolist()
        del q, kb, vb


def measure(root: Path, label: str, kv_only: bool = False) -> dict:
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
    out = {"label": label, "root": str(root), "smi": smi, "ms": {},
           "qps": {}, "counts": {}, "launches": {}, "results": {}}
    measure_kv(cs, label, out)
    if kv_only:
        return out
    torch.cuda.empty_cache()
    ds = gmrqb.build(cs.N, seed=cs.SEED)
    eng = MDRQEngine(ds, tile_n=cs.TILE_N, rowscan=True)
    queries = [q for _, q in gmrqb.mixed_workload(ds, Q_N, seed=cs.SEED)]

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops_n, lib_ms,
            rate=cs.PEAK_F32_OPS_PER_S, shape=False):
        out["ms"][name] = ms
        print(f"[{label}] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
              f"{cs.bound_ms(nbytes, ops_n, rate)[0]:.4f})", flush=True)

    cs.reducer_rows(eng, cs.scan_rows(eng, queries, row), row)
    cs.rows_row(eng, queries, row)
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
    import numpy as np
    sys.path.insert(0, str(HERE))
    from chip_smoke import KV_RTOL
    runs = [json.loads(Path(p).read_text()) for p in paths]
    labels = [r["label"] for r in runs]
    print("runs: " + ", ".join(f"{r['label']} ({r['smi']})" for r in runs))
    for section, fmt in (("ms", "{:.4f}"), ("qps", "{:.1f}")):
        keys = [k for k in runs[0][section] if all(k in r[section] for r in runs)]
        for k in keys:
            print(f"{section:<4} {k:<48} " + "  ".join(
                f"{lab}={fmt.format(r[section][k])}" for lab, r in zip(labels, runs)))
    for k in runs[0]["kv"]:
        print(f"kv   {k:<48} " + "  ".join(
            f"{lab}={r['kv'][k]:.4f}" for lab, r in zip(labels, runs)))
    ok = True
    for shape, plain in runs[0]["kv_plain"].items():
        plain = np.asarray(plain)
        limit = KV_RTOL * np.abs(plain).max()
        for r in runs:
            err = float(np.abs(np.asarray(r["kv_out"][shape]) - plain).max())
            same = r["kv_plain"][shape] == runs[0]["kv_plain"][shape]
            print(f"kv   {shape} {r['label']}: max |kernel - plain| {err:.4g} "
                  f"(limit {limit:.4g}); plain output equal to the first "
                  f"run's: {same}")
            if err > limit or not same:
                print(f"MISMATCH kv_visit_attention {shape}: {r['label']}")
                ok = False
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
    ap.add_argument("--kv-only", action="store_true",
                    help="time kernel 12 alone")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    if not (args.root and args.label and args.out):
        ap.error("--root, --label and --out are required")
    result = measure(args.root.resolve(), args.label, args.kv_only)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
