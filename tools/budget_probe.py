#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s budget and pipeline phases on one checkout.

    python3 tools/budget_probe.py --root DIR --label NAME --out FILE.json [--n N]

Imports ``repro_torch`` from ``DIR/src`` (a checkout of this repository,
for example the parent commit unpacked with ``git archive``) and drives it
with the helpers of the ``chip_smoke.py`` beside this tool, so two
checkouts are measured by the same code. On one card it builds GMRQB at
``--n`` rows x 19 (default ``chip_smoke.N``, seed 0) into an engine of the
four structures and its plain-backend twin, then runs, in order:

- the ``pipeline`` phase (2,048 Count + 256 Ids queries through
  ``MDRQServer`` and ``serve_pipelined``; its pipelined / synchronous wall
  qps ratios);
- the ``budget`` phase, frozen: every certified path at B = 128 of
  ``mixed_workload(seed=0)`` (Ids at 32) under Count, Agg sum, TopK d3 and
  Ids — counted launches and syncs per stage against
  ``BUDGET_torch.json``, uncounted syncs under
  ``torch.cuda.set_sync_debug_mode`` with their call sites,
  ``launch_batch``'s host ms against the device ms;
- the same under a live delta (``chip_smoke``'s ingest scaled to ``--n``:
  1% appended, 1.1% deleted, on both engines).

A fault is reported, not raised, so a checkout that breaks the budget is
measured whole. It writes every row to ``--out`` and prints the card's name
and power limit as nvidia-smi gives them. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load(root: Path):
    """Import the package under test from ``root``, then ``chip_smoke``
    from this tool's checkout."""
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    sys.path.insert(0, str(HERE))
    import chip_smoke
    print(f"repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    return chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()
    cs = load(args.root.resolve())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("budget_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import MDRQEngine
    from repro_torch.data import gmrqb

    n = args.n or cs.N
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    ds = gmrqb.build(n, seed=cs.SEED)
    eng = MDRQEngine(ds, tile_n=cs.TILE_N)
    eng_plain = MDRQEngine(ds, tile_n=cs.TILE_N, backend="torch")
    queries = [q for _, q in gmrqb.mixed_workload(ds, cs.BUDGET_BATCH,
                                                  seed=cs.SEED)]
    out = {"label": args.label, "root": str(args.root), "n": n,
           "device": smi}
    with cs.phase("pipeline"):
        out["pipeline_ratio"] = cs.pipeline_phase(eng, ds)
    with cs.phase("budget:frozen"):
        out["frozen"] = cs.budget_phase(eng, eng_plain, queries, "frozen",
                                        strict=False)
    extra = gmrqb.build(max(1, n // 100), seed=1).rows()
    rng = np.random.default_rng(1)
    dead = np.concatenate([rng.choice(n, n // 100, replace=False),
                           n + rng.choice(len(extra), len(extra) // 10,
                                          replace=False)])
    for e in (eng, eng_plain):
        e.append(extra)
        e.delete(dead)
    with cs.phase("budget:delta"):
        out["delta"] = cs.budget_phase(eng, eng_plain, queries, "delta",
                                       strict=False)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
