#!/usr/bin/env python3
"""Time ``kv_visit_attention`` at decode shapes for each split count.

    python3 tools/kv_split_sweep.py [--out FILE.json]

Qwen3-8B's attention (B = 4, KV = 8, G = 4, hd = 128, bf16) over one
layer's token-major cache, made with the visit list the model's prune makes
by ``chip_smoke.decode_kv_case`` (seed 1), at the shapes of ``SHAPES``:
from the server's (4 listed blocks of 32 keys) to the long-context decode's
(16 of 512). For each shape it launches the kernel at the plan
``kv_visit.split_plan`` picks and at every forced split count 1, 2, 4, ...
up to the list's tiles and ``kv_visit.MAX_SPLIT``, holds each output within
``chip_smoke.KV_RTOL`` of the plain version, and times it by
``chip_smoke.device_kernels`` (device ms per call, torch.profiler). Prints
the card's name and power limit, then one line per (shape, split count).
Exits non-zero without a CUDA device or when an output is off.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

LATE = [1000, 900, 800, 700]   # positions in a 1,024-slot cache
# name -> (positions, slots, block size, listed blocks)
SHAPES = {
    "server": ([77, 127, 80, 97], 1024, 32, 4),
    "bs32 x 8": (LATE, 1024, 32, 8),
    "bs32 x 16": (LATE, 1024, 32, 16),
    "bs64 x 4": (LATE, 1024, 64, 4),
    "bs64 x 8": (LATE, 1024, 64, 8),
    "bs64 x 16": (LATE, 1024, 64, 16),
    "bs128 x 8": ([4000, 3900, 3800, 3700], 4096, 128, 8),
    "bs512 x 4": ([32766 - 64 * b for b in range(4)], 32768, 512, 4),
    "long": ([32766 - 64 * b for b in range(4)], 32768, 512, 16),
}


def forced(n: int):
    """A split plan of (up to) ``n`` splits, in split_plan's form."""
    def plan(bkv, n_visit, bs, tile, sms):
        n_tiles = n_visit * -(-bs // tile)
        tps = -(-n_tiles // n)
        return -(-n_tiles // tps), tps
    return plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("kv_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import kv_visit, ref
    print(cs.nvidia_smi_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = kv_visit.split_plan
    rows, ok = [], True
    for name, (pos, slots, block, prune) in SHAPES.items():
        q, kb, vb, ids, p = cs.decode_kv_case(pos, slots, block, prune)
        want = ref.kv_visit_attention_ref(q, kb, vb, ids, p)
        tile = kv_visit.tile_keys(q.shape[-1], q.dtype)
        n_tiles = prune * -(-block // tile)
        pick = planned(q.shape[0] * q.shape[1], prune, block, tile, sms)[0]
        counts = sorted({n for n in (1, 2, 4, 8, 16, 32)
                         if n <= min(n_tiles, kv_visit.MAX_SPLIT)} | {pick})
        keys = cs.kv_bound(q, ids, p, block)[2]
        for n in counts:
            kv_visit.split_plan = forced(n)
            try:
                err, scale = cs.kv_err(kv_visit.kv_visit_attention(
                    q, kb, vb, ids, p), want)
                ms, per_call, _ = cs.device_kernels(
                    lambda: kv_visit.kv_visit_attention(q, kb, vb, ids, p))
            finally:
                kv_visit.split_plan = planned
            good = err <= cs.KV_RTOL * scale and per_call == 1
            ok &= good
            rows.append({"shape": name, "tiles": n_tiles, "keys": keys,
                         "n_split": n, "plan": n == pick, "device_ms": ms,
                         "rel_err": err / scale})
            print(f"{name:<10} {n_tiles:4d} tiles {keys:7d} keys  splits "
                  f"{n:2d}{' (plan)' if n == pick else '       '}  device_ms "
                  f"{ms:.5f}  rel err {err / scale:.4g}"
                  f"{'' if good else '  FAILED'}", flush=True)
        del q, kb, vb
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
