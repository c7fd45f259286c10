"""Serving entrypoint: continuous batching + MDRQ admission.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
      --kv-prune 4 [--reduced] [--requests 8] [--slots 4] [--device cuda]

Ports ``repro/launch/serve.py``: random-initialised weights (seed
``--seed``), a synthetic request queue served through ``BatchServer``.
``--kv-prune N`` turns on the zone-map KV block prune (blocks of 32 keys,
keep N). Runs on ``cuda`` unless ``--device cpu``. Not ported yet:
``--kv-int8`` (refused; see ROADMAP.md) and ``--ckpt-dir`` (checkpoints come
with training).
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serve import BatchServer, Request, admission_query


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--kv-prune", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.kv_int8:
        ap.error("--kv-int8: int8 KV caches are not ported yet (ROADMAP.md, "
                 "queue 1)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_prune:
        cfg = cfg.replace(kv_block_prune=args.kv_prune, kv_block_size=32)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 16))).astype(np.int32),
                    max_new=args.max_new,
                    features=np.array([rng.random(), 8, 100.0, rng.random()],
                                      np.float32))
            for i in range(args.requests)]
    srv = BatchServer(model, params, slots=args.slots, max_len=args.max_len,
                      device=model.device)
    t0 = time.perf_counter()
    done = srv.serve(reqs, admission_query())
    seconds = time.perf_counter() - t0
    print(f"[serve] completed {len(done)}/{len(reqs)} (admission-filtered) "
          f"in {seconds:.2f} s on {model.device}; kv_prune={args.kv_prune}",
          flush=True)
    for r in done:
        print(f"[serve] req {r.rid}: {r.output[:8].tolist()}...", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
