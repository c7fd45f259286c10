"""Batched serving on the PyTorch/CUDA port: continuous batching + MDRQ
admission control. The counterpart of ``examples/serve_lm.py``.

A small model is briefly trained so generations are structured, then a
mixed request queue (varying priority / cost features) is served through
the BatchServer: the admission filter is a partial-match MDRQ over request
features (the paper's engine as the serving router).

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; with no GPU the
default raises. ``main`` returns a summary: the warm-up losses, every
request's features and the served requests' ids and tokens.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.models.registry import build_model
from repro_torch.serve import BatchServer, Request, admission_query
from repro_torch.train import OptConfig, Trainer, TrainerConfig

N_REQUESTS, MAX_NEW = 12, 8
MAX_COST, MIN_PRIORITY = 0.8, 0.2


def model_config():
    return get_config("smollm_360m").replace(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=1024, head_dim=32, remat="none")


def make_requests(cfg, n: int = N_REQUESTS, seed: int = 0) -> list:
    """The reference's queue: priority and cost uniform in [0, 1), prompts
    of 4-11 tokens, ``MAX_NEW`` new tokens each."""
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n):
        prio = float(rng.random())
        cost = float(rng.random())
        requests.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                int(rng.integers(4, 12))).astype(np.int32),
            max_new=MAX_NEW,
            features=np.array([prio, 8, 100.0, cost], np.float32)))
    return requests


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = model_config()
    model = build_model(cfg, device=args.device)
    pipe = FilteredTokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=48, global_batch=8,
                                            n_pool=4096, seed=0),
                                 device=model.device)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, pipe, OptConfig(peak_lr=2e-3, warmup_steps=10,
                                            decay_steps=120), d,
                     TrainerConfig(num_steps=120, ckpt_every=1000,
                                   log_every=60), device=model.device)
        tr.init_state()
        log = tr.run()
    print(f"warmup train: loss {log[0]['loss']:.2f} -> {log[-1]['loss']:.2f}")

    requests = make_requests(cfg)
    srv = BatchServer(model, tr.params, slots=4, max_len=64,
                      device=model.device)
    q = admission_query(max_cost=MAX_COST, min_priority=MIN_PRIORITY)
    done = srv.serve(requests, q)
    print(f"\nadmitted & served {len(done)}/{len(requests)} requests "
          f"(others rejected by the MDRQ admission filter):")
    for r in done:
        print(f"  req {r.rid:2d} prio={r.features[0]:.2f} "
              f"cost={r.features[3]:.2f} -> {r.output.tolist()}")
    return {"losses": [r["loss"] for r in log],
            "features": {r.rid: r.features for r in requests},
            "served": {r.rid: r.output for r in done}}


if __name__ == "__main__":
    main()
