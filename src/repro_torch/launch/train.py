"""Training entrypoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      [--steps 100] [--batch 8] [--seq 128] [--reduced] [--ckpt-dir DIR] \\
      [--device cuda]

Ports ``repro/launch/train.py`` for one device: the MDRQ-filtered data
pipeline (its admission filter runs on the device), AdamW in mixed
precision through the fault-tolerant ``Trainer``, checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` and an automatic resume from its
latest step (the reference's launcher cannot resume: its ``try_resume``
restores into a trainer with no parameters yet; the port's first builds
the structure with ``init_state()``). Runs on ``cuda`` unless ``--device
cpu``; ``--reduced`` is the smoke-scale config. ``run`` returns the
finished ``Trainer``; ``main`` is the command line.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.models.registry import build_model
from repro_torch.train import OptConfig, Trainer, TrainerConfig


def run(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, n_pool=16384, seed=args.seed),
        device=model.device)
    print(f"[train] arch={cfg.name} devices=1 "
          f"admitted={pipe.admitted.size} samples via "
          f"{pipe.filter_stats.method}", flush=True)

    tr = Trainer(model, pipe,
                 OptConfig(peak_lr=args.lr,
                           warmup_steps=max(5, args.steps // 20),
                           decay_steps=args.steps),
                 args.ckpt_dir,
                 TrainerConfig(num_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               log_every=max(1, args.steps // 20)),
                 grad_accum=args.grad_accum, device=model.device)
    if tr.try_resume():
        print(f"[train] resumed at step {tr.step}", flush=True)
    else:
        tr.init_state()
    log = tr.run()
    for r in log:
        print(f"[train] step={r['step']} loss={r['loss']:.4f} "
              f"gnorm={r['grad_norm']:.3f} {r['sec']:.2f}s", flush=True)
    return tr


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
