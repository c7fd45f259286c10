"""End-to-end training on the PyTorch/CUDA port: MDRQ-filtered pipeline ->
train -> checkpoint -> resume, with the fault-tolerant trainer. The
counterpart of ``examples/train_lm.py``, with its presets:
  demo  — 4 layers, d_model 256, 6.0 M parameters; 200 steps
  100m  — 12 layers, d_model 768, 100.7 M parameters; --steps as budget
          allows

  PYTHONPATH=src python examples/train_lm_torch.py --preset demo \\
      --steps 200 [--ckpt-dir DIR] [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; with no GPU the
default raises. A ``--ckpt-dir`` that holds a checkpoint resumes from its
latest step: the port's ``Trainer.try_resume`` builds the parameter tree
with ``init_state()`` before restoring into it, where the reference's
restores into a trainer with no parameters and its ``run`` then fails
(ROADMAP.md §3, "the launcher resumes"). The parameter count is
``count_params`` of the bare tensors (the reference's takes
``split_tree``'s values of its tagged tree). ``main`` returns a summary:
the parameter count, the step it resumed from (None on a fresh start), the
last step, the logged steps and the checkpoints' steps.
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, FilteredTokenPipeline
from repro_torch.models.params import count_params
from repro_torch.models.registry import build_model
from repro_torch.train import OptConfig, Trainer, TrainerConfig

N_POOL = 16384


def preset_config(name: str):
    """-> (config, sequence length, batch) of a preset."""
    base = get_config("smollm_360m")
    if name == "demo":
        return base.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                            d_ff=1024, vocab_size=8192, head_dim=64,
                            remat="none"), 128, 8
    if name == "100m":
        return base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                            d_ff=2048, vocab_size=32768, head_dim=64,
                            remat="none"), 256, 8
    raise ValueError(name)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="demo", choices=("demo", "100m"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, seq_len, batch = preset_config(args.preset)
    model = build_model(cfg, device=args.device)
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
        n_pool=N_POOL, seed=0), device=model.device)
    print(f"MDRQ sample filter admitted {pipe.admitted.size}/{N_POOL} samples "
          f"via {pipe.filter_stats.method!r} "
          f"(est sel {pipe.filter_stats.est_selectivity:.2%})")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tr = Trainer(model, pipe, OptConfig(peak_lr=3e-3, warmup_steps=20,
                                        decay_steps=args.steps),
                 ckpt_dir, TrainerConfig(num_steps=args.steps,
                                         ckpt_every=max(50, args.steps // 4),
                                         log_every=max(10, args.steps // 20)),
                 device=model.device)
    resumed = None
    if not tr.try_resume():
        tr.init_state()
        print("fresh start")
    else:
        resumed = tr.step
        print(f"resumed from checkpoint at step {tr.step}")
    n_params = count_params(tr.params)
    print(f"model: {cfg.name} preset={args.preset} params={n_params:,} "
          f"seq={seq_len} batch={batch} device={model.device}")

    log = tr.run()
    print(f"\n{'step':>6} {'loss':>8} {'grad_norm':>10} {'s/step':>8}")
    for r in log:
        print(f"{r['step']:>6} {r['loss']:>8.4f} {r['grad_norm']:>10.4f} "
              f"{r['sec']:>8.2f}")
    if log:
        first, last = log[0]["loss"], log[-1]["loss"]
        print(f"\nloss {first:.3f} -> {last:.3f} "
              f"({'DECREASED' if last < first else 'did NOT decrease'}); "
              f"checkpoints in {ckpt_dir}")
    else:
        print(f"\nno step logged (step {tr.step} of {args.steps}); "
              f"checkpoints in {ckpt_dir}")
    return {"params": n_params, "resumed_from": resumed, "step": tr.step,
            "log": log, "checkpoints": tr.ckpt.all_steps()}


if __name__ == "__main__":
    main()
