"""The port's examples (``examples/*_torch.py``), each run through its
``main`` with ``--device cpu`` at a small size. The three MDRQ examples:
every ``assert`` the example makes holds (each access path, each batch form
and each spec agree with the others), and its returned summary is checked
here against what the engine and numpy give on the same data. The two LM
examples: ``train_lm_torch`` trains a few steps with finite losses, counts
the reference's parameters and resumes from a checkpoint's step;
``serve_lm_torch`` serves exactly the requests whose features satisfy the
admission query in numpy, each its ``max_new`` tokens. The LM examples run
with torch on one thread (``one_torch_thread``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import match_ids_np
from repro_torch.data import DataConfig, FilteredTokenPipeline, gmrqb, synthetic
from repro_torch.models.params import count_params
from repro_torch.models.registry import build_model
from repro_torch.train import OptConfig, Trainer, TrainerConfig

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_agrees_across_paths(capsys):
    out = load("quickstart_torch").main(["4000", "--device", "cpu"])
    assert len(out["plans"]) == 3
    ds = synthetic.synt_uni(4000, 5, seed=0)
    rng = np.random.default_rng(1)
    for (sel, method, n_ids), target in zip(out["plans"],
                                            (0.0001, 0.01, 0.3)):
        q = synthetic.selectivity_targeted_query(ds, target, rng)
        assert n_ids == match_ids_np(ds.cols, q).size
        assert sel == ds.selectivity(q)
        assert method in ("scan", "scan_vertical", "kdtree", "rstar",
                          "vafile")
    assert 0.0 <= out["break_even"] <= 1.0
    assert "memory overhead per structure" in capsys.readouterr().out


def test_gmrqb_demo_prints_every_template(capsys):
    out = load("gmrqb_demo_torch").main(["3000", "--device", "cpu"])
    assert [row[0] for row in out["templates"]] == list(range(1, 9))
    assert out["templates"][-1][1] == 19     # template 8: complete match
    assert out["mixed_ms_per_query"] > 0.0
    printed = capsys.readouterr().out
    assert "mixed workload via planner" in printed


def test_batched_queries_counts_match_numpy():
    out = load("batched_queries_torch").main(["3000", "--device", "cpu"])
    ds = gmrqb.build(3000, seed=0)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 64, seed=1)]
    assert out["counts"] == [match_ids_np(ds.cols, q).size for q in qs]
    assert sum(out["method_counts"].values()) == 64
    assert sorted(out["break_even"]) == [1, 8, 32, 128]


@pytest.fixture
def one_torch_thread():
    """The LM examples' small training steps on one torch thread: on a
    shared 8-core host the default of one thread per core made single steps
    take 0.06-15 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_lm_trains_and_counts_the_reference_parameters(tmp_path,
                                                             one_torch_thread,
                                                             capsys):
    mod = load("train_lm_torch")
    out = mod.main(["--steps", "3", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path)])
    assert out["resumed_from"] is None and out["step"] == 3
    assert [r["step"] for r in out["log"]] == [1]   # log_every 10, step 1
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all()
               for r in out["log"])
    cfg, _, _ = mod.preset_config("demo")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert out["params"] == count_params(params)
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.params import count_params as jax_count_params
    from repro.models.params import split_tree
    from repro.models.registry import build_model as jax_build_model
    jcfg = jax_get_config("smollm_360m").replace(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab_size", "head_dim", "remat")})
    jp = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert out["params"] == jax_count_params(split_tree(jp)[0])
    printed = capsys.readouterr().out
    assert "fresh start" in printed and f"params={out['params']:,}" in printed


def test_train_lm_resumes_from_a_checkpoint(tmp_path, one_torch_thread,
                                            capsys):
    """A directory holding a checkpoint at step 2 (a short Trainer run of
    the demo preset on the example's pipeline): the example resumes there
    and runs to --steps."""
    mod = load("train_lm_torch")
    cfg, seq, batch = mod.preset_config("demo")
    model = build_model(cfg, device="cpu")
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        n_pool=mod.N_POOL, seed=0), device="cpu")
    tr = Trainer(model, pipe, OptConfig(peak_lr=3e-3, warmup_steps=20,
                                        decay_steps=4), str(tmp_path),
                 TrainerConfig(num_steps=2, ckpt_every=2), device="cpu")
    tr.init_state()
    tr.run()
    assert tr.ckpt.all_steps() == [2]
    out = mod.main(["--steps", "4", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path)])
    assert out["resumed_from"] == 2 and out["step"] == 4
    assert out["checkpoints"] == [2]
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out


def test_serve_lm_admits_by_the_query_and_serves_max_new(one_torch_thread):
    mod = load("serve_lm_torch")
    out = mod.main(["--device", "cpu"])
    losses = out["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    feats = out["features"]
    assert len(feats) == mod.N_REQUESTS
    want = {rid for rid, f in feats.items()
            if mod.MIN_PRIORITY <= f[0] <= 1.0 and 0.0 <= f[3] <= mod.MAX_COST}
    assert 0 < len(want) < mod.N_REQUESTS
    assert set(out["served"]) == want
    vocab = mod.model_config().vocab_size
    for tokens in out["served"].values():
        assert tokens.shape == (mod.MAX_NEW,)
        assert tokens.min() >= 0 and tokens.max() < vocab


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", ["256"]), ("gmrqb_demo_torch", ["256"]),
    ("batched_queries_torch", ["256"]), ("train_lm_torch", ["--steps", "1"]),
    ("serve_lm_torch", [])])
def test_examples_default_to_cuda(name, argv):
    """Without a GPU the default device raises; no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)
