"""The port's three MDRQ examples (``examples/*_torch.py``), each run through
its ``main`` with ``--device cpu`` at a small size: every ``assert`` the
example makes holds (each access path, each batch form and each spec agree
with the others), and its returned summary is checked here against what
the engine and numpy give on the same data.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import match_ids_np
from repro_torch.data import gmrqb, synthetic

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


@pytest.mark.parametrize("name", ["quickstart_torch", "gmrqb_demo_torch",
                                  "batched_queries_torch"])
def test_examples_default_to_cuda(name):
    """Without a GPU the default device raises; no silent CPU fallback."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(["256"])
