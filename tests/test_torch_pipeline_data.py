"""The port's MDRQ-filtered training data pipeline against the reference's,
on the CPU.

The same ``DataConfig`` builds both pipelines: the same numpy sample
features, the admission filter (a partial-match MDRQ on 3 of the 8
features, ``method="auto"`` over the scan and the kd-tree) run through each
package's engine, and the token batches. Everything here is exact: the
admitted ids, the planner's pick, and every array of ``batch(0..3)``.
"""
import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import FilteredTokenPipeline as JaxPipeline
from repro_torch.data import (DataConfig, FilteredTokenPipeline,
                              default_filter)
from repro_torch.data.pipeline import FEATURES
from repro_torch.kernels import ops

CASES = [dict(vocab_size=512, seq_len=32, global_batch=8, n_pool=1024,
              seed=1),
         dict(vocab_size=49152, seq_len=24, global_batch=4, n_pool=2048,
              seed=0),
         dict(vocab_size=512, seq_len=16, global_batch=3, n_pool=4096,
              seed=2, filter_query={1: (0.0, 0.05), 6: (3.0, 5.0)})]


@pytest.mark.parametrize("kw", CASES, ids=["n1024", "n2048", "narrow"])
def test_pipeline_matches_reference(kw):
    want = JaxPipeline(JaxDataConfig(**kw))
    ops.reset_counters()
    got = FilteredTokenPipeline(DataConfig(**kw), device="cpu")
    assert ops.counter("host_sync") >= 1   # the ids came back counted
    np.testing.assert_array_equal(got.features.cols,
                                  np.asarray(want.features.cols))
    np.testing.assert_array_equal(np.asarray(got.admitted),
                                  np.asarray(want.admitted))
    assert got.filter_stats.method == want.filter_stats.method
    assert got.filter_stats.n_results == want.filter_stats.n_results
    for step in range(4):
        a, b = got.batch(step), want.batch(step)
        assert set(a) == set(b) == {"tokens", "labels", "sample_ids"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_iterate_resumes_at_its_step_and_closes():
    pipe = FilteredTokenPipeline(DataConfig(**CASES[0]), prefetch=2,
                                 device="cpu")
    it = pipe.iterate(start_step=5)
    try:
        for step in (5, 6, 7):
            got = next(it)
            want = pipe.batch(step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_default_filter_and_features():
    assert default_filter() == {0: (0.5, 1.0), 2: (0.2, 1.0), 4: (0.0, 0.3)}
    assert len(FEATURES) == 8
    pipe = FilteredTokenPipeline(DataConfig(**CASES[0]), device="cpu")
    cols = pipe.features.cols
    keep = ((cols[0] >= 0.5) & (cols[0] <= 1.0) & (cols[2] >= 0.2)
            & (cols[2] <= 1.0) & (cols[4] >= 0.0) & (cols[4] <= 0.3))
    np.testing.assert_array_equal(np.sort(pipe.admitted), np.nonzero(keep)[0])


def test_a_filter_that_admits_nothing_raises():
    cfg = DataConfig(**{**CASES[0], "filter_query": {0: (2.0, 3.0)}})
    with pytest.raises(ValueError, match="admitted zero"):
        FilteredTokenPipeline(cfg, device="cpu")


def test_pipeline_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilteredTokenPipeline(DataConfig(**CASES[0]))
