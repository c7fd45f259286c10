"""Carrying a reference engine's state into the port (``engine_from_arrays``).

The system has no weights: what the reference engine holds is the dataset it
was built from, padded onto the device, plus the planner's histograms. The
port's engine built from the same host array must hold the same padded array
bit for bit and the same histograms, and must pad and bound queries alike.
"""
import numpy as np
import pytest
import torch

from repro.core import types as JT
from repro.core.planner import Histograms as JHistograms
from repro.kernels import ops as jops
from repro_torch import obs
from repro_torch.core import QueryBatch, RangeQuery, engine_from_arrays
from repro_torch.core import types as T
from repro_torch.data import gmrqb, synthetic
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    ops.reset_kernel_launches()
    obs.registry().reset()
    yield


def _cols(which):
    if which == "gmrqb":
        return gmrqb.build(5000, seed=1).cols       # m=19 -> m_pad=24
    return synthetic.synt_uni(5000, 5, seed=2).cols  # m=5 -> m_pad=8


@pytest.mark.parametrize("which", ["gmrqb", "synt_uni"])
@pytest.mark.parametrize("tile_n", [512, 1024])
def test_padded_array_is_bit_identical(which, tile_n):
    cols = _cols(which)
    eng = engine_from_arrays(cols, tile_n=tile_n, device="cpu")
    got = eng.columnar.data_dev.numpy()
    want = jops.prepare_columnar(cols, tile_n)[0]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (eng.columnar.m, eng.columnar.n) == cols.shape


@pytest.mark.parametrize("which", ["gmrqb", "synt_uni"])
def test_histograms_match_reference(which):
    cols = _cols(which)
    got = engine_from_arrays(cols, device="cpu").hist
    want = JHistograms.build(JT.Dataset(cols))
    assert got.n == want.n
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_padding_contract():
    cols = _cols("synt_uni")
    data = engine_from_arrays(cols, tile_n=512, device="cpu").columnar.data_dev
    m, n = cols.shape
    assert torch.all(data[m:, :n] == 0.0)             # dim padding rows
    assert torch.all(torch.isposinf(data[:, n:]))     # object padding


@pytest.mark.parametrize("q_pad", [None, 8])
def test_query_bounds_and_dim_ids_match_reference(q_pad):
    rng = np.random.default_rng(3)
    m = 19
    queries = [RangeQuery.partial(m, {1: (0.1, 0.5), 4: (0.0, 0.0)}),
               RangeQuery.complete(rng.random(m), rng.random(m) + 1),
               RangeQuery.partial(m, {})]
    batch = QueryBatch.from_queries(queries)
    jbatch = JT.QueryBatch(batch.lower, batch.upper)
    for got, want in zip(batch.bounds_columnar(24, q_pad),
                         jbatch.bounds_columnar(24, q_pad)):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(batch.padded_dim_ids(q_pad),
                                  jbatch.padded_dim_ids(q_pad))


def test_match_all_bounds_are_finite_dtype_extrema():
    lo, up = T.finite_query_bounds(np.array([-np.inf, 0.0], np.float32),
                                   np.array([np.inf, 1.0], np.float32),
                                   dtype=torch.float32)
    jlo, jup = JT.finite_query_bounds(np.array([-np.inf, 0.0], np.float32),
                                      np.array([np.inf, 1.0], np.float32))
    assert np.isfinite(lo).all() and np.isfinite(up).all()
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(up, jup)
    assert up[0] == torch.finfo(torch.float32).max


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        engine_from_arrays(_cols("synt_uni"))
