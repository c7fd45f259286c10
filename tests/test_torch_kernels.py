"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version (the CUDA kernels build and run only on the card, where
``chip_smoke.py`` holds them against the same plain versions). Here those
plain versions meet the reference's Pallas kernels, called directly with
``interpret=True``, on the same numpy inputs. Masks are discrete: exactly
equal. Aggregates: min/max exactly equal; sums to rtol=1e-5 (float32 sums
taken in a different order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import multi_scan as jms
from repro.kernels import range_scan as jrs
from repro.kernels import reducers as jred
from repro_torch import obs
from repro_torch.core import QueryBatch, RangeQuery
from repro_torch.kernels import multi_scan, ops, range_scan, ref, reducers

TILE_N = 512
N = 4000          # pads to 4096: the last tile holds +inf padding objects
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def reset_port_counters():
    ops.reset_counters()
    ops.reset_kernel_launches()
    obs.registry().reset()
    yield


def _data(m, seed):
    rng = np.random.default_rng(seed)
    cols = rng.random((m, N), dtype=np.float32)
    cols[0] = rng.integers(0, 4, size=N)  # a categorical row: many ties
    padded, _, _ = ops.prepare_columnar(cols, tile_n=TILE_N)
    return cols, padded


def _queries(cols, n_q, seed):
    """Alternating complete- and partial-match boxes around real records."""
    rng = np.random.default_rng(seed)
    m, n = cols.shape
    out = []
    for k in range(n_q):
        a = cols[:, rng.integers(n)]
        b = cols[:, rng.integers(n)]
        lo, up = np.minimum(a, b), np.maximum(a, b)
        if k % 2:
            dims = rng.choice(m, size=int(rng.integers(1, m + 1)), replace=False)
            out.append(RangeQuery.partial(
                m, {int(d): (float(lo[d]), float(up[d])) for d in dims}))
        else:
            out.append(RangeQuery.complete(lo, up))
    return QueryBatch.from_queries(out)


def _inputs(m, n_q, seed):
    cols, padded = _data(m, seed)
    batch = _queries(cols, n_q, seed + 1)
    lo, up = batch.bounds_columnar(padded.shape[0])
    return cols, padded, batch, lo, up


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("m", [5, 19])
@pytest.mark.parametrize("n_q", [1, 3, 8, 32])
def test_multi_scan_tiles_matches_pallas(m, n_q):
    _, padded, _, lo, up = _inputs(m, n_q, seed=m * 100 + n_q)
    want = np.asarray(jms.multi_scan_tiles(jnp.asarray(padded), jnp.asarray(lo),
                                           jnp.asarray(up), tile_n=TILE_N,
                                           interpret=True))
    got = multi_scan.multi_scan_tiles(_t(padded), _t(lo), _t(up), tile_n=TILE_N)
    assert got.dtype == torch.int8 and got.shape == (n_q, padded.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [5, 19])
@pytest.mark.parametrize("n_q", [1, 3, 8, 32])
def test_multi_scan_vertical_matches_pallas(m, n_q):
    _, padded, batch, lo, up = _inputs(m, n_q, seed=m * 100 + n_q + 7)
    ids = batch.padded_dim_ids()
    want = np.asarray(jms.multi_scan_vertical(
        jnp.asarray(padded), jnp.asarray(ids), jnp.asarray(lo), jnp.asarray(up),
        tile_n=TILE_N, interpret=True))
    got = multi_scan.multi_scan_vertical(_t(padded), _t(ids), _t(lo), _t(up),
                                         tile_n=TILE_N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [5, 19])
@pytest.mark.parametrize("k", [0, 1])  # complete-match, partial-match
def test_range_scan_tiles_matches_pallas(m, k):
    _, padded, batch, lo, up = _inputs(m, 2, seed=m + k)
    lo1, up1 = lo[:, k:k + 1], up[:, k:k + 1]
    want = np.asarray(jrs.range_scan_tiles(jnp.asarray(padded), jnp.asarray(lo1),
                                           jnp.asarray(up1), tile_n=TILE_N,
                                           interpret=True))
    got = range_scan.range_scan_tiles(_t(padded), _t(lo1), _t(up1), tile_n=TILE_N)
    assert got.shape == (padded.shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [5, 19])
def test_range_scan_vertical_matches_pallas(m):
    _, padded, batch, lo, up = _inputs(m, 2, seed=m + 11)
    dims = np.nonzero(batch[1].dims_mask)[0].astype(np.int32)
    lo1, up1 = lo[:, 1:2], up[:, 1:2]
    want = np.asarray(jrs.range_scan_vertical(
        jnp.asarray(padded), jnp.asarray(dims), jnp.asarray(lo1),
        jnp.asarray(up1), tile_n=TILE_N, interpret=True))
    got = range_scan.range_scan_vertical(_t(padded), _t(dims), _t(lo1), _t(up1),
                                         tile_n=TILE_N)
    np.testing.assert_array_equal(got.numpy(), want)


def _masks(n_q, n_pad, seed):
    rng = np.random.default_rng(seed)
    masks = (rng.random((n_q, n_pad)) < 0.3).astype(np.int8)
    masks[0, :] = 0 if n_q > 1 else masks[0, :]   # one empty match set
    return masks


@pytest.mark.parametrize("n_q", [1, 3, 8, 32])
@pytest.mark.parametrize("fill", [float("-inf"), float("inf")])
def test_masked_fill_matches_pallas(n_q, fill):
    _, padded = _data(19, seed=n_q)
    masks = _masks(n_q, padded.shape[1], seed=n_q + 1)
    vals = padded[3]
    want = np.asarray(jred.masked_fill_tiles(jnp.asarray(masks),
                                             jnp.asarray(vals), fill,
                                             tile_n=TILE_N, interpret=True))
    got = reducers.masked_fill_tiles(_t(masks), _t(vals), fill, tile_n=TILE_N)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("n_q", [1, 3, 8, 32])
def test_masked_agg_matches_pallas(op, n_q):
    _, padded = _data(19, seed=n_q + 3)
    masks = _masks(n_q, padded.shape[1], seed=n_q + 4)
    vals = padded[2]
    jagg, jcounts = jred.masked_agg(jnp.asarray(masks), jnp.asarray(vals), op,
                                    tile_n=TILE_N, interpret=True)
    agg, counts = reducers.masked_agg(_t(masks), _t(vals), op, tile_n=TILE_N,
                                      backend="auto")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    if op == "sum":
        np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=SUM_RTOL)
    else:
        np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n_q,k", [(3, 10), (32, 40)])
def test_masked_topk_ties_order_like_pallas(largest, n_q, k):
    """Row 0 is categorical (values 0..3): the k-th value is a long tie run,
    and positions must come back ascending within it, as the reference's."""
    _, padded = _data(5, seed=k)
    masks = _masks(n_q, padded.shape[1], seed=k + 1)
    vals = padded[0]
    jv, ji, jc = jred.masked_topk(jnp.asarray(masks), jnp.asarray(vals), k,
                                  largest, tile_n=TILE_N, interpret=True)
    v, i, c = reducers.masked_topk(_t(masks), _t(vals), k, largest,
                                   tile_n=TILE_N, backend="auto")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_plain_torch_topk_would_not_order_ties():
    """The reason for the composite key: ``torch.topk`` alone gives no
    order among equal values, the composite gives ascending positions."""
    key = torch.zeros((1, 200))
    idx = reducers.topk_ascending_ties(key, 40, largest=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(40))


def test_ordered_bits_keep_float_order():
    x = np.array([-np.inf, -3e38, -2.5, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3e38,
                  np.inf], np.float32)
    bits = reducers._ordered_bits(torch.as_tensor(x)).numpy()
    assert np.all(np.diff(bits.astype(np.int64)) > 0)


def test_cpu_wrappers_launch_no_kernel():
    _, padded, batch, lo, up = _inputs(5, 3, seed=5)
    masks = multi_scan.multi_scan_tiles(_t(padded), _t(lo), _t(up), tile_n=TILE_N)
    reducers.masked_agg_tiles(masks, _t(padded[1]), "sum", tile_n=TILE_N)
    reducers.masked_fill_tiles(masks, _t(padded[1]), 0.0, tile_n=TILE_N)
    assert ops.kernel_launches() == {}


@pytest.mark.parametrize("shape,tile_n", [((12, 4096), 512),   # m_pad % 8
                                          ((8, 4000), 512),    # n_pad % tile_n
                                          ((8, 4096), 100)])   # tile_n % 128
def test_wrappers_reject_bad_tiling(shape, tile_n):
    data = torch.zeros(shape)
    bounds = torch.zeros((shape[0], 2))
    with pytest.raises(ValueError):
        multi_scan.multi_scan_tiles(data, bounds, bounds, tile_n=tile_n)


def test_dim_ids_checked_on_the_host():
    with pytest.raises(ValueError, match="out of range"):
        ops.dim_ids_device(np.array([[0, 8]], np.int32), 8, "cpu")
    ids = ops.dim_ids_device(np.array([[0, 7]], np.int32), 8, "cpu")
    assert ids.dtype == torch.int32


def test_unknown_backend_is_rejected():
    _, padded, _, lo, up = _inputs(5, 1, seed=9)
    with pytest.raises(ValueError, match="backend"):
        ops.multi_range_scan(_t(padded), _t(lo), _t(up), tile_n=TILE_N,
                             backend="cuda")


def test_plain_refs_match_reference_refs():
    """ref.py against the reference's jnp oracles (the XLA backend)."""
    from repro.kernels import ref as jref
    _, padded, batch, lo, up = _inputs(19, 8, seed=21)
    ids = batch.padded_dim_ids()
    d, l, u = jnp.asarray(padded), jnp.asarray(lo), jnp.asarray(up)
    np.testing.assert_array_equal(
        ref.multi_scan_ref(_t(padded), _t(lo), _t(up)).numpy(),
        np.asarray(jref.multi_scan_ref(d, l, u)))
    np.testing.assert_array_equal(
        ref.multi_scan_vertical_ref(_t(padded), _t(ids), _t(lo), _t(up)).numpy(),
        np.asarray(jref.multi_scan_vertical_ref(d, jnp.asarray(ids), l, u)))
    np.testing.assert_array_equal(
        ref.range_scan_ref(_t(padded), _t(lo[:, :1]), _t(up[:, :1])).numpy(),
        np.asarray(jref.range_scan_ref(d, l[:, :1], u[:, :1])))
