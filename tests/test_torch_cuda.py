"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one (the repository's ``tests/conftest.py`` imports the JAX package, so
run these without it):

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes go past the GMRQB case ``chip_smoke.py`` covers: padded object counts
that force smaller thread blocks, a 100-dimensional dataset whose tile must
shrink to fit shared memory (and whose VA codes take 7 packed words), the
scan kernel at Q in {1, 2, 13, 16, 31, 32, 33, 128} and m_pad in {8, 24,
104} with inf and NaN in a real row and dim_ids padded by repeats, and at
one query past a launch's staged group (Q = qg + 1, with and without
several register passes), visit lists whose length is
not a power of two and whose tail is padding (block -1), and the 64-bit
offsets of a mask or a visit output past 2**31 bytes; the block-major visit
kernel's edge cases (a block every query visits, a list of padding only,
fewer visits than one range, repeated pairs, m_pad in {8, 24, 104}) and the
word-parallel VA filter at m in {1, 15, 16, 17, 19, 32, 33, 100} with
nonzero fields beyond m and bounds outside the cells; the row-major scan at
m in {3, 19, 100}; and the engine under a live delta (appended rows, base and
delta tombstones) on every path. Masks must be exactly equal; sums within
rtol=1e-5 (float32 sums in another order) and bit-identical across repeated
runs; min/max exactly equal. The block-visit decode attention at head dims
32-256, 1-8 query rows per kv head and blocks not a multiple of its tile,
through strided views of a token-major cache (equal to a contiguous copy,
bit-identical across calls, int32 ids and positions equal to int64 ones,
one device kernel per call by torch.profiler), at the split plan's edges
(one visit, more splits than visits, B * KV above the SM count, 64 visits,
padding spread over the splits, a list with no valid key), its masking
edge cases, and the reduced Qwen3 decode on the card against the plain
backend and the CPU. The pipelined MDRQ server on its launch and copy
streams: 20 windows back to back through backlog 4, and an append between
windows, equal to the synchronous server in order; its warm set complete
after ``warmup()``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (Agg, Count, Ids, Mask, MDRQEngine, QueryBatch,
                              RangeQuery, TopK, match_ids_np)
from repro_torch.data import gmrqb
from repro_torch.kernels import (multi_scan, ops, range_scan, ref, reducers,
                                 va_filter)

pytestmark = pytest.mark.cuda
SUM_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops.reset_kernel_launches()
    return torch.device("cuda")


def _case(m, n, n_q, tile_n, seed, dev):
    rng = np.random.default_rng(seed)
    cols = rng.random((m, n), dtype=np.float32)
    cols[0] = rng.integers(0, 3, size=n)   # ties for the top-k
    padded, _, _ = ops.prepare_columnar(cols, tile_n)
    qs = []
    for k in range(n_q):
        a, b = cols[:, rng.integers(n)], cols[:, rng.integers(n)]
        lo, up = np.minimum(a, b) - 0.2, np.maximum(a, b) + 0.2
        if k % 2:
            dims = rng.choice(m, size=int(rng.integers(1, min(m, 40) + 1)),
                              replace=False)
            qs.append(RangeQuery.partial(
                m, {int(d): (float(lo[d]), float(up[d])) for d in dims}))
        else:
            qs.append(RangeQuery.complete(lo, up))
    batch = QueryBatch.from_queries(qs)
    lo, up = batch.bounds_columnar(padded.shape[0])
    return (torch.as_tensor(padded, device=dev), batch,
            torch.as_tensor(lo, device=dev), torch.as_tensor(up, device=dev))


SHAPES = [(5, 2900, 1, 128), (5, 2900, 33, 128), (19, 20000, 64, 1024),
          (100, 4096, 40, 512)]


@pytest.mark.parametrize("m,n,n_q,tile_n", SHAPES)
def test_scan_kernels_match_plain(dev, m, n, n_q, tile_n):
    data, batch, lo, up = _case(m, n, n_q, tile_n, seed=m + n_q, dev=dev)
    got = multi_scan.multi_scan_tiles(data, lo, up, tile_n=tile_n)
    assert torch.equal(got, ref.multi_scan_ref(data, lo, up))
    ids = torch.as_tensor(batch.padded_dim_ids(), device=dev)
    got = multi_scan.multi_scan_vertical(data, ids, lo, up, tile_n=tile_n)
    assert torch.equal(got, ref.multi_scan_vertical_ref(data, ids, lo, up))
    one = range_scan.range_scan_tiles(data, lo[:, :1].contiguous(),
                                      up[:, :1].contiguous(), tile_n=tile_n)
    assert torch.equal(one, ref.range_scan_ref(data, lo[:, :1], up[:, :1]))
    k = 1 if n_q > 1 else 0
    dims = torch.as_tensor(np.nonzero(batch[k].dims_mask)[0].astype(np.int32),
                           device=dev)
    lk, uk = lo[:, k:k + 1].contiguous(), up[:, k:k + 1].contiguous()
    one = range_scan.range_scan_vertical(data, dims, lk, uk, tile_n=tile_n)
    d = dims.long()
    assert torch.equal(one, ref.range_scan_ref(data[d], lk[d, 0], uk[d, 0]))
    assert ops.kernel_launches() == {"multi_scan_tiles": 1,
                                     "multi_scan_vertical": 1,
                                     "range_scan_tiles": 1,
                                     "range_scan_vertical": 1}


def _scan_case(m, n, n_q, seed, dev, q_pad=None):
    """Data with +inf padding objects and inf, -inf and NaN planted in real
    row 1; queries as ``_case`` makes them with query 0 constraining no
    dim (and query 1, where there is one, listing dims in an order the
    kernel reorders); bounds and dim_ids padded to ``q_pad`` columns, by
    default the pow2 bucket (match-all padding columns, rows padded by
    repeats)."""
    from repro_torch.core.types import next_pow2
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 8, size=(m, n)).astype(np.float32)
    cols[min(1, m - 1), rng.choice(n, size=9, replace=False)] = np.repeat(
        np.array([np.inf, -np.inf, np.nan], np.float32), 3)
    padded, _, _ = ops.prepare_columnar(cols, 128)
    qs = [RangeQuery.partial(m, {})]
    for k in range(1, n_q):
        dims = rng.choice(m, size=int(rng.integers(1, min(m, 12) + 1)),
                          replace=False)
        pred = {}
        for d in dims:
            a, b = np.sort(rng.integers(0, 8, size=2))
            pred[int(d)] = (float(a), float(b))
        qs.append(RangeQuery.partial(m, pred))
    batch = QueryBatch.from_queries(qs)
    q_pad = next_pow2(n_q) if q_pad is None else q_pad
    lo, up = batch.bounds_columnar(padded.shape[0], q_pad)
    return (torch.as_tensor(padded, device=dev),
            torch.as_tensor(lo, device=dev), torch.as_tensor(up, device=dev),
            torch.as_tensor(batch.padded_dim_ids(q_pad), device=dev))


@pytest.mark.parametrize("m,n_q", [(m, q) for m in (5, 19, 100)
                                   for q in (1, 2, 13, 16, 31, 32, 33, 128)])
def test_scan_kernels_at_each_query_count(dev, m, n_q):
    """The scan kernel at the query counts its groups and passes turn on,
    at m_pad in {8, 24, 104} (m = 100 takes several register passes):
    the full scan with and without ``m`` and the vertical scan equal their
    plain versions (the vertical one also under a ``rows`` hint too low,
    which forces further passes), and so do the Q = 1 wrappers on query 1."""
    data, lo, up, ids = _scan_case(m, 2900, n_q, seed=m * 1000 + n_q, dev=dev)
    want = ref.multi_scan_ref(data, lo, up)
    assert torch.equal(multi_scan.multi_scan_tiles(data, lo, up, tile_n=128),
                       want)
    assert torch.equal(multi_scan.multi_scan_tiles(data, lo, up, tile_n=128,
                                                   m=m), want)
    want = ref.multi_scan_vertical_ref(data, ids, lo, up)
    assert torch.equal(multi_scan.multi_scan_vertical(data, ids, lo, up,
                                                      tile_n=128), want)
    # a rows hint below the distinct dims listed costs passes, not results
    assert torch.equal(multi_scan.multi_scan_vertical(data, ids, lo, up,
                                                      tile_n=128, rows=1), want)
    k = min(1, n_q - 1)
    lk, uk = lo[:, k:k + 1].contiguous(), up[:, k:k + 1].contiguous()
    assert torch.equal(range_scan.range_scan_tiles(data, lk, uk, tile_n=128,
                                                   m=m),
                       ref.range_scan_ref(data, lk, uk))
    dims = ids[k]
    d = dims.long()
    assert torch.equal(range_scan.range_scan_vertical(data, dims, lk, uk,
                                                      tile_n=128),
                       ref.range_scan_ref(data[d], lk[d, 0], uk[d, 0]))
    assert ops.kernel_launches() == {"multi_scan_tiles": 2,
                                     "multi_scan_vertical": 2,
                                     "range_scan_tiles": 1,
                                     "range_scan_vertical": 1}


@pytest.mark.parametrize("m,n_q,rows", [(19, 221, None), (19, 261, None),
                                        (19, 405, 12), (100, 205, None),
                                        (100, 359, 12)])
def test_scan_kernels_past_one_query_group(dev, m, n_q, rows):
    """Q = qg + 1 of some launch, unpadded: the kernel marks and stages each
    group of queries anew per tile and pass, with the row counts of every
    group summed. The full scan with and without ``m`` and the vertical
    scan, each under the ``rows`` hint (12: six register pairs, so the
    19- or 100-row union takes passes too), equal their plain versions."""
    m_pad = -(-m // 8) * 8
    # (n_pairs, qg) of the full scan with m and without it; the vertical
    # scan launches with the second
    shapes = [range_scan.scan_launch_shape(n_q, m, min(m, rows or m)),
              range_scan.scan_launch_shape(n_q, m_pad, min(m_pad, rows or m_pad))]
    assert any(qg == n_q - 1 for _, qg in shapes), shapes
    data, lo, up, ids = _scan_case(m, 2900, n_q, seed=m * 1000 + n_q, dev=dev,
                                   q_pad=n_q)
    assert lo.shape[1] == n_q
    want = ref.multi_scan_ref(data, lo, up)
    assert torch.equal(multi_scan.multi_scan_tiles(data, lo, up, tile_n=128,
                                                   m=m, rows=rows), want)
    assert torch.equal(multi_scan.multi_scan_tiles(data, lo, up, tile_n=128,
                                                   rows=rows), want)
    assert torch.equal(multi_scan.multi_scan_vertical(data, ids, lo, up,
                                                      tile_n=128, rows=rows),
                       ref.multi_scan_vertical_ref(data, ids, lo, up))
    assert ops.kernel_launches() == {"multi_scan_tiles": 2,
                                     "multi_scan_vertical": 1}


@pytest.mark.parametrize("m,n,n_q,tile_n", SHAPES)
def test_reducer_kernels_match_plain(dev, m, n, n_q, tile_n):
    data, _, lo, up = _case(m, n, n_q, tile_n, seed=m * n_q, dev=dev)
    masks = ref.multi_scan_ref(data, lo, up)
    vals = data[1]
    for fill in (float("-inf"), float("inf"), 0.0):
        assert torch.equal(reducers.masked_fill_tiles(masks, vals, fill,
                                                      tile_n=tile_n),
                           ref.masked_fill_ref(masks, vals, fill))
    for op in ("sum", "min", "max"):
        got = reducers.masked_agg_tiles(masks, vals, op, tile_n=tile_n)
        want = ref.masked_agg_ref(masks, vals, op)
        if op == "sum":
            torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0.0)
            assert torch.equal(got, reducers.masked_agg_tiles(
                masks, vals, op, tile_n=tile_n))
        else:
            assert torch.equal(got, want)
    for largest in (True, False):
        got = reducers.masked_topk(masks, data[0], 12, largest, tile_n=tile_n,
                                   backend="auto")
        want = reducers.masked_topk(masks, data[0], 12, largest,
                                    tile_n=tile_n, backend="torch")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_mask_offsets_past_int32(dev):
    """Q * n_pad > 2**31: rows past the 32-bit boundary are still right."""
    m, n, n_q = 8, 17 * 2 ** 20, 128
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.rand((m, n), device=dev, generator=g)
    lo = torch.full((m, n_q), 0.1, device=dev)
    up = torch.full((m, n_q), 0.9, device=dev)
    lo[0] = torch.linspace(0.0, 0.5, n_q, device=dev)
    got = multi_scan.multi_scan_tiles(data, lo, up, tile_n=1024)
    assert got.numel() > 2 ** 31
    for q in (0, 126, 127):
        assert torch.equal(got[q], ref.range_scan_ref(data, lo[:, q], up[:, q]))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    data = torch.zeros((8, 1024), device=dev, dtype=torch.float64)
    b = torch.zeros((8, 2), device=dev)
    with pytest.raises(TypeError):
        multi_scan.multi_scan_tiles(data, b, b, tile_n=1024)
    strided = torch.zeros((8, 2048), device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        multi_scan.multi_scan_tiles(strided, b, b, tile_n=1024)
    with pytest.raises(ValueError, match="is on"):
        multi_scan.multi_scan_tiles(torch.zeros((8, 1024), device=dev),
                                    b.cpu(), b.cpu(), tile_n=1024)


@pytest.mark.parametrize("spec", [Ids(), Count(), Mask(), TopK(k=10, dim=4),
                                  TopK(k=10, dim=4, largest=False),
                                  Agg("sum", 3), Agg("min", 2), Agg("max", 18)],
                         ids=str)
def test_engine_matches_plain_backend(dev, spec):
    ds = gmrqb.build(50_000, seed=1)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 48, seed=1)]
    got = MDRQEngine(ds, tile_n=1024).query_batch(qs, spec=spec)
    want = MDRQEngine(ds, tile_n=1024, backend="torch").query_batch(qs, spec=spec)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        elif spec.kind == "agg" and spec.op == "sum":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
        else:
            assert g == w or (np.isnan(g) and np.isnan(w))


def _visits(n_q, n_blocks, n_visit, seed, dev):
    """(V,) query and block ids, V not a power of two, the tail padding."""
    rng = np.random.default_rng(seed)
    qids = rng.integers(0, n_q, size=n_visit).astype(np.int32)
    bids = rng.integers(0, n_blocks, size=n_visit).astype(np.int32)
    qids[-5:], bids[-5:] = 0, -1
    return torch.as_tensor(qids, device=dev), torch.as_tensor(bids, device=dev)


@pytest.mark.parametrize("m,n,n_q,tile_n", SHAPES)
def test_visit_kernels_match_plain(dev, m, n, n_q, tile_n):
    data, _, lo, up = _case(m, n, n_q, tile_n, seed=m + 3 * n_q, dev=dev)
    n_blocks = data.shape[1] // tile_n
    qids, bids = _visits(n_q, n_blocks, 3 * n_blocks + 7, seed=n_q, dev=dev)
    blocks = range_scan.blocks_view(data, tile_n)
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=tile_n)
    assert torch.equal(got, ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up))
    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    one = range_scan.range_scan_visit(data, bids, lo1, up1, tile_n=tile_n)
    assert torch.equal(one, ref.multi_scan_blocks_ref(
        blocks, torch.zeros_like(bids), bids, lo1, up1))
    assert ops.kernel_launches() == {"multi_scan_visit": 1,
                                     "range_scan_visit": 1}


@pytest.mark.parametrize("m,n_q", [(5, 1), (19, 33), (19, 128), (100, 40)])
def test_va_filter_kernels_match_plain(dev, m, n_q):
    rng = np.random.default_rng(m + n_q)
    codes = rng.integers(0, 4, size=(m, 20000)).astype(np.uint8)
    packed = np.zeros((-(-m // 16), 20 * 1024), np.int32)  # n pads to 20480
    packed[:, :20000] = va_filter.pack_codes(codes)
    m_s = -(-m // 8) * 8
    lo = np.zeros((m_s, n_q), np.int32)
    hi = np.full((m_s, n_q), 3, np.int32)
    narrow = rng.random((m, n_q)) < min(0.5, 4.0 / m)
    lo[:m][narrow] = rng.integers(0, 3, size=int(narrow.sum()))
    hi[:m][narrow] = np.minimum(lo[:m][narrow] + rng.integers(-1, 3, size=int(narrow.sum())), 3)
    pk = torch.as_tensor(packed, device=dev)
    clo, chi = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    got = va_filter.multi_va_filter_packed(pk, clo, chi, m)
    want = ref.multi_va_filter_packed_ref(pk, clo, chi, m)
    assert torch.equal(got, want) and bool(want.any())
    one = va_filter.va_filter_packed(pk, clo[:, :1].contiguous(),
                                     chi[:, :1].contiguous(), m)
    assert torch.equal(one, ref.va_filter_packed_ref(pk, clo[:, 0], chi[:, 0], m))
    assert ops.kernel_launches() == {"multi_va_filter_packed": 1,
                                     "va_filter_packed": 1}


def test_visit_offsets_past_int32(dev):
    """V * tile_n > 2**31: visit rows past the 32-bit boundary are right."""
    m, tile_n, n_blocks = 8, 1024, 64
    g = torch.Generator(device=dev).manual_seed(1)
    data = torch.rand((m, n_blocks * tile_n), device=dev, generator=g)
    lo = torch.full((m, 2), 0.1, device=dev)
    up = torch.full((m, 2), 0.9, device=dev)
    lo[0, 1] = 0.5
    n_visit = 2 ** 21 + 2 ** 14 + 3
    bids = torch.arange(n_visit, device=dev, dtype=torch.int32) % n_blocks
    qids = (torch.arange(n_visit, device=dev, dtype=torch.int32) // 7) % 2
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=tile_n)
    assert got.numel() > 2 ** 31
    rows = torch.tensor([0, 2 ** 21 - 1, 2 ** 21, n_visit - 1], device=dev)
    want = ref.multi_scan_blocks_ref(range_scan.blocks_view(data, tile_n),
                                     qids[rows], bids[rows], lo, up)
    assert torch.equal(got[rows], want)


def _block_major_case(m, n_q, n_blocks, dev, seed=0):
    """(m_pad, n_blocks * 1024) data of values in [0, 1) with +inf padding,
    (m_pad, n_q) bounds around real records (each query open on half its
    dims, so masks are neither empty nor full)."""
    data, _, lo, up = _case(m, n_blocks * 1024 - 100, n_q, 1024, seed, dev)
    return data, lo, up


def _check_visits(data, qids, bids, lo, up):
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=1024)
    want = ref.multi_scan_blocks_ref(range_scan.blocks_view(data, 1024), qids,
                                     bids, lo, up)
    assert torch.equal(got, want)
    assert torch.equal(got, multi_scan.multi_scan_visit(data, qids, bids, lo, up,
                                                        tile_n=1024))
    return want


@pytest.mark.parametrize("case", ["one_block_every_query", "all_padding",
                                  "fewer_than_a_range", "duplicates"])
def test_block_major_visit_edge_cases(dev, case):
    """The block-major visit kernel (ranges of 64 sorted visits): a block
    every one of 128 queries visits (a run across two ranges), a list of
    padding only (every visit block 0, query 0), V = 5 < 64, and repeated
    (query, block) pairs scattered through the list."""
    rng = np.random.default_rng(7)
    n_q, n_blocks = 128, 20
    data, lo, up = _block_major_case(19, n_q, n_blocks, dev)
    if case == "one_block_every_query":
        surv = rng.random((n_q, n_blocks)) < 0.2
        surv[:, 11] = True
        q, b = np.nonzero(surv)
    elif case == "all_padding":
        q, b = np.zeros(256, np.int32), np.full(256, -1, np.int32)
        lo[:, 0], up[:, 0] = -1.0, 2.0   # query 0 takes block 0's real objects
    elif case == "fewer_than_a_range":
        q, b = rng.integers(0, n_q, 5), rng.integers(0, n_blocks, 5)
    else:
        q, b = rng.integers(0, 4, 300), rng.integers(0, 3, 300)
    qids = torch.as_tensor(q.astype(np.int32), device=dev)
    bids = torch.as_tensor(b.astype(np.int32), device=dev)
    want = _check_visits(data, qids, bids, lo, up)
    assert bool(want.any())
    assert ops.kernel_launches() == {"multi_scan_visit": 2}


@pytest.mark.parametrize("m", [8, 19, 100])
def test_block_major_visit_row_groups(dev, m):
    """m_pad in {8, 24, 104}: one to thirteen groups of eight rows held in
    registers; at 104 the staged bounds of 64 visits take 53 KB of shared
    memory."""
    rng = np.random.default_rng(m)
    n_q, n_blocks = 40, 12
    data, lo, up = _block_major_case(m, n_q, n_blocks, dev, seed=m)
    assert data.shape[0] == -(-m // 8) * 8
    q, b = np.nonzero(rng.random((n_q, n_blocks)) < 0.5)
    qids, bids = (torch.as_tensor(a.astype(np.int32), device=dev) for a in (q, b))
    assert bool(_check_visits(data, qids, bids, lo, up).any())


@pytest.mark.parametrize("m", [1, 15, 16, 17, 19, 32, 33, 100])
def test_va_filter_word_parallel_edges(dev, m):
    """The word-parallel filter at dims that fill a word or spill one field
    into the next, with nonzero fields beyond m, bounds at cells -1 and 4,
    empty intervals and 70 queries (two groups of masks)."""
    rng = np.random.default_rng(100 + m)
    n, n_q = 20000, 70
    codes = rng.integers(0, 4, size=(m, n)).astype(np.uint8)
    w = -(-m // 16)
    packed = np.zeros((w, 20 * 1024), np.int32)
    packed[:, :n] = va_filter.pack_codes(codes)
    keep = (1 << (2 * (m - (w - 1) * 16))) - 1
    if keep != 0xFFFFFFFF:
        junk = rng.integers(0, 2 ** 31, size=packed.shape[1], dtype=np.int64)
        packed[-1] |= (junk & ~keep).astype(np.int32)
    m_s = -(-m // 8) * 8
    lo = np.full((m_s, n_q), -1, np.int32)
    hi = np.full((m_s, n_q), 4, np.int32)
    for q in range(n_q):
        dims = rng.choice(m, size=min(m, 3), replace=False)
        lo[dims, q] = rng.integers(-1, 4, size=dims.size)
        hi[dims, q] = lo[dims, q] + rng.integers(-1, 3, size=dims.size)
    pk = torch.as_tensor(packed, device=dev)
    clo, chi = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    got = va_filter.multi_va_filter_packed(pk, clo, chi, m)
    want = ref.multi_va_filter_packed_ref(pk, clo, chi, m)
    assert torch.equal(got, want) and bool(want.any()) and not bool(want.all())
    for q in (0, 1, n_q - 1):
        one = va_filter.va_filter_packed(pk, clo[:, q: q + 1].contiguous(),
                                         chi[:, q: q + 1].contiguous(), m)
        assert torch.equal(one, want[q])


@pytest.mark.parametrize("spec", [Ids(), Count(), Mask(), TopK(k=10, dim=4),
                                  TopK(k=10, dim=4, largest=False),
                                  Agg("sum", 3), Agg("min", 2), Agg("max", 18)],
                         ids=str)
def test_index_paths_match_plain_backend(dev, spec):
    ds = gmrqb.build(50_000, seed=1)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 48, seed=1)]
    eng = MDRQEngine(ds, tile_n=1024)
    plain = MDRQEngine(ds, tile_n=1024, backend="torch")
    for method in ("kdtree", "rstar", "vafile"):
        got = eng.query_batch(qs, method=method, spec=spec)
        want = plain.query_batch(qs, method=method, spec=spec)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            elif spec.kind == "agg" and spec.op == "sum":
                np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
            else:
                assert g == w or (np.isnan(g) and np.isnan(w))
    launches = ops.kernel_launches()
    assert launches["multi_scan_visit"] == 3
    assert launches["multi_va_filter_packed"] == 1


def test_visit_sums_are_bit_identical(dev):
    """The visit reducers add no float atomics: repeated sums are equal to
    the bit, on every two-phase path."""
    ds = gmrqb.build(50_000, seed=2)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 64, seed=2)]
    eng = MDRQEngine(ds, tile_n=1024)
    for method in ("kdtree", "rstar", "vafile"):
        first = eng.query_batch(qs, method=method, spec=Agg("sum", 3))
        again = eng.query_batch(qs, method=method, spec=Agg("sum", 3))
        assert np.array_equal(np.array(first), np.array(again))


# -- the row-major scan ---------------------------------------------------------

@pytest.mark.parametrize("m", [3, 19, 100])
def test_range_scan_rows_matches_plain(dev, m):
    """n = 200,003 rows pad to 200,192: the last tile holds +inf rows."""
    rng = np.random.default_rng(m)
    n, tile_rows = 200_003, 512
    m_pad, n_pad = -(-m // 8) * 8, -(-n // tile_rows) * tile_rows
    rows = np.zeros((n_pad, m_pad), np.float32)
    rows[:n, :m] = rng.random((n, m), dtype=np.float32)
    rows[n:] = np.inf
    data = torch.as_tensor(rows, device=dev)
    for k in range(3):
        lo = np.full((1, m_pad), np.finfo(np.float32).min, np.float32)
        up = np.full((1, m_pad), np.finfo(np.float32).max, np.float32)
        dims = rng.choice(m, size=min(m, 1 + 2 * k), replace=False)
        lo[0, dims] = rng.random(dims.size) * 0.3
        up[0, dims] = 0.7 + rng.random(dims.size) * 0.3
        lo_t, up_t = torch.as_tensor(lo, device=dev), torch.as_tensor(up, device=dev)
        got = range_scan.range_scan_rows(data, lo_t, up_t, tile_rows=tile_rows)
        want = ref.range_scan_rows_ref(data, lo_t, up_t)
        assert torch.equal(got, want) and bool(want.any())
        assert not bool(got[n:].any())
    assert ops.kernel_launches() == {"range_scan_rows": 3}


def test_range_scan_rows_rejects_what_the_kernel_does_not_take(dev):
    b = torch.zeros((1, 8), device=dev)
    with pytest.raises(TypeError):
        range_scan.range_scan_rows(torch.zeros((512, 8), device=dev,
                                               dtype=torch.float64), b, b)
    with pytest.raises(ValueError, match="contiguous"):
        range_scan.range_scan_rows(torch.zeros((512, 16), device=dev)[:, ::2],
                                   b, b)
    with pytest.raises(ValueError, match="is on"):
        range_scan.range_scan_rows(torch.zeros((512, 8), device=dev),
                                   b.cpu(), b.cpu())
    with pytest.raises(ValueError):
        range_scan.range_scan_rows(torch.zeros((500, 8), device=dev), b, b)
    with pytest.raises(ValueError):
        range_scan.range_scan_rows(torch.zeros((512, 12), device=dev),
                                   torch.zeros((1, 12), device=dev),
                                   torch.zeros((1, 12), device=dev))
    with pytest.raises(ValueError):
        range_scan.range_scan_rows(torch.zeros((512, 8), device=dev),
                                   torch.zeros((8, 1), device=dev),
                                   torch.zeros((8, 1), device=dev))
    assert ops.kernel_launches() == {}


# -- the engine under a live delta -----------------------------------------------

DELTA_SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=4),
               TopK(k=10, dim=4, largest=False), Agg("sum", 3), Agg("min", 2),
               Agg("max", 18)]


def _delta_engines(dev):
    """The engine and the plain-backend engine over 50,000 GMRQB rows, both
    with 500 fresh rows appended and 600 base + 50 delta rows deleted."""
    ds = gmrqb.build(50_000, seed=1)
    qs = [q for _, q in gmrqb.mixed_workload(ds, 48, seed=1)]
    extra = gmrqb.build(500, seed=2).rows()
    dead = np.concatenate([
        np.random.default_rng(3).choice(50_000, 600, replace=False),
        50_000 + np.arange(50)])
    engines = []
    for backend in ("auto", "torch"):
        eng = MDRQEngine(ds, tile_n=1024, rowscan=True, backend=backend)
        eng.append(extra)
        eng.delete(dead)
        engines.append(eng)
    return engines[0], engines[1], qs


@pytest.mark.parametrize("spec", DELTA_SPECS, ids=str)
def test_engine_under_a_delta_matches_plain_backend(dev, spec):
    eng, plain, qs = _delta_engines(dev)
    for method in ("auto", "scan", "scan_vertical", "kdtree", "rstar",
                   "vafile", "rowscan"):
        batch = qs[:8] if method == "rowscan" else qs
        got = eng.query_batch(batch, method=method, spec=spec)
        want = plain.query_batch(batch, method=method, spec=spec)
        assert eng.last_batch_stats.methods == plain.last_batch_stats.methods
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            elif spec.kind == "agg" and spec.op == "sum":
                np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
            else:
                assert g == w or (np.isnan(g) and np.isnan(w))
    launches = ops.kernel_launches()
    for name in ("multi_scan_tiles", "multi_scan_vertical", "multi_scan_visit",
                 "multi_va_filter_packed", "range_scan_rows"):
        assert launches.get(name, 0) > 0, name


def test_visit_sums_under_a_delta_are_bit_identical(dev):
    eng, _, qs = _delta_engines(dev)
    for method in ("scan", "kdtree", "rstar", "vafile"):
        first = eng.query_batch(qs, method=method, spec=Agg("sum", 3))
        again = eng.query_batch(qs, method=method, spec=Agg("sum", 3))
        assert np.array_equal(np.array(first), np.array(again))


# -- kv_visit_attention (decode attention over a block visit list) ------------
# Both sides take float32 scores from the same inputs and round the output
# once: float32 within 1e-5 (sums in another order), bfloat16 within one
# output ulp (1e-2 at the outputs' magnitude, < 1).
KV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _kv_case(b, kv, g, hd, nb, bs, n_visit, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(dtype)
    cache_k = torch.randn((b, nb * bs, kv, hd), generator=gen, device=dev).to(dtype)
    cache_v = torch.randn((b, nb * bs, kv, hd), generator=gen, device=dev).to(dtype)
    ids = torch.randint(-1, nb, (b, kv, n_visit), generator=gen, device=dev)
    ids[..., 0] = 0                       # at least one valid block
    pos = torch.randint(bs // 2, nb * bs, (b,), generator=gen, device=dev)

    def view(c):
        return c.view(b, nb, bs, kv, hd).permute(0, 3, 1, 2, 4)
    return q, view(cache_k), view(cache_v), ids, pos


@pytest.mark.parametrize("b,kv,g,hd,nb,bs,n_visit", [
    (2, 2, 4, 32, 4, 16, 2), (1, 1, 8, 64, 8, 32, 8), (2, 4, 2, 128, 4, 128, 3),
    (4, 8, 4, 128, 16, 512, 4), (3, 2, 3, 256, 5, 200, 5), (1, 3, 7, 128, 9, 33, 9),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kv_visit_kernel_matches_plain(dev, b, kv, g, hd, nb, bs, n_visit, dtype):
    from repro_torch.kernels import kv_visit
    args = _kv_case(b, kv, g, hd, nb, bs, n_visit, dtype, dev)
    got = kv_visit.kv_visit_attention(*args)
    want = ref.kv_visit_attention_ref(*args)
    assert got.dtype == dtype
    tol = KV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # strided token-major view == contiguous block-major copy, and repeatable
    q, kb, vb, ids, pos = args
    assert kv == 1 or not kb.is_contiguous()
    assert torch.equal(got, kv_visit.kv_visit_attention(
        q, kb.contiguous(), vb.contiguous(), ids, pos))
    assert torch.equal(got, kv_visit.kv_visit_attention(*args))
    assert ops.kernel_launches() == {"kv_visit_attention": 3}


def _device_kernels(fn, reps=3, tries=5):
    """(device kernels per call of ``fn``, their names) by torch.profiler.
    The profiler can drop a device event (its device timestamp before the
    window's start): a window with fewer device events than calls is
    incomplete and taken again, up to ``tries`` windows (as
    ``chip_smoke.device_kernels``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        # a warm-up step first: without one the trace can miss more events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")]   # the step's span
        if len(names) >= reps:
            break
    return len(names) / reps, sorted(set(names))


def _check_kv_visit_call(args, dtype):
    """Against the plain version; bit-identical when repeated and with int32
    ids and positions; one device kernel per call."""
    from repro_torch.kernels import kv_visit
    q, kb, vb, ids, pos = args
    got = kv_visit.kv_visit_attention(*args)
    tol = KV_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.kv_visit_attention_ref(*args).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(got, kv_visit.kv_visit_attention(*args))
    assert torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids.int(), pos.int()))
    per_call, names = _device_kernels(lambda: kv_visit.kv_visit_attention(*args))
    assert per_call == 1 and all("kv_visit_kernel" in n for n in names), names


# (b, kv, g, hd, nb, bs, n_visit): one visit of 33 keys; blocks of 200 keys
# (tile boundaries inside a block, split boundaries inside a block); more
# splits than visits; B * KV above the SM count; 64 visits (splits that
# merge); G in {1, 3, 4, 7, 8}, hd in {32, 64, 128, 256}
KV_EDGE_SHAPES = [(1, 2, 1, 32, 4, 33, 1), (2, 2, 3, 64, 4, 200, 3),
                  (1, 1, 7, 128, 3, 200, 1), (4, 40, 4, 128, 4, 32, 4),
                  (2, 2, 8, 256, 80, 16, 64), (1, 4, 8, 64, 70, 64, 64)]


@pytest.mark.parametrize("shape", KV_EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kv_visit_kernel_edge_shapes(dev, shape, dtype):
    _check_kv_visit_call(_kv_case(*shape, dtype, dev, seed=1), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kv_visit_kernel_uniform_and_spread_padding(dev, dtype):
    """Many splits: padding ids in every third place of a 48-visit list; a
    list with no valid key (every listed block past pos, padding between)."""
    b, kv, g, hd, nb, bs, n_visit = 2, 2, 4, 128, 64, 32, 48
    q, kb, vb, ids, pos = _kv_case(b, kv, g, hd, nb, bs, n_visit, dtype, dev, seed=2)
    ids[..., ::3] = -1
    pos[0] = 40                               # blocks 0 and 1 of row 0
    ids[0, 0] = torch.where(torch.arange(n_visit, device=dev) % 2 == 0, 5, -1)
    _check_kv_visit_call((q, kb, vb, ids, pos), dtype)
    from repro_torch.kernels import kv_visit
    uniform = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)[0, 0].float()
    rows = torch.cat([vb[0, 0, 5]] * (n_visit // 2) + [vb[0, 0, 0]] * (n_visit // 2))
    torch.testing.assert_close(uniform, rows.float().mean(0).expand_as(uniform),
                               rtol=KV_TOL[dtype], atol=KV_TOL[dtype])


def test_kv_visit_kernel_two_streams(dev):
    """Calls on two streams at once (each stream has its own merge tickets)
    equal the call on one stream, bit for bit."""
    from repro_torch.kernels import kv_visit
    args = _kv_case(4, 8, 4, 128, 64, 64, 64, torch.bfloat16, dev, seed=3)
    want = kv_visit.kv_visit_attention(*args)
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(main)
    outs = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(kv_visit.kv_visit_attention(*args))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_kv_visit_kernel_masking_edge_cases(dev):
    from repro_torch.kernels import kv_visit
    q, kb, vb, _, _ = _kv_case(1, 2, 4, 64, 4, 16, 3, torch.float32, dev)
    cases = [
        (torch.tensor([[[2, 3, -1], [3, -1, -1]]], device=dev),
         torch.tensor([5], device=dev)),        # no valid key: uniform average
        (torch.tensor([[[-1, 1, -1], [-1, -1, 0]]], device=dev),
         torch.tensor([20], device=dev)),       # padding first; partial block
        (torch.tensor([[[0, 0, 0], [1, 0, 1]]], device=dev),
         torch.tensor([63], device=dev)),       # repeated ids count twice
    ]
    for ids, pos in cases:
        torch.testing.assert_close(
            kv_visit.kv_visit_attention(q, kb, vb, ids, pos),
            ref.kv_visit_attention_ref(q, kb, vb, ids, pos),
            rtol=1e-5, atol=1e-5)


def test_kv_visit_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import kv_visit
    q, kb, vb, ids, pos = _kv_case(1, 2, 4, 64, 4, 16, 2, torch.float32, dev)
    with pytest.raises(TypeError):
        kv_visit.kv_visit_attention(q.half(), kb.half(), vb.half(), ids, pos)
    with pytest.raises(TypeError):
        kv_visit.kv_visit_attention(q, kb.bfloat16(), vb, ids, pos)
    q48, kb48, vb48, _, _ = _kv_case(1, 2, 4, 48, 4, 16, 2, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        kv_visit.kv_visit_attention(q48, kb48, vb48, ids, pos)
    q9, kb9, vb9, _, _ = _kv_case(1, 2, 9, 64, 4, 16, 2, torch.float32, dev)
    with pytest.raises(ValueError, match="query rows"):
        kv_visit.kv_visit_attention(q9, kb9, vb9, ids, pos)
    strided = torch.zeros((*kb.shape[:4], 2 * kb.shape[4]), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kv_visit.kv_visit_attention(q, strided, vb, ids, pos)


@pytest.mark.parametrize("kw", [{}, dict(kv_block_prune=2, kv_block_size=4),
                                dict(kv_block_prune=3, kv_block_size=4,
                                     kv_prune_groups=2)],
                         ids=["noprune", "prune2", "prune3-groups2"])
def test_decode_step_kernel_matches_plain_and_cpu(dev, kw):
    """The reduced Qwen3 decode, float32: the kernel backend on the card
    against the plain backend on the card and the plain versions on the CPU
    (logits atol 1e-4), with identical visit lists."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen3_8b").reduced().replace(param_dtype="float32", **kw)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    def run(device, backend):
        model = build_model(cfg, device=device, backend=backend)
        p = to(params, model.device)
        cache = model.init_cache(2, 32)
        logits, visits = [], []
        for t in range(toks.shape[1]):
            lg, cache = model.decode_step(
                p, cache, torch.as_tensor(toks[:, t:t + 1], device=model.device),
                torch.full((2,), t, dtype=torch.int32, device=model.device),
                visits=visits)
            logits.append(lg.cpu())
        return torch.stack(logits), [v[0].cpu() for v in visits]

    got, got_v = run(dev, "auto")
    for other, other_v in (run(dev, "torch"), run("cpu", "auto")):
        torch.testing.assert_close(got, other, rtol=0, atol=1e-4)
        assert all(torch.equal(a, b) for a, b in zip(got_v, other_v))
    n_launch = ops.kernel_launches().get("kv_visit_attention", 0)
    assert n_launch == (toks.shape[1] * cfg.n_layers if kw else 0)


# -- the pipelined server on the card ------------------------------------------

PIPE_TIMEOUT = 300.0


def _pipe_case(n=200_000, n_q=160):
    ds = gmrqb.build(n, seed=5)
    qs = [q for _, q in gmrqb.mixed_workload(ds, n_q, seed=6)]
    return ds, MDRQEngine(ds, tile_n=1024), qs


def _serve_pipelined(srv, qs):
    tickets = [srv.submit(q) for q in qs]
    srv.drain(PIPE_TIMEOUT)
    return [t.result(timeout=PIPE_TIMEOUT) for t in tickets]


@pytest.mark.parametrize("spec", [Ids(), Count(), TopK(k=5, dim=4)], ids=str)
def test_pipelined_server_matches_sync_on_the_card(dev, spec):
    """20 windows of 8 back to back through backlog 4 on the launch and copy
    streams: every result equals the synchronous server's, in order (a copy
    that read a reused or not yet written payload would differ), with the
    same launches and syncs; then an append between windows: the windows
    before it see the old rows, the windows after it the new ones."""
    from repro_torch.serve import MDRQServer, serve_pipelined
    ds, eng, qs = _pipe_case()
    kw = dict(max_batch=8, max_wait_s=float("inf"), spec=spec)
    ops.reset_counters()
    want = MDRQServer(eng, **kw).serve_all(qs)
    sync_counts = ops.counters()
    with serve_pipelined(eng, backlog=4, latency_budget_s=1e9,
                         warmup=False, **kw) as srv:
        assert srv.stream_scheme == "launch+copy streams"
        ops.reset_counters()
        got = _serve_pipelined(srv, qs)
        assert ops.counters() == sync_counts
        assert srv.stats.n_batches == 20
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
        extra = gmrqb.build(5_000, seed=7).rows()
        before = [srv.submit(q) for q in qs[:40]]
        srv.append(extra)
        after = [srv.submit(q) for q in qs[:40]]
        srv.drain(PIPE_TIMEOUT)
        want_after = eng.query_batch(qs[:40], spec=spec)
        for tickets, expect in ((before, want[:40]), (after, want_after)):
            for t, w in zip(tickets, expect):
                r = t.result(timeout=PIPE_TIMEOUT)
                if isinstance(w, np.ndarray):
                    np.testing.assert_array_equal(r, w)
                else:
                    assert r == w
        srv.close(PIPE_TIMEOUT)
    if spec.kind == "count":
        all_rows = np.concatenate([ds.cols, extra.T], axis=1)
        assert [t.result() for t in after] == \
            [match_ids_np(all_rows, q).size for q in qs[:40]]
    launches = ops.kernel_launches()
    for name in ("multi_scan_tiles", "multi_scan_vertical"):
        assert launches.get(name, 0) > 0, name


@pytest.mark.parametrize("method", ["scan", "scan_vertical"])
def test_pipelined_warm_set_is_complete_on_the_card(dev, method):
    """After ``warmup()`` the extensions are loaded and the stream finds
    every op key warm."""
    from repro_torch.kernels import _build
    from repro_torch.serve import serve_pipelined
    _, eng, qs = _pipe_case(n=50_000, n_q=100)
    ops.clear_warm_keys()
    with serve_pipelined(eng, max_batch=32, max_wait_s=float("inf"),
                         method=method, spec=Count(),
                         latency_budget_s=1e9) as srv:
        rep = srv.last_warmup
        assert rep.keys and set(rep.keys) == set(ops.warm_keys())
        assert _build._LIBS
        ops.reset_trace_log()
        _serve_pipelined(srv, qs)           # windows of 32, 32, 32, 4
        assert ops.trace_log() == ()
        assert srv.warmup().keys == ()
        srv.close(PIPE_TIMEOUT)


# -- horizontal partitioning: shards of one card -----------------------------------
# ``core.distributed`` with a mesh that lists the card D times: the shards
# run the hand kernels on their own blocks and merge on the first device.
# Against the unmeshed engine on the same card: ids, counts, masks, top-k
# (ties by id) and min/max exactly; sums within SUM_RTOL, and bit-identical
# across repeated calls.

MESH_SPECS = [Ids(), Count(), Mask(), TopK(k=10, dim=0),
              TopK(k=10, dim=0, largest=False), TopK(k=7, dim=3),
              Agg("sum", 3), Agg("min", 2), Agg("max", 0)]


def _mesh_case(dev, n=60_000, n_q=40):
    """GMRQB-free random data whose dim 0 holds three values (ties in every
    shard, and across their boundaries), the mixed queries of ``_case``, an
    unmeshed engine and its writes (400 rows, 900 base + 20 new deletes)."""
    rng = np.random.default_rng(5)
    cols = rng.random((6, n), dtype=np.float32)
    cols[0] = rng.integers(0, 3, size=n)
    qs = []
    for k in range(n_q):
        a, b = cols[:, rng.integers(n)], cols[:, rng.integers(n)]
        lo, up = np.minimum(a, b) - 0.3, np.maximum(a, b) + 0.3
        qs.append(RangeQuery.complete(lo, up) if k % 2 else
                  RangeQuery.partial(6, {1: (float(lo[1]), float(up[1]))}))
    qs.append(RangeQuery.partial(6, {}))
    extra = rng.random((400, 6), dtype=np.float32)
    dead = np.concatenate([rng.choice(n, 900, replace=False),
                           n + np.arange(20)])
    from repro_torch.core import Dataset
    return Dataset(cols), qs, extra, dead


def _assert_mesh_same(spec, got, want):
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        elif spec.kind == "agg" and spec.op == "sum":
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
        else:
            assert g == w or (np.isnan(g) and np.isnan(w))


@pytest.mark.parametrize("d", [1, 2, 8])
def test_meshed_engine_matches_unmeshed_on_the_card(dev, d):
    from repro_torch.core import DataMesh
    ds, qs, extra, dead = _mesh_case(dev)
    base = MDRQEngine(ds, structures=("scan",), tile_n=1024)
    eng = MDRQEngine(ds, structures=("scan",), tile_n=1024,
                     mesh=DataMesh([dev] * d))
    assert eng.dist.n_local % 1024 == 0 and eng._columnar is None
    for delta in (False, True):
        if delta:
            for e in (base, eng):
                e.append(extra)
                e.delete(dead)
            n_local = eng.dist.n_local
            assert np.unique(dead[dead < ds.n] // n_local).size == d
        for spec in MESH_SPECS:
            want = base.query_batch(qs, method="scan", spec=spec)
            ops.reset_counters()
            ops.reset_kernel_launches()
            got = eng.query_batch(qs, method="scan", spec=spec)
            assert ops.counters() == {"distributed_multi_reduce": 1,
                                      "host_sync": 1}
            launches = ops.kernel_launches()
            # one scan per shard, plus the delta block's once
            assert launches["multi_scan_tiles"] == d + int(delta)
            if spec.kind == "topk":
                assert launches["masked_fill_tiles"] == d + int(delta)
            if spec.kind == "agg":
                assert launches["masked_agg_tiles"] == d + int(delta)
            _assert_mesh_same(spec, got, want)
            if spec.kind == "agg":
                again = eng.query_batch(qs, method="scan", spec=spec)
                assert np.array_equal(np.array(got), np.array(again))
        for q in qs[:4]:
            np.testing.assert_array_equal(eng.query(q, "scan"),
                                          base.query(q, "scan"))
            assert eng.query(q, "scan", spec=Count()) == \
                base.query(q, "scan", spec=Count())


def test_meshed_topk_ties_straddle_shards_on_the_card(dev):
    """Equal extremes planted across the shard boundaries of an eight-shard
    mesh: the merged top-k lists them by ascending id, as one device does."""
    from repro_torch.core import DataMesh, Dataset
    rng = np.random.default_rng(9)
    n = 8 * 8192
    cols = np.round(rng.random((3, n)), 1).astype(np.float32)
    for b in range(1, 8):
        cols[1, b * 8192 - 3: b * 8192 + 3] = 2.0
    ds = Dataset(cols)
    qs = [RangeQuery.partial(3, {}), RangeQuery.partial(3, {0: (0.2, 0.2)})]
    base = MDRQEngine(ds, structures=("scan",), tile_n=1024)
    eng = MDRQEngine(ds, structures=("scan",), tile_n=1024,
                     mesh=DataMesh([dev] * 8))
    for spec in (TopK(k=12, dim=1), TopK(k=40, dim=1), TopK(k=9, dim=2),
                 TopK(k=9, dim=2, largest=False)):
        got = eng.query_batch(qs, method="scan", spec=spec)
        _assert_mesh_same(spec, got, base.query_batch(qs, method="scan",
                                                      spec=spec))
    top = eng.query_batch(qs[:1], method="scan", spec=TopK(k=12, dim=1))[0]
    np.testing.assert_array_equal(
        top, np.array([8189, 8190, 8191, 8192, 8193, 8194,
                       16381, 16382, 16383, 16384, 16385, 16386]))


def test_meshed_engine_across_cards(dev):
    """Shards on every card of the machine, two per card and interleaved
    (shard s on card s % n): partials of the other cards cross to the first
    with their streams' events; results equal the unmeshed engine on one
    card, repeated sums bit-identical, and the caller's current card is
    the same after each call."""
    from repro_torch.core import DataMesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    ds, qs, extra, dead = _mesh_case(dev, n=120_000)
    base = MDRQEngine(ds, structures=("scan",), tile_n=1024)
    eng = MDRQEngine(ds, structures=("scan",), tile_n=1024,
                     mesh=DataMesh([f"cuda:{s % n}" for s in range(2 * n)]))
    assert {x.device.index for x in eng.dist.shards} == set(range(n))
    current = torch.cuda.current_device()
    for delta in (False, True):
        if delta:
            for e in (base, eng):
                e.append(extra)
                e.delete(dead)
        for spec in MESH_SPECS:
            want = base.query_batch(qs, method="scan", spec=spec)
            ops.reset_counters()
            got = eng.query_batch(qs, method="scan", spec=spec)
            assert ops.counters() == {"distributed_multi_reduce": 1,
                                      "host_sync": 1}
            assert torch.cuda.current_device() == current
            _assert_mesh_same(spec, got, want)
            if spec.kind == "agg":
                again = eng.query_batch(qs, method="scan", spec=spec)
                assert np.array_equal(np.array(got), np.array(again))
        for q in qs[:4]:
            np.testing.assert_array_equal(eng.query(q, "scan"),
                                          base.query(q, "scan"))
            assert eng.query(q, "scan", spec=Count()) == \
                base.query(q, "scan", spec=Count())
            assert torch.cuda.current_device() == current
