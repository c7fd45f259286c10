"""The block-major visit schedule and the word-parallel VA filter, on the CPU.

The CUDA kernels of ``csrc/visit.cu`` and ``csrc/va_filter.cu`` run only on
the card (``tests/test_torch_cuda.py`` holds them against their plain
versions there). What surrounds them is checked here, at small sizes, with
numpy seeds and exact equality:

- ``range_scan.visit_schedule``, the device sort that makes a query-major
  visit list block-major: every visit lands in exactly one range of
  ``VISITS_PER_BLOCK`` sorted visits, the keys ascend by (block, query), and
  the padding (query 0, block -1) spreads over ranges of its own. A numpy
  walk of the kernel's ranges (distinct keys computed once, runs of one
  block sharing one read, each result stored to every row that names it)
  equals the plain version and the reference's Pallas kernel.
- the word-parallel VA filter's rule, modelled here in PyTorch
  (``cell_masks`` builds the four per-(query, word) masks the kernel builds
  by ballots in its prologue, ``words_filter`` evaluates the kernel's word
  formula against them), against the reference's Pallas
  ``multi_va_filter_packed`` (interpret mode) and
  ``ref.multi_va_filter_packed_ref``: dims that fill a word exactly or spill
  one field into the next, empty intervals, bounds outside the cells and
  nonzero fields beyond ``m``. The kernel itself is held against the plain
  version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import multi_scan as jms
from repro.kernels import va_filter as jva
from repro_torch.core.blockindex import _pad_visit_list
from repro_torch.kernels import multi_scan, ops, range_scan, ref, va_filter

K = range_scan.VISITS_PER_BLOCK
TILE_N = 256


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _visit_list(n_q, n_blocks, n_real, seed, shared_block=None):
    """A query-major list of ``n_real`` (query, block) visits (distinct
    pairs, ascending blocks per query, as ``np.nonzero`` of a survivor mask
    gives them), padded to a power of two with (query 0, block -1); with
    ``shared_block`` every query also visits that block."""
    rng = np.random.default_rng(seed)
    surv = np.zeros((n_q, n_blocks), bool)
    flat = rng.choice(n_q * n_blocks, size=n_real, replace=False)
    surv.reshape(-1)[flat] = True
    if shared_block is not None:
        surv[:, shared_block] = True
    qids, bids = np.nonzero(surv)
    return _pad_visit_list(qids.astype(np.int32), bids.astype(np.int32))


def _schedule(qids, bids, n_blocks, n_q):
    keys, order = range_scan.visit_schedule(_t(qids), _t(bids), n_blocks, n_q)
    return keys.numpy().astype(np.int64), order.numpy()


@pytest.mark.parametrize("n_visit", [1, 5, 63, 64, 65, 200, 1000])
def test_visit_schedule_puts_every_visit_in_one_range(n_visit):
    """V < K, V == K and V not a multiple of K: the ranges [r K, r K + K)
    of the sorted list hold every visit exactly once, keys ascending."""
    rng = np.random.default_rng(n_visit)
    n_q, n_blocks = 7, 13
    qids = rng.integers(0, n_q, size=n_visit).astype(np.int32)
    bids = rng.integers(-1, n_blocks, size=n_visit).astype(np.int32)
    keys, order = _schedule(qids, bids, n_blocks, n_q)
    assert keys.shape == order.shape == (n_visit,)
    ranges = [order[r: r + K] for r in range(0, n_visit, K)]
    assert len(ranges) == -(-n_visit // K)
    assert all(0 < len(r) <= K for r in ranges)
    np.testing.assert_array_equal(np.sort(np.concatenate(ranges)),
                                  np.arange(n_visit))
    assert np.all(np.diff(keys) >= 0)
    want = np.maximum(bids, 0).astype(np.int64) * n_q + qids
    np.testing.assert_array_equal(keys, want[order])


def test_visit_schedule_spreads_the_padding():
    """A list of 300 real visits padded to 512: the 212 padding visits (all
    block 0, query 0 after clamping) sort to the front and fill ranges of
    their own, no range holding more than K visits."""
    qids, bids = _visit_list(9, 40, 300, seed=3)
    n_pad_rows = int((bids < 0).sum())
    assert qids.size == 512 and n_pad_rows == 212
    keys, order = _schedule(qids, bids, 40, 9)
    per_range = [int((bids[order[r: r + K]] < 0).sum())
                 for r in range(0, qids.size, K)]
    assert max(per_range) <= K
    assert sum(1 for c in per_range if c) <= -(-n_pad_rows // K) + 1
    # the padding rows and any real (query 0, block 0) visit share key 0
    assert np.all(keys[: n_pad_rows] == 0)


def test_visit_schedule_groups_a_block_every_query_visits():
    qids, bids = _visit_list(70, 30, 200, seed=4, shared_block=17)
    keys, order = _schedule(qids, bids, 30, 70)
    run = np.nonzero(keys // 70 == 17)[0]
    assert run.size == 70 and np.all(np.diff(run) == 1)  # one contiguous run
    np.testing.assert_array_equal(keys[run] % 70, np.arange(70))
    np.testing.assert_array_equal(bids[order[run]], 17)


@pytest.mark.parametrize("n_q", [2 ** 4, 2 ** 12])
def test_visit_schedule_keys_are_int64(n_q):
    """The keys are int64 whether or not block * Q fits in int32 (it does
    not at 2**20 blocks x 2**12 queries)."""
    qids = np.array([3, 0, 2], np.int32)
    bids = np.array([2 ** 20 - 1, -1, 5], np.int32)
    keys, order = range_scan.visit_schedule(_t(qids), _t(bids), 2 ** 20, n_q)
    assert keys.dtype == torch.int64 and order.dtype == torch.int64
    np.testing.assert_array_equal(order.numpy(), [1, 2, 0])
    np.testing.assert_array_equal(keys.numpy(),
                                  [0, 5 * n_q + 2, (2 ** 20 - 1) * n_q + 3])


def _walk(blocks, lo, up, keys, order, n_q):
    """The block-major kernel's schedule in numpy: each range of K sorted
    visits computes its distinct keys once, one block read per run of equal
    blocks, and stores every result to each row naming its key. Returns the
    (V, tn) masks and the number of block reads."""
    n_visit, tn = keys.size, blocks.shape[2]
    out = np.full((n_visit, tn), -1, np.int8)
    reads = 0
    for r0 in range(0, n_visit, K):
        rk, rows = keys[r0: r0 + K], order[r0: r0 + K]
        uniq = np.unique(rk)                        # ascending, as in the range
        last_block = None
        for key in uniq:
            b, q = divmod(int(key), n_q)
            if b != last_block:
                reads += 1
                last_block = b
            x = blocks[b]                           # (m_pad, tn)
            ok = ((x >= lo[:, q, None]) & (x <= up[:, q, None])).all(axis=0)
            out[rows[rk == key]] = ok
    return out, reads


def _walk_case(m, n_q, n_blocks, n_real, seed, dup=0):
    rng = np.random.default_rng(seed)
    cols = rng.random((m, n_blocks * TILE_N - 37), dtype=np.float32)
    padded, _, _ = ops.prepare_columnar(cols, tile_n=TILE_N)
    m_pad = padded.shape[0]
    lo = np.full((m_pad, n_q), -3e38, np.float32)
    up = np.full((m_pad, n_q), 3e38, np.float32)
    for q in range(n_q):
        a, b = cols[:, rng.integers(cols.shape[1])], cols[:, rng.integers(cols.shape[1])]
        lo[:m, q] = np.minimum(a, b) - 0.35
        up[:m, q] = np.maximum(a, b) + 0.35
    qids, bids = _visit_list(n_q, n_blocks, n_real, seed)
    if dup:   # repeat some real (query, block) pairs
        pick = rng.integers(0, n_real, size=dup)
        qids = np.concatenate([qids, qids[pick]])
        bids = np.concatenate([bids, bids[pick]])
    blocks = padded.reshape(m_pad, n_blocks, TILE_N).transpose(1, 0, 2)
    return padded, blocks, lo, up, qids, bids


@pytest.mark.parametrize("m,n_q,n_blocks,n_real,dup", [
    (19, 9, 12, 60, 0),       # V = 64 = K, padding included
    (5, 3, 10, 7, 0),         # V = 8 < K
    (19, 40, 8, 200, 0),      # V = 256: blocks visited by ~25 queries
    (100, 6, 9, 40, 25),      # m_pad 104, duplicated pairs, V = 89
    (1, 70, 4, 250, 3),       # m_pad 8, V = 259
])
def test_block_major_walk_matches_plain(m, n_q, n_blocks, n_real, dup):
    padded, blocks, lo, up, qids, bids = _walk_case(m, n_q, n_blocks, n_real,
                                                    seed=m + n_q, dup=dup)
    keys, order = _schedule(qids, bids, n_blocks, n_q)
    got, reads = _walk(blocks, lo, up, keys, order, n_q)
    want = ref.multi_scan_blocks_ref(_t(blocks), _t(qids), _t(bids), _t(lo),
                                     _t(up)).numpy()
    np.testing.assert_array_equal(got, want)
    n_ranges = -(-qids.size // K)
    assert reads <= len(np.unique(np.maximum(bids, 0))) + n_ranges
    # the wrapper on CPU tensors runs the plain version: the same rows
    np.testing.assert_array_equal(
        multi_scan.multi_scan_visit(_t(padded), _t(qids), _t(bids), _t(lo),
                                    _t(up), tile_n=TILE_N).numpy(), got)


def test_block_major_walk_matches_pallas():
    padded, blocks, lo, up, qids, bids = _walk_case(19, 5, 6, 25, seed=8,
                                                    dup=4)
    keys, order = _schedule(qids, bids, 6, 5)
    got, _ = _walk(blocks, lo, up, keys, order, 5)
    want = np.asarray(jms.multi_scan_visit(
        jnp.asarray(padded), jnp.asarray(qids), jnp.asarray(bids),
        jnp.asarray(lo), jnp.asarray(up), tile_n=TILE_N, interpret=True))
    np.testing.assert_array_equal(got, want)


VA_N = 1024
CELLS = 1 << va_filter.BITS_PER_DIM
LOW_BITS = 0x55555555


def cell_masks(cell_lo, cell_hi, m, w):
    """(m_s, Q) cell bounds -> (CELLS, w, Q) int32 word masks, the rule the
    kernel's prologue builds by ballots.

    Bit ``2k`` of ``[c, wi, q]`` is set when cell ``c`` lies in
    ``[cell_lo, cell_hi]`` of dim ``16 wi + k`` of query ``q`` (the per-dim
    rule, so empty intervals and bounds outside the cells behave as there),
    and for every cell of the dims from ``m`` on, whose fields must not
    matter; odd bits are 0.
    """
    q_n = cell_lo.shape[1]
    dpw = va_filter.DIMS_PER_WORD
    cells = torch.arange(CELLS, dtype=torch.int32)[:, None, None]
    ok = torch.ones((CELLS, w * dpw, q_n), dtype=torch.bool)
    ok[:, :m] = (cells >= cell_lo[None, :m].to(torch.int32)) \
        & (cells <= cell_hi[None, :m].to(torch.int32))
    weight = 1 << (va_filter.BITS_PER_DIM * torch.arange(dpw))
    bits = ok.reshape(CELLS, w, dpw, q_n).long() * weight[None, None, :, None]
    return bits.sum(dim=2).to(torch.int32)


def words_filter(packed, masks):
    """(w, n) int32 packed codes, (CELLS, w, Q) word masks -> (Q, n) int8,
    one word at a time as the kernel tests it: with ``l = x`` and
    ``h = x >> 1`` (bit 2k of each: field k's low and high bit),
    ``r = h ? (l ? M3 : M2) : (l ? M1 : M0)`` bitwise; a candidate has
    ``r == 0x55555555`` in every word."""
    q_n, n = masks.shape[2], packed.shape[1]
    acc = torch.ones((q_n, n), dtype=torch.bool)
    for wi in range(packed.shape[0]):
        x = packed[wi].to(torch.int32)[None, :]      # (1, n)
        h = x >> 1     # bit 2k: bit 2k + 1 of x (the sign shifts into bit 30)
        m0, m1, m2, m3 = (masks[c, wi][:, None] for c in range(CELLS))
        low_pair = (x & m1) | (~x & m0)
        high_pair = (x & m3) | (~x & m2)
        r = (h & high_pair) | (~h & low_pair)        # odd bits 0, as the masks'
        acc &= r == LOW_BITS
    return acc.to(torch.int8)


def _va_word_case(m, seed):
    """Random codes packed, then nonzero fields written beyond m in the last
    word; six queries: a few constrained dims each, bounds drawn from
    [-1, 4] (cells outside 0..3 and empty intervals among them), one query
    empty everywhere (lo > hi) and one open everywhere (-1..4)."""
    rng = np.random.default_rng(seed)
    w = -(-m // va_filter.DIMS_PER_WORD)
    codes = rng.integers(0, 4, size=(m, VA_N)).astype(np.uint8)
    packed = va_filter.pack_codes(codes)
    spill = w * va_filter.DIMS_PER_WORD - m
    if spill:
        junk = rng.integers(0, 2 ** 31, size=VA_N, dtype=np.int64)
        keep = (1 << (2 * (m - (w - 1) * va_filter.DIMS_PER_WORD))) - 1
        packed[-1] |= (junk & ~keep).astype(np.int32)
    n_q = 6
    m_s = -(-m // 8) * 8
    lo = np.full((m_s, n_q), -1, np.int32)
    hi = np.full((m_s, n_q), 4, np.int32)
    for q in range(n_q - 2):
        dims = rng.choice(m, size=min(m, 3), replace=False)
        lo[dims, q] = rng.integers(-1, 4, size=dims.size)
        hi[dims, q] = lo[dims, q] + rng.integers(0, 3, size=dims.size)
    lo[rng.integers(m), 1] = 3          # one empty interval
    hi[:, 1][lo[:, 1] == 3] = 2
    lo[:m, n_q - 2], hi[:m, n_q - 2] = 2, 1     # empty everywhere
    return packed, lo, hi


@pytest.mark.parametrize("m", [1, 15, 16, 17, 19, 32, 33, 100])
def test_word_filter_matches_pallas_and_plain(m):
    packed, lo, hi = _va_word_case(m, seed=m)
    w = packed.shape[0]
    masks = cell_masks(_t(lo), _t(hi), m, w)
    assert masks.dtype == torch.int32 and masks.shape == (CELLS, w, lo.shape[1])
    assert not (masks.numpy() & ~LOW_BITS).any()     # odd bits 0
    got = words_filter(_t(packed), masks).numpy()
    want = np.asarray(jva.multi_va_filter_packed(
        jnp.asarray(packed), jnp.asarray(lo), jnp.asarray(hi), m,
        tile_n=VA_N, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref.multi_va_filter_packed_ref(_t(packed), _t(lo), _t(hi), m).numpy())
    assert want[-1].all() and not want[-2].any()
    assert want[:-2].any() and not want[:-2].all()


def test_cell_masks_follow_the_per_dim_rule():
    """Bit 2k of M_c for query q is ``lo <= c <= hi`` of dim 16 wi + k, every
    cell for the dims from m on."""
    rng = np.random.default_rng(5)
    m, n_q = 21, 4
    lo = rng.integers(-1, 5, size=(24, n_q)).astype(np.int32)
    hi = rng.integers(-1, 5, size=(24, n_q)).astype(np.int32)
    masks = cell_masks(_t(lo), _t(hi), m, 2).numpy()
    for c in range(4):
        for d in range(32):
            wi, k = divmod(d, 16)
            bit = (masks[c, wi] >> (2 * k)) & 1
            want = (lo[d] <= c) & (c <= hi[d]) if d < m else np.ones(n_q, bool)
            np.testing.assert_array_equal(bit, want.astype(bit.dtype))
