"""The columnar scan kernel's schedule, on the CPU.

``csrc/scan.cu``'s ``scan_kernel`` runs only on the card
(``tests/test_torch_cuda.py`` holds it against its plain versions there).
What it builds in its prologue, and the arithmetic it evaluates from that,
are modelled here in numpy, at small sizes with numpy seeds and exact
equality:

- the work list: the distinct (query, row) pairs a launch compares — in the
  full scan the rows whose bounds are not the float32 extrema, in the
  vertical scan each distinct listed dim once (dim_ids rows padded by
  repeats) — with the dim-padding rows past ``m`` never read;
- the union of those rows in order of how many queries use them, the rows
  no query constrains (the full scan tests only their finiteness), the
  passes of at most ``2 * n_pairs`` register slots, each query's slot count
  ``k`` and its NaN-padded bounds, the queries sorted by ``k``, and the
  query groups of ``range_scan.scan_launch_shape``;
- the masks the kernel computes from them (unordered compares against the
  staged bounds, then the per-object fix-up for inf and NaN), held against
  the reference's Pallas ``multi_scan_tiles``, ``multi_scan_vertical``,
  ``range_scan_tiles`` and ``range_scan_vertical`` in interpret mode and
  against ``kernels/ref.py``, at Q in {1, 2, 13, 16, 31, 32, 33, 128} and
  m_pad in {8, 24, 104}: +inf padding objects, +-inf and NaN in a real row,
  a query that constrains no dim, match-all padding query columns, an
  inverted interval and a NaN bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import multi_scan as jms
from repro.kernels import range_scan as jrs
from repro_torch.core import QueryBatch, RangeQuery
from repro_torch.kernels import multi_scan, ops, range_scan, ref

FMAX = np.float32(np.finfo(np.float32).max)
TILE_N = 128
QS = (1, 2, 13, 16, 31, 32, 33, 128)
MS = (5, 19, 100)          # m_pad 8, 24, 104


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _case(m, q_n, seed, n=600):
    """Padded data (+inf padding objects, 0.0 padding rows) with inf, -inf
    and NaN planted in real row 1; ``q_n`` bound columns of which the last
    quarter are match-all padding; query 0 constrains no dim, query 1 (where
    there is one) has an inverted interval, query 2 a NaN upper bound."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 6, size=(m, n)).astype(np.float32)
    at = rng.choice(n, size=9, replace=False)
    cols[min(1, m - 1), at] = np.repeat(
        np.array([np.inf, -np.inf, np.nan], np.float32), 3)
    padded, _, _ = ops.prepare_columnar(cols, TILE_N)
    n_real = max(1, q_n - q_n // 4)
    qs = [RangeQuery.partial(m, {})]
    for k in range(1, n_real):
        dims = rng.choice(m, size=int(rng.integers(1, min(m, 12) + 1)),
                          replace=False)
        pred = {}
        for d in dims:
            a, b = np.sort(rng.integers(0, 6, size=2))
            pred[int(d)] = (float(a), float(b))
        if k == 1:
            pred[int(dims[0])] = (4.0, 1.0)
        if k == 2:
            pred[int(dims[0])] = (0.0, float("nan"))
        qs.append(RangeQuery.partial(m, pred))
    batch = QueryBatch.from_queries(qs)
    lo, up = batch.bounds_columnar(padded.shape[0], q_n)
    return padded, lo, up, batch.padded_dim_ids(q_n)


# -- the model of the kernel's prologue and arithmetic -------------------------

def work_list(lo, up, m_rows, dim_ids=None):
    """(Q, m_rows) bool: the distinct (query, row) pairs the kernel compares
    (the kernel's ``mark``)."""
    if dim_ids is None:
        open_ = (lo[:m_rows] == -FMAX) & (up[:m_rows] == FMAX)
        return ~open_.T
    cons = np.zeros((dim_ids.shape[0], m_rows), bool)
    rows = np.clip(dim_ids, 0, m_rows - 1)
    cons[np.arange(dim_ids.shape[0])[:, None], rows] = True
    return cons


class Plan:
    """What one thread block stages: the union in slot order, the rows no
    query constrains, and per (pass, query) the slot mask, k, the empty
    flag and the bounds of its first k slots; the query order by k.
    ``cnt`` (per row, its constraining queries over the whole launch) orders
    the union when these queries are one group of several."""

    def __init__(self, lo, up, *, m_rows, n_pairs, dim_ids=None, cnt=None):
        self.full = dim_ids is None
        self.cons = work_list(lo, up, m_rows, dim_ids)
        if cnt is None:
            cnt = self.cons.sum(axis=0)
        rows = np.nonzero(cnt)[0]
        self.union = rows[np.lexsort((rows, -cnt[rows]))]
        self.rest = np.nonzero(cnt == 0)[0] if self.full else rows[:0]
        self.slots = 2 * n_pairs
        self.passes = [self.union[i:i + self.slots]
                       for i in range(0, len(self.union), self.slots)] or [rows[:0]]
        q_n = lo.shape[1]
        self.k = np.zeros((len(self.passes), q_n), int)
        self.cm = np.zeros((len(self.passes), q_n, self.slots), bool)
        self.empty = np.zeros((len(self.passes), q_n), bool)
        self.bounds = np.full((len(self.passes), q_n, self.slots, 2), np.nan,
                              np.float32)
        for p, slot_rows in enumerate(self.passes):
            for q in range(q_n):
                cm = self.cons[q, slot_rows]
                self.cm[p, q, :cm.size] = cm
                set_ = np.nonzero(cm)[0]
                self.k[p, q] = set_[-1] + 1 if set_.size else 0
                for s in set_:
                    j = slot_rows[s]
                    self.bounds[p, q, s] = lo[j, q], up[j, q]
                    self.empty[p, q] |= np.isnan(lo[j, q]) or np.isnan(up[j, q])
        self.order = [np.argsort(self.k[p], kind="stable")
                      for p in range(len(self.passes))]

    def masks(self, data):
        """The kernel's (Q, n_pad) int8 masks from this plan."""
        q_n = self.k.shape[1]
        out = np.ones((q_n, data.shape[1]), bool)
        rest_bad = (~np.isfinite(data[self.rest])).any(axis=0)
        for p, slot_rows in enumerate(self.passes):
            x = np.zeros((self.slots, data.shape[1]), np.float32)
            x[:slot_rows.size] = data[slot_rows]
            nf, nn = ~np.isfinite(x), np.isnan(x)
            for q in self.order[p]:
                h = np.full(data.shape[1], not self.empty[p, q])
                for s in range(self.k[p, q]):
                    lo, hi = self.bounds[p, q, s]
                    h &= ~(x[s] > hi) & ~(x[s] < lo)
                cm = self.cm[p, q]
                h &= ~nn[cm].any(axis=0)
                if self.full:
                    h &= ~rest_bad & ~nf[~cm].any(axis=0)
                out[q] &= h
        return out.astype(np.int8)


def groups(q_n, qg):
    return [(g0, min(qg, q_n - g0)) for g0 in range(0, q_n, qg)]


# -- the rule the full scan rests on -------------------------------------------

def test_open_dim_compare_is_a_finiteness_test():
    """-FLT_MAX <= x <= FLT_MAX holds exactly for the finite float32 x: so
    one finiteness test per (object, row) replaces the compare of every
    query that leaves the row open."""
    tiny = np.finfo(np.float32).smallest_subnormal
    x = np.array([0.0, -0.0, 1.0, -1.0, tiny, -tiny, FMAX, -FMAX,
                  np.nextafter(FMAX, np.float32(0)), np.inf, -np.inf, np.nan],
                 np.float32)
    np.testing.assert_array_equal((x >= -FMAX) & (x <= FMAX), np.isfinite(x))


def test_unordered_compare_differs_only_at_nan():
    """!(x > hi) & !(x < lo) equals lo <= x <= hi unless x or a bound is
    NaN, and a NaN bound (the neutral slot) passes every x."""
    vals = np.array([-np.inf, -2.0, -0.0, 0.0, 1.5, 3.0, np.inf, np.nan],
                    np.float32)
    x, lo, hi = np.meshgrid(vals, vals, vals, indexing="ij")
    unordered = ~(x > hi) & ~(x < lo)
    ordered = (x >= lo) & (x <= hi)
    some_nan = np.isnan(x) | np.isnan(lo) | np.isnan(hi)
    np.testing.assert_array_equal(unordered[~some_nan], ordered[~some_nan])
    assert (~(vals > np.nan) & ~(vals < np.nan)).all()


# -- the prologue ----------------------------------------------------------------

@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("q_n", QS)
def test_full_scan_schedule_matches_reference(m, q_n):
    """Full scan: the work list skips open rows and the dim padding, the
    union and the rest rows split [0, m), passes and k stay within the
    instance's slots, the groups cover every query; the model's masks equal
    the reference's Pallas kernel, the plain version and the CPU wrapper."""
    data, lo, up, _ = _case(m, q_n, seed=m * 1000 + q_n)
    m_pad = data.shape[0]
    pairs = work_list(lo, up, m)
    hint = int(pairs.any(axis=0).sum())
    n_pairs, qg = range_scan.scan_launch_shape(q_n, m, max(hint, 1))
    plan = Plan(lo, up, m_rows=m, n_pairs=n_pairs)
    # padding rows are never read; constrained rows are the union
    assert set(plan.union) | set(plan.rest) == set(range(m))
    assert not set(plan.union) & set(plan.rest)
    assert (plan.union < m).all() and (plan.rest < m).all()
    assert pairs.sum() == (~((lo[:m] == -FMAX) & (up[:m] == FMAX))).sum()
    cnt = pairs.sum(axis=0)[plan.union]
    assert (np.diff(cnt) <= 0).all()           # rows used most come first
    assert all(len(p) <= plan.slots for p in plan.passes)
    assert (plan.k <= plan.slots).all()
    if q_n - q_n // 4 > 2:
        assert plan.empty[:, 2].any()          # query 2's NaN bound
    assert sum(g for _, g in groups(q_n, qg)) == q_n and qg >= 1
    want = ref.multi_scan_ref(_t(data), _t(lo), _t(up)).numpy()
    np.testing.assert_array_equal(plan.masks(data), want)
    got = np.asarray(jms.multi_scan_tiles(
        jnp.asarray(data), jnp.asarray(lo), jnp.asarray(up), tile_n=TILE_N,
        interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(multi_scan.multi_scan_tiles(
        _t(data), _t(lo), _t(up), tile_n=TILE_N, m=m, rows=hint).numpy(), want)
    assert m_pad % 8 == 0


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("q_n", QS)
def test_vertical_scan_schedule_matches_reference(m, q_n):
    """Vertical scan: each distinct listed dim of a query is compared once
    (the repeats that pad dim_ids rows are dropped), padding query rows list
    dim 0 under match-all bounds; the model's masks equal the reference's
    Pallas kernel and the plain version."""
    data, lo, up, ids = _case(m, q_n, seed=m * 1000 + q_n + 7)
    m_pad = data.shape[0]
    pairs = work_list(lo, up, m_pad, ids)
    assert pairs.sum() == sum(np.unique(r).size for r in ids)
    assert (pairs.sum(axis=1) <= ids.shape[1]).all()
    rows = int(pairs.any(axis=0).sum())
    n_pairs, qg = range_scan.scan_launch_shape(
        q_n, m_pad, min(m_pad, q_n * ids.shape[1], rows))
    plan = Plan(lo, up, m_rows=m_pad, n_pairs=n_pairs, dim_ids=ids)
    assert plan.rest.size == 0 and set(plan.union) == set(np.unique(ids))
    want = ref.multi_scan_vertical_ref(_t(data), _t(ids), _t(lo),
                                       _t(up)).numpy()
    np.testing.assert_array_equal(plan.masks(data), want)
    got = np.asarray(jms.multi_scan_vertical(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(lo), jnp.asarray(up),
        tile_n=TILE_N, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(multi_scan.multi_scan_vertical(
        _t(data), _t(ids), _t(lo), _t(up), tile_n=TILE_N, rows=rows).numpy(),
        want)


@pytest.mark.parametrize("m", MS)
def test_single_query_launches_match_reference(m):
    """Q = 1: the model of the one-query launch (its own constrained rows;
    for the vertical scan query 1's listed dims) equals the reference's
    Pallas range_scan_tiles / range_scan_vertical and the plain version."""
    data, lo, up, ids = _case(m, 4, seed=m)
    for k in range(3):  # no dim, an inverted interval, a NaN bound
        lk, uk = lo[:, k:k + 1], up[:, k:k + 1]
        n_pairs, _ = range_scan.scan_launch_shape(1, m, m)
        want = ref.range_scan_ref(_t(data), _t(lk), _t(uk)).numpy()
        np.testing.assert_array_equal(
            Plan(lk, uk, m_rows=m, n_pairs=n_pairs).masks(data)[0], want)
        np.testing.assert_array_equal(np.asarray(jrs.range_scan_tiles(
            jnp.asarray(data), jnp.asarray(lk), jnp.asarray(uk),
            tile_n=TILE_N, interpret=True)), want)
        dims = ids[k]
        n_pairs, _ = range_scan.scan_launch_shape(1, data.shape[0], dims.size)
        want = ref.range_scan_ref(_t(data[dims]), _t(lk[dims, 0]),
                                  _t(uk[dims, 0])).numpy()
        np.testing.assert_array_equal(
            Plan(lk, uk, m_rows=data.shape[0], n_pairs=n_pairs,
                 dim_ids=dims[None, :]).masks(data)[0], want)
        np.testing.assert_array_equal(np.asarray(jrs.range_scan_vertical(
            jnp.asarray(data), jnp.asarray(dims), jnp.asarray(lk),
            jnp.asarray(uk), tile_n=TILE_N, interpret=True)), want)


@pytest.mark.parametrize("n_pairs", [2, 4])
def test_too_few_slots_take_passes(n_pairs):
    """A union wider than the instance's slots (a rows hint too low) is
    read in several passes, each ANDed into the mask: the masks do not
    change."""
    data, lo, up, ids = _case(19, 32, seed=n_pairs)
    plan = Plan(lo, up, m_rows=19, n_pairs=n_pairs)
    assert len(plan.passes) > 1
    np.testing.assert_array_equal(
        plan.masks(data), ref.multi_scan_ref(_t(data), _t(lo), _t(up)).numpy())
    vplan = Plan(lo, up, m_rows=data.shape[0], n_pairs=n_pairs, dim_ids=ids)
    assert len(vplan.passes) > 1
    np.testing.assert_array_equal(
        vplan.masks(data),
        ref.multi_scan_vertical_ref(_t(data), _t(ids), _t(lo), _t(up)).numpy())


@pytest.mark.parametrize("m,q_n,rows", [(19, 221, None), (19, 261, None),
                                        (19, 405, 12), (100, 205, None),
                                        (100, 359, 12)])
def test_query_groups_share_the_launch_union(m, q_n, rows):
    """One query past a staged group (Q = qg + 1 of some launch): the
    kernel counts each row's constraining queries over every group and
    orders the union once per launch, then marks and stages each group on
    its own; the model run group by group equals the reference's Pallas
    kernels and the plain versions, also where the union takes several
    passes (the ``rows`` hint 12: 12 register slots)."""
    data, lo, up, ids = _case(m, q_n, seed=m * 1000 + q_n + 3)
    m_pad = data.shape[0]
    full_want = ref.multi_scan_ref(_t(data), _t(lo), _t(up)).numpy()
    np.testing.assert_array_equal(np.asarray(jms.multi_scan_tiles(
        jnp.asarray(data), jnp.asarray(lo), jnp.asarray(up), tile_n=TILE_N,
        interpret=True)), full_want)
    vert_want = ref.multi_scan_vertical_ref(_t(data), _t(ids), _t(lo),
                                            _t(up)).numpy()
    np.testing.assert_array_equal(np.asarray(jms.multi_scan_vertical(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(lo), jnp.asarray(up),
        tile_n=TILE_N, interpret=True)), vert_want)
    seen = []
    for m_rows, dim_ids, want in ((m, None, full_want), (m_pad, None, full_want),
                                  (m_pad, ids, vert_want)):
        n_pairs, qg = range_scan.scan_launch_shape(
            q_n, m_rows, min(m_rows, rows or m_rows))
        cnt = work_list(lo, up, m_rows, dim_ids).sum(axis=0)
        plans = [Plan(lo[:, g0:g0 + gs], up[:, g0:g0 + gs], m_rows=m_rows,
                      n_pairs=n_pairs, cnt=cnt,
                      dim_ids=None if dim_ids is None else dim_ids[g0:g0 + gs])
                 for g0, gs in groups(q_n, qg)]
        np.testing.assert_array_equal(
            np.concatenate([p.masks(data) for p in plans]), want)
        assert all(list(p.union) == list(plans[0].union) for p in plans)
        seen.append((qg, len(plans), len(plans[0].passes)))
    assert any(qg == q_n - 1 for qg, _, _ in seen), seen
    if rows is not None or m == 100:
        assert any(g > 1 and n_pass > 1 for _, g, n_pass in seen), seen


@pytest.mark.parametrize("q_n,m_rows,rows,want", [
    (1, 19, 7, (4, 1)),          # one query: its rows, one staged query
    (1, 24, 24, (12, 1)),
    (128, 19, 19, (10, 128)),    # GMRQB's full scan at B = 128
    (128, 24, 9, (6, 128)),      # its vertical bucket: a 9-row union
    (16, 19, 19, (10, 16)),      # the B = 128 scan bucket
    (1024, 104, 104, (12, 204)),  # shared memory holds 204 queries' bounds
])
def test_scan_launch_shape(q_n, m_rows, rows, want):
    """The smallest register instance that holds the rows (at most 24 per
    pass) and as many queries per group as 46 KB of shared memory holds."""
    assert range_scan.scan_launch_shape(q_n, m_rows, rows) == want


def test_launch_shape_rejects_rows_that_leave_no_room():
    with pytest.raises(ValueError):
        range_scan.scan_launch_shape(1, 4000, 4000)


def test_m_skips_only_padding_rows_on_the_cpu():
    """``m=`` compares rows [0, m): under the padding contract the masks
    are those of every row; a wrong m raises."""
    data, lo, up, _ = _case(19, 8, seed=3)
    want = ref.multi_scan_ref(_t(data), _t(lo), _t(up))
    assert torch.equal(multi_scan.multi_scan_tiles(_t(data), _t(lo), _t(up),
                                                   tile_n=TILE_N, m=19), want)
    assert torch.equal(range_scan.range_scan_tiles(
        _t(data), _t(lo[:, :1]), _t(up[:, :1]), tile_n=TILE_N, m=19), want[0])
    for bad in (0, 25):
        with pytest.raises(ValueError):
            multi_scan.multi_scan_tiles(_t(data), _t(lo), _t(up),
                                        tile_n=TILE_N, m=bad)
