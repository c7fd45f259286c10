// Columnar range scans for Hopper (sm_90a): the full scan and the
// partial-match (vertical) scan of a query batch, one kernel template.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/multi_scan.py
// (multi_scan_tiles, multi_scan_vertical) and, as their Q = 1 launches, the
// single-query bodies in src/repro/kernels/range_scan.py (range_scan_tiles,
// range_scan_vertical).
//
// What it computes: out[q, i] = 1 where every compared dim j of query q has
// lower[j, q] <= x[j, i] <= upper[j, q], as int8. The full scan compares
// every row below m_rows (rows m_rows..m_pad-1 are the layout's dim padding:
// 0.0 for real objects, +inf for padding objects, under match-all bounds,
// so skipping them changes no mask); the vertical scan compares the distinct
// dims each query lists in dim_ids.
//
// What bounds it on this card: at Q = 1, device-memory bytes (the rows read
// once, one mask byte written per object). At Q = 128, the compares: two per
// object per (query, constrained dim) at the compare issue rate of sm_90 (64
// per clock per SM: 16.7 T/s at 1,980 MHz on 132 SMs, a quarter of the
// 67 TFLOP/s that counts an FFMA as two operations), beside Q mask bytes
// written per object.
//
// Design.
//  * Only the compares the function needs. A full-scan dim whose bounds are
//    exactly the float32 extrema (-FLT_MAX, FLT_MAX) is open: for every
//    float32 x, -FLT_MAX <= x <= FLT_MAX holds iff x is finite, so the
//    kernel tests finiteness once per (object, row) instead of comparing
//    once per query. That is what rejects +inf padding objects, +inf
//    tombstoned delta rows and any inf or NaN in a real row, exactly as the
//    reference's compare does. The vertical scan compares each distinct
//    listed dim once (repeated pad entries are dropped). No query slot that
//    the launch does not have is compared: Q = 1 costs one query.
//  * Each thread block builds its work list in a prologue, with no host
//    read: per row, how many queries constrain it (distinct (query, dim)
//    pairs, by atomics on per-query row bits in shared memory); the rows
//    any query constrains, ordered by that count (the union: rows many
//    queries use take the first slots); the rows no query constrains (the
//    full scan only tests their finiteness). Per query it stages k, the
//    slots through its last constrained one, and the bounds of those k
//    slots, NaN in a slot the query leaves open; then it sorts the queries
//    by k (counting sort).
//  * Each thread owns VEC = 4 consecutive objects and holds 2 * NP union
//    rows of them in registers as float4s (NP a template constant the
//    wrapper picks from the shapes and the caller's row count: up to 24
//    rows per pass; more rows take further passes that AND into the mask
//    already written). Nothing of the data is staged in shared memory: each
//    row is read once per tile with coalesced 16-byte loads. The queries of
//    one k run as one loop of straight-line code (no per-query dispatch):
//    per object a single chain of compares, each an FSETP that ANDs into
//    the running predicate, p = p & !(x > hi) & !(x < lo), which a NaN
//    bound (the neutral slot) always passes. That unordered form differs
//    from x >= lo && x <= hi only when x or a bound is NaN: a constrained
//    NaN bound makes the query match nothing (flagged in the prologue), and
//    NaN or inf data is settled by per-object bit masks in a second loop
//    that a warp runs only when one of its objects holds a non-finite value
//    (the +inf padding objects at the end of the data, tombstoned delta
//    rows).
//  * The block is persistent: one block per resident slot on the card walks
//    the tiles, so the prologue runs once per block. The bounds of up to qg
//    queries fit in 46 KB of shared memory (qg chosen by the wrapper);
//    larger batches restage per tile. Masks are written as one 4-byte word
//    per (query, thread): a warp stores 128 contiguous bytes of one mask
//    row. Offsets into the (Q, n_pad) mask are 64-bit.
#include <atomic>

#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int THREADS = 128;
constexpr float FMAX = 3.402823466e+38f;  // FLT_MAX
constexpr unsigned FULL_MASK = 0xffffffffu;

struct ScanParams {
  const float* data;       // (m_pad, n_pad) f32
  int64_t n_pad;
  int m_rows;              // rows [0, m_rows) may be compared
  const int32_t* dim_ids;  // vertical: (q_n, d_max) i32; full scan: null
  int d_max;
  const float* lower;      // (m_pad, q_n) f32, query-minor
  const float* upper;
  int q_n;
  int qg;                  // queries whose bounds are staged at a time
  int8_t* out;             // (q_n, n_pad) i8
};

// Dynamic shared memory of a block. Per staged query: its pair bounds and
// (query, flags, slot mask) in run order (sorted by slot count), the same
// per query index while staging, and its row bits; per row: its count, the
// union (slot -> row) and the rows no query constrains.
template <int NP>
struct Layout {
  float4* bnd;      // (qg, NP) in run order: (lo, hi) of slots 2c, 2c + 1
  int2* run;        // (qg,) in run order: (ql | empty << 16, slot mask)
  int2* meta;       // (qg,) by query: (k | empty << 8, slot mask)
  uint32_t* qbits;  // (qg, w)
  int* cnt;
  int* urow;
  int* rest;

  __host__ __device__ static size_t bytes(int qg, int w, int m_rows) {
    return static_cast<size_t>(qg) *
               (NP * sizeof(float4) + 2 * sizeof(int2) + w * sizeof(uint32_t)) +
           3 * static_cast<size_t>(m_rows) * sizeof(int);
  }
  __device__ Layout(void* base, int qg, int w, int m_rows) {
    bnd = static_cast<float4*>(base);
    run = reinterpret_cast<int2*>(bnd + static_cast<size_t>(qg) * NP);
    meta = run + qg;
    qbits = reinterpret_cast<uint32_t*>(meta + qg);
    cnt = reinterpret_cast<int*>(qbits + static_cast<size_t>(qg) * w);
    urow = cnt + m_rows;
    rest = urow + m_rows;
  }
};

// p && !(v > hi) && !(v < lo), as two compares that each AND into p (one
// FSETP.LEU.AND, one FSETP.GEU.AND): v >= lo && v <= hi, except that a NaN
// bound (the neutral slot) passes every v and a NaN v passes every bound.
__device__ __forceinline__ bool inside(bool p, float v, float lo, float hi) {
  p = p & !(v > hi);
  return p & !(v < lo);
}

__device__ __forceinline__ bool finite_f(float v) { return fabsf(v) <= FMAX; }

// Bit v set where object v of a float4 is not finite (inf or NaN).
__device__ __forceinline__ uint32_t nonfinite4(float4 v) {
  return static_cast<uint32_t>(!finite_f(v.x)) | static_cast<uint32_t>(!finite_f(v.y)) << 1 |
         static_cast<uint32_t>(!finite_f(v.z)) << 2 | static_cast<uint32_t>(!finite_f(v.w)) << 3;
}

__device__ __forceinline__ uint32_t bit_if(bool c, int at) {
  return static_cast<uint32_t>(c) << at;
}

// One query against the first K union slots of the thread's 4 objects, as
// one straight chain of compares per object (no join inside, so the
// running results stay in predicates); bounds bq[c] = (lo, hi) of slots 2c
// and 2c + 1. Returns the char4 mask word (byte v = object v matches).
template <int K, int SLOTS>
__device__ __forceinline__ uint32_t run_slots(const float4 (&x)[SLOTS], const float4* bq,
                                              bool start) {
  bool p0 = start, p1 = start, p2 = start, p3 = start;
#pragma unroll
  for (int sl = 0; sl < K; ++sl) {
    const float4 b = bq[sl / 2];
    const float lo = sl % 2 ? b.z : b.x, hi = sl % 2 ? b.w : b.y;
    p0 = inside(p0, x[sl].x, lo, hi);
    p1 = inside(p1, x[sl].y, lo, hi);
    p2 = inside(p2, x[sl].z, lo, hi);
    p3 = inside(p3, x[sl].w, lo, hi);
  }
  uint32_t w = 0x01010101u;
  if (!p0) w &= 0xffffff00u;
  if (!p1) w &= 0xffff00ffu;
  if (!p2) w &= 0xff00ffffu;
  if (!p3) w &= 0x00ffffffu;
  return w;
}

// The staged queries whose last constrained slot is K - 1 (run positions
// [i0, i1)): one loop with no per-query dispatch. out0 points at object o
// of query g0's mask row; with rmw (a later pass) the mask already written
// is ANDed in.
template <int K, int NP>
__device__ __forceinline__ void run_queries(const float4 (&x)[2 * NP], const float4* bnd,
                                            const int2* run, int i0, int i1, int8_t* out0,
                                            int64_t n_pad, bool rmw) {
  for (int i = i0; i < i1; ++i) {
    const int2 r = run[i];
    uint32_t* dst = reinterpret_cast<uint32_t*>(out0 + (r.x & 0xffff) * n_pad);
    uint32_t w = run_slots<K, 2 * NP>(x, bnd + i * NP, !(r.x & 0x10000));
    if (rmw) w &= *dst;  // bytes 0 or 1
    *dst = w;
  }
}

template <int NP, bool FULL>
__global__ void __launch_bounds__(THREADS) scan_kernel(const ScanParams p) {
  constexpr int SLOTS = 2 * NP;
  extern __shared__ float4 smem_scan[];
  __shared__ int n_u_s, n_rest_s;
  __shared__ int kstart[SLOTS + 2], kcursor[SLOTS + 1];
  const int tid = threadIdx.x;
  const int w = (p.m_rows + 31) / 32;
  Layout<NP> s(smem_scan, p.qg, w, p.m_rows);
  const float qnan = __int_as_float(0x7fc00000);

  // The rows each query of [g0, g0 + gs) constrains -> s.qbits; with
  // count, each row's number of constraining queries is added to s.cnt.
  auto mark = [&](int g0, int gs, bool count) {
    for (int i = tid; i < gs * w; i += THREADS) s.qbits[i] = 0;
    __syncthreads();
    if constexpr (FULL) {
      for (int i = tid; i < gs * p.m_rows; i += THREADS) {
        const int ql = i % gs, j = i / gs;
        const int64_t at = static_cast<int64_t>(j) * p.q_n + g0 + ql;
        if (!(p.lower[at] == -FMAX && p.upper[at] == FMAX)) {
          atomicOr(&s.qbits[ql * w + (j >> 5)], 1u << (j & 31));
          if (count) atomicAdd(&s.cnt[j], 1);
        }
      }
    } else {
      // Ids out of range are clamped so a bad id can never read outside
      // the data; the op layer rejects them on the host.
      for (int i = tid; i < gs * p.d_max; i += THREADS) {
        const int ql = i / p.d_max;
        const int d = p.dim_ids[static_cast<int64_t>(g0 + ql) * p.d_max + i % p.d_max];
        const int j = min(max(d, 0), p.m_rows - 1);
        const uint32_t bit = 1u << (j & 31);
        const uint32_t old = atomicOr(&s.qbits[ql * w + (j >> 5)], bit);
        if (count && !(old & bit)) atomicAdd(&s.cnt[j], 1);
      }
    }
    __syncthreads();
  };

  // Prologue: counts, then the union in order of count (ties by row) and
  // the rows no query constrains.
  for (int j = tid; j < p.m_rows; j += THREADS) s.cnt[j] = 0;
  if (tid == 0) n_u_s = n_rest_s = 0;
  for (int g0 = 0; g0 < p.q_n; g0 += p.qg) mark(g0, min(p.qg, p.q_n - g0), true);
  for (int j = tid; j < p.m_rows; j += THREADS) {
    const int c = s.cnt[j];
    int r = 0;
    if (c > 0) {
      for (int i = 0; i < p.m_rows; ++i) {
        const int ci = s.cnt[i];
        r += ci > c || (ci == c && i < j);
      }
      s.urow[r] = j;
      atomicAdd(&n_u_s, 1);
    } else if (FULL) {
      for (int i = 0; i < j; ++i) r += s.cnt[i] == 0;
      s.rest[r] = j;
      atomicAdd(&n_rest_s, 1);
    }
  }
  __syncthreads();
  const int n_u = n_u_s, n_rest = n_rest_s;

  // The group's queries for the union slots of one pass (needs the group's
  // s.qbits): per query its slot mask, its slot count k (through the last
  // constrained slot) and whether a constrained bound is NaN (x >= NaN
  // never holds: the query matches nothing); then the queries in order of
  // k (counting sort; the order within one k is immaterial), each with the
  // bounds of its first k slots, NaN in the slots it leaves open.
  auto stage = [&](int g0, int gs, int pass) {
    const int s0 = pass * SLOTS;
    for (int k = tid; k <= SLOTS; k += THREADS) kcursor[k] = 0;
    __syncthreads();
    for (int ql = tid; ql < gs; ql += THREADS) {
      uint32_t cm = 0;
      bool empty = false;
      for (int sl = 0; sl < SLOTS && s0 + sl < n_u; ++sl) {
        const int j = s.urow[s0 + sl];
        if (s.qbits[ql * w + (j >> 5)] >> (j & 31) & 1u) {
          const int64_t at = static_cast<int64_t>(j) * p.q_n + g0 + ql;
          empty = empty || isnan(p.lower[at]) || isnan(p.upper[at]);
          cm |= 1u << sl;
        }
      }
      const int k = cm ? 32 - __clz(cm) : 0;
      s.meta[ql] = make_int2(k | (empty ? 256 : 0), static_cast<int>(cm));
      atomicAdd(&kcursor[k], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int at = 0;
      for (int k = 0; k <= SLOTS; ++k) {
        kstart[k] = at;
        at += kcursor[k];
        kcursor[k] = kstart[k];
      }
      kstart[SLOTS + 1] = at;
    }
    __syncthreads();
    for (int ql = tid; ql < gs; ql += THREADS) {
      const int2 mt = s.meta[ql];
      const int k = mt.x & 255;
      const int i = atomicAdd(&kcursor[k], 1);
      s.run[i] = make_int2(ql | (mt.x & 256) << 8, mt.y);
      for (int c = 0; 2 * c < k; ++c) {
        float b[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sl = 2 * c + h;
          float lo = qnan, hi = qnan;  // neutral: every x passes
          if (mt.y >> sl & 1) {
            const int64_t at = static_cast<int64_t>(s.urow[s0 + sl]) * p.q_n + g0 + ql;
            lo = p.lower[at];
            hi = p.upper[at];
          }
          b[2 * h] = lo;
          b[2 * h + 1] = hi;
        }
        s.bnd[i * NP + c] = make_float4(b[0], b[1], b[2], b[3]);
      }
    }
  };

  const int n_groups = (p.q_n + p.qg - 1) / p.qg;
  const int n_pass = n_u > 0 ? (n_u + SLOTS - 1) / SLOTS : 1;
  const bool restage = n_groups * n_pass > 1;
  if (!restage) {
    stage(0, p.q_n, 0);
    __syncthreads();
  }

  const int n_tiles = static_cast<int>((p.n_pad + THREADS * VEC - 1) / (THREADS * VEC));
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t o = (static_cast<int64_t>(t) * THREADS + tid) * VEC;
    const bool live = o < p.n_pad;  // uniform per warp: n_pad % 128 == 0
    const float* col = p.data + o;
    int8_t* const out_o = p.out + o;  // query 0's mask word of this thread
    // Full scan, bit v: object v holds a non-finite value in a row no query
    // constrains (it then matches no query).
    uint32_t rest_bad = 0;
    if (FULL && live) {
      int r = 0;
      for (; r + 4 <= n_rest; r += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              col + static_cast<int64_t>(s.rest[r + u]) * p.n_pad));
#pragma unroll
        for (int u = 0; u < 4; ++u) rest_bad |= nonfinite4(v[u]);
      }
      for (; r < n_rest; ++r)
        rest_bad |= nonfinite4(__ldg(reinterpret_cast<const float4*>(
            col + static_cast<int64_t>(s.rest[r]) * p.n_pad)));
    }
    for (int pass = 0; pass < n_pass; ++pass) {
      const int s0 = pass * SLOTS;
      float4 x[SLOTS];
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        x[sl] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && s0 + sl < n_u)
          x[sl] = __ldg(reinterpret_cast<const float4*>(
              col + static_cast<int64_t>(s.urow[s0 + sl]) * p.n_pad));
      }
      uint32_t bad = rest_bad;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) bad |= nonfinite4(x[sl]);
      // Taken by a warp one of whose objects holds a non-finite value.
      const bool slow = __any_sync(FULL_MASK, bad != 0);

      for (int g0 = 0; g0 < p.q_n; g0 += p.qg) {
        const int gs = min(p.qg, p.q_n - g0);
        if (restage) {
          __syncthreads();  // every thread is done with the last stage
          if (n_groups > 1) mark(g0, gs, false);
          stage(g0, gs, pass);
          __syncthreads();
        }
        if (!live) continue;
        int8_t* out0 = out_o + static_cast<int64_t>(g0) * p.n_pad;
        const bool rmw = pass > 0;
#define MDRQ_SCAN_RUNS(K)                                                        \
  if constexpr ((K) <= SLOTS)                                                    \
    run_queries<(K), NP>(x, s.bnd, s.run, kstart[(K)], kstart[(K) + 1], out0, p.n_pad, rmw);
        MDRQ_SCAN_RUNS(0) MDRQ_SCAN_RUNS(1) MDRQ_SCAN_RUNS(2) MDRQ_SCAN_RUNS(3)
        MDRQ_SCAN_RUNS(4) MDRQ_SCAN_RUNS(5) MDRQ_SCAN_RUNS(6) MDRQ_SCAN_RUNS(7)
        MDRQ_SCAN_RUNS(8) MDRQ_SCAN_RUNS(9) MDRQ_SCAN_RUNS(10) MDRQ_SCAN_RUNS(11)
        MDRQ_SCAN_RUNS(12) MDRQ_SCAN_RUNS(13) MDRQ_SCAN_RUNS(14) MDRQ_SCAN_RUNS(15)
        MDRQ_SCAN_RUNS(16) MDRQ_SCAN_RUNS(17) MDRQ_SCAN_RUNS(18) MDRQ_SCAN_RUNS(19)
        MDRQ_SCAN_RUNS(20) MDRQ_SCAN_RUNS(21) MDRQ_SCAN_RUNS(22) MDRQ_SCAN_RUNS(23)
        MDRQ_SCAN_RUNS(24)
#undef MDRQ_SCAN_RUNS
        if (slow) {
          // Settle non-finite values per object: a constrained NaN passed
          // the compares (reject it); full scan: a slot or row the query
          // leaves open must be finite. Bit sl: slot sl not finite / NaN.
          uint32_t nf0 = 0, nf1 = 0, nf2 = 0, nf3 = 0, nn0 = 0, nn1 = 0, nn2 = 0, nn3 = 0;
#pragma unroll
          for (int sl = 0; sl < SLOTS; ++sl) {
            nf0 |= bit_if(!finite_f(x[sl].x), sl);
            nf1 |= bit_if(!finite_f(x[sl].y), sl);
            nf2 |= bit_if(!finite_f(x[sl].z), sl);
            nf3 |= bit_if(!finite_f(x[sl].w), sl);
            nn0 |= bit_if(isnan(x[sl].x), sl);
            nn1 |= bit_if(isnan(x[sl].y), sl);
            nn2 |= bit_if(isnan(x[sl].z), sl);
            nn3 |= bit_if(isnan(x[sl].w), sl);
          }
          for (int i = 0; i < gs; ++i) {
            const int2 r = s.run[i];
            const uint32_t cm = static_cast<uint32_t>(r.y);
            bool ok0 = !(nn0 & cm), ok1 = !(nn1 & cm), ok2 = !(nn2 & cm), ok3 = !(nn3 & cm);
            if constexpr (FULL) {
              ok0 = ok0 && !(rest_bad & 1u) && !(nf0 & ~cm);
              ok1 = ok1 && !(rest_bad & 2u) && !(nf1 & ~cm);
              ok2 = ok2 && !(rest_bad & 4u) && !(nf2 & ~cm);
              ok3 = ok3 && !(rest_bad & 8u) && !(nf3 & ~cm);
            }
            uint32_t keep = 0xffffffffu;
            if (!ok0) keep &= 0xffffff00u;
            if (!ok1) keep &= 0xffff00ffu;
            if (!ok2) keep &= 0xff00ffffu;
            if (!ok3) keep &= 0x00ffffffu;
            if (keep != 0xffffffffu) {
              uint32_t* dst = reinterpret_cast<uint32_t*>(out0 + (r.x & 0xffff) * p.n_pad);
              *dst &= keep;
            }
          }
        }
      }
    }
  }
}

template <int NP, bool FULL>
cudaError_t launch_scan(const ScanParams& p, int device, cudaStream_t stream) {
  const int w = (p.m_rows + 31) / 32;
  const size_t smem = Layout<NP>::bytes(p.qg, w, p.m_rows);
  // less the kernel's static shared memory (at most 53 ints)
  if (smem + 256 > static_cast<size_t>(mdrq::smem_optin(device)))
    return cudaErrorInvalidConfiguration;
  auto kernel = scan_kernel<NP, FULL>;
  MDRQ_TRY(mdrq::allow_smem(kernel, smem));
  int sms = 0, per_sm = 0;
  MDRQ_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  // Blocks per SM for this instance, device and shared memory size: asked
  // once per key, not on every launch of the host-bound one-query path.
  static std::atomic<long long> cached{-1};  // smem << 16 | device << 8 | per_sm
  const long long key = static_cast<long long>(smem) << 16 | static_cast<long long>(device) << 8;
  const long long hit = cached.load(std::memory_order_relaxed);
  if (hit >= 0 && (hit & ~0xffLL) == key) {
    per_sm = static_cast<int>(hit & 0xff);
  } else {
    MDRQ_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem));
    if (per_sm < 1 || per_sm > 255) return cudaErrorInvalidConfiguration;
    cached.store(key | per_sm, std::memory_order_relaxed);
  }
  const long long tiles = (p.n_pad + THREADS * VEC - 1) / (THREADS * VEC);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool FULL>
cudaError_t dispatch(int n_pairs, const ScanParams& p, int device, cudaStream_t stream) {
  switch (n_pairs) {
    case 2: return launch_scan<2, FULL>(p, device, stream);
    case 4: return launch_scan<4, FULL>(p, device, stream);
    case 6: return launch_scan<6, FULL>(p, device, stream);
    case 8: return launch_scan<8, FULL>(p, device, stream);
    case 10: return launch_scan<10, FULL>(p, device, stream);
    case 12: return launch_scan<12, FULL>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The full scan (dim_ids null: rows [0, m_rows) compared) or the vertical
// scan (dim_ids (q_n, d_max), m_rows = m_pad). n_pairs (2, 4, 6, 8, 10 or 12)
// and qg are the wrapper's choice (range_scan.scan_launch_shape).
extern "C" int mdrq_scan(const float* data, long long n_pad, int m_pad, int m_rows,
                         const int* dim_ids, int d_max, const float* lower,
                         const float* upper, int q_n, int n_pairs, int qg,
                         signed char* out, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (n_pad < 0 || n_pad % (VEC * 32) || q_n < 1 || qg < 1 || m_rows < 1 ||
      m_rows > m_pad || (dim_ids != nullptr && d_max < 1) ||
      n_pad / (VEC * THREADS) >= 0x7fffffffLL)  // tile indices are int
    return cudaErrorInvalidValue;
  if (n_pad == 0) return cudaSuccess;
  const ScanParams p{data, n_pad, m_rows, dim_ids, d_max, lower, upper, q_n,
                     qg < q_n ? qg : q_n, reinterpret_cast<int8_t*>(out)};
  const auto st = static_cast<cudaStream_t>(stream);
  return dim_ids == nullptr ? dispatch<true>(n_pairs, p, device, st)
                            : dispatch<false>(n_pairs, p, device, st);
}

MDRQ_ERROR_STRING_FN
