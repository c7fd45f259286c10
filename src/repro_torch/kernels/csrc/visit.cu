// Block-visit scan for Hopper (sm_90a): phase 2 of every two-phase index.
//
// Replaces the Pallas TPU kernels multi_scan_visit
// (src/repro/kernels/multi_scan.py) and, as its launch with one bounds
// column and no query ids, range_scan_visit (src/repro/kernels/range_scan.py).
//
// What it computes: for each visit i of a flattened (query, block) list, the
// match mask of the (m_pad, tile_n) block bids[i] (negative ids clamp to block
// 0, as the TPU kernel's index map does; the caller drops those rows) against
// column qids[i] of the query-minor (m_pad, Q) bounds -> out[i, :tile_n] int8
// (the one-column launch has no qids and reads column 0).
//
// What bounds it on this card: device-memory bytes, if each visited block is
// read once per launch: m_pad * tile_n * 4 bytes per distinct block, tile_n
// mask bytes per visit, two float32 compares per element of each visit.
//
// Design (multi_scan_visit_sorted_kernel). The visit list is query-major (a
// block's ~37 visitors at GMRQB 10 M x 19, Q = 128, lie all over it), so one
// thread block per visit re-read each block once per visiting query: 35 GB
// per batch at the kd-tree's list. The wrapper (range_scan.visit_schedule)
// therefore sorts the list on the device by the key (clamped block, query)
// and this kernel takes it block-major: thread block r owns the fixed range
// [r K, r K + K) of sorted visits (K = VISITS_PER_BLOCK; the launcher halves
// K only when the staged bounds would not fit in shared memory), so no block
// serves more than K visits however many queries share a block, and the
// padding (all block 0, query 0) spreads over its own ranges. In a range,
// warp 0 finds the distinct keys with ballots; equal keys sit side by side,
// so each distinct (block, query) pair is computed once and stored to every
// output row that names it (the row is order[i], a 64-bit offset). Runs of
// distinct keys with one block share one read of the block: each thread owns
// VEC objects, loads ROW_GROUP rows of them as float4s into registers, and
// compares them against every visit of the run, reading the bounds from
// shared memory as broadcasts; the running per-visit result (VEC bits) lives
// in shared memory between row groups, so any m_pad % 8 == 0 runs without
// spills. A warp whose objects all failed a visit skips that visit's later
// row groups. The block itself is never staged in shared memory (re-reading
// 96 KB once per visit would cost more than the device-memory read saved).
//
// multi_scan_visit_kernel keeps one thread block per visit, in list order.
// It serves the one-column launch (range_scan_visit: one query, blocks
// already ascending, nothing to share).
#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int VISITS_PER_BLOCK = 64;   // K; kernels/range_scan.py mirrors it
constexpr int ROW_GROUP = 8;           // rows held in registers at once
constexpr unsigned FULL = 0xffffffffu;

// data (m_pad, n_pad) f32; bids (n_visit,) i32; lower/upper (m_pad, q_n) f32,
// column 0 read; out (n_visit, tile_n) i8.
// Shared memory: the query's (m_pad,) float2 bounds.
__global__ void multi_scan_visit_kernel(const float* __restrict__ data, int64_t n_pad,
                                        int m_pad, const int32_t* __restrict__ bids,
                                        const float* __restrict__ lower,
                                        const float* __restrict__ upper, int q_n,
                                        int tile_n, int8_t* __restrict__ out) {
  extern __shared__ float2 bnd[];
  const int64_t v = blockIdx.x;
  const int64_t n_blocks = n_pad / tile_n;
  const int64_t bid = bids[v];
  const int64_t b = bid < 0 ? 0 : (bid >= n_blocks ? n_blocks - 1 : bid);
  for (int j = threadIdx.x; j < m_pad; j += blockDim.x) {
    const int64_t at = static_cast<int64_t>(j) * q_n;
    bnd[j] = make_float2(lower[at], upper[at]);
  }
  __syncthreads();
  const float* block = data + b * tile_n;
  int8_t* dst = out + v * tile_n;
  for (int o = threadIdx.x * VEC; o < tile_n; o += blockDim.x * VEC) {
    bool h0 = true, h1 = true, h2 = true, h3 = true;
#pragma unroll 4
    for (int j = 0; j < m_pad; ++j) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          block + static_cast<int64_t>(j) * n_pad + o));
      const float2 bj = bnd[j];
      h0 &= x.x >= bj.x && x.x <= bj.y;
      h1 &= x.y >= bj.x && x.y <= bj.y;
      h2 &= x.z >= bj.x && x.z <= bj.y;
      h3 &= x.w >= bj.x && x.w <= bj.y;
    }
    *reinterpret_cast<char4*>(dst + o) = make_char4(h0, h1, h2, h3);
  }
}

// Shared-memory layout of the block-major kernel for k visits per range and
// t threads: bounds (k, m_pad) float2, rows (k,) i64, ublk / uq / uid (k,)
// i32, result bits (k, t) u8.
struct SortedSmem {
  float2* bnd;
  int64_t* rows;
  int32_t* ublk;
  int32_t* uq;
  int32_t* uid;
  uint8_t* res;

  __host__ __device__ static size_t bytes(int k, int m_pad, int t) {
    return static_cast<size_t>(k) * m_pad * sizeof(float2) +
           static_cast<size_t>(k) * (sizeof(int64_t) + 3 * sizeof(int32_t)) +
           static_cast<size_t>(k) * t;
  }
  __device__ SortedSmem(void* base, int k, int m_pad) {
    bnd = static_cast<float2*>(base);
    rows = reinterpret_cast<int64_t*>(bnd + static_cast<size_t>(k) * m_pad);
    ublk = reinterpret_cast<int32_t*>(rows + k);
    uq = ublk + k;
    uid = uq + k;
    res = reinterpret_cast<uint8_t*>(uid + k);
  }
};

// keys (n_visit,) i64 ascending, key = block * q_n + query (both clamped);
// order (n_visit,) i64: the output row of each sorted visit; k visits per
// thread block. Other arguments as multi_scan_visit_kernel's.
__global__ void multi_scan_visit_sorted_kernel(
    const float* __restrict__ data, int64_t n_pad, int m_pad, const int64_t* __restrict__ keys,
    const int64_t* __restrict__ order, int64_t n_visit, int k,
    const float* __restrict__ lower, const float* __restrict__ upper, int q_n,
    int tile_n, int8_t* __restrict__ out) {
  extern __shared__ float4 smem_visit[];
  __shared__ int n_uniq_s;
  SortedSmem s(smem_visit, k, m_pad);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * k;
  const int cnt = n_visit - v0 < k ? static_cast<int>(n_visit - v0) : k;
  const int64_t n_blocks = n_pad / tile_n;

  // Warp 0: the range's distinct keys, in order (u = 0 .. n_uniq), and for
  // each visit the index of its key among them.
  if (tid < 32) {
    int base = 0;
    for (int c = 0; c < cnt; c += 32) {
      const int i = c + tid;
      const bool valid = i < cnt;
      const int64_t key = valid ? keys[v0 + i] : 0;
      const bool first = valid && (i == 0 || keys[v0 + i - 1] != key);
      const unsigned ball = __ballot_sync(FULL, first);
      if (valid) {
        const int u = base - 1 + __popc(ball & (FULL >> (31 - tid)));
        s.uid[i] = u;
        s.rows[i] = order[v0 + i];
        if (first) {
          const int64_t b = key / q_n;
          s.ublk[u] = static_cast<int32_t>(b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b));
          s.uq[u] = min(max(static_cast<int>(key - b * q_n), 0), q_n - 1);
        }
      }
      base += __popc(ball);
    }
    if (tid == 0) n_uniq_s = base;
  }
  __syncthreads();
  const int nu = n_uniq_s;
  for (int e = tid; e < nu * m_pad; e += T) {
    const int u = e / m_pad;
    const int64_t at = static_cast<int64_t>(e - u * m_pad) * q_n + s.uq[u];
    s.bnd[e] = make_float2(lower[at], upper[at]);
  }
  __syncthreads();

  // From here on every thread only touches its own result bytes, and every
  // loop bound is uniform across the thread block.
  for (int o = tid * VEC; o < tile_n; o += T * VEC) {
    for (int u0 = 0; u0 < nu;) {
      const int b = s.ublk[u0];
      int u1 = u0 + 1;
      while (u1 < nu && s.ublk[u1] == b) ++u1;
      const float* src = data + static_cast<int64_t>(b) * tile_n + o;
      for (int j0 = 0; j0 < m_pad; j0 += ROW_GROUP) {
        float4 x[ROW_GROUP];
#pragma unroll
        for (int r = 0; r < ROW_GROUP; ++r)
          x[r] = __ldg(reinterpret_cast<const float4*>(
              src + static_cast<int64_t>(j0 + r) * n_pad));
        for (int u = u0; u < u1; ++u) {
          uint32_t bits = 0xfu;
          if (j0 > 0) {
            bits = s.res[u * T + tid];
            if (!__any_sync(FULL, bits)) continue;  // the warp's objects all failed
          }
          bool h0 = bits & 1u, h1 = bits & 2u, h2 = bits & 4u, h3 = bits & 8u;
          const float4* bb = reinterpret_cast<const float4*>(s.bnd + u * m_pad + j0);
#pragma unroll
          for (int r = 0; r < ROW_GROUP; r += 2) {
            const float4 p = bb[r / 2];  // (lo_r, up_r, lo_r+1, up_r+1)
            h0 &= x[r].x >= p.x && x[r].x <= p.y && x[r + 1].x >= p.z && x[r + 1].x <= p.w;
            h1 &= x[r].y >= p.x && x[r].y <= p.y && x[r + 1].y >= p.z && x[r + 1].y <= p.w;
            h2 &= x[r].z >= p.x && x[r].z <= p.y && x[r + 1].z >= p.z && x[r + 1].z <= p.w;
            h3 &= x[r].w >= p.x && x[r].w <= p.y && x[r + 1].w >= p.z && x[r + 1].w <= p.w;
          }
          s.res[u * T + tid] = static_cast<uint8_t>(h0 | (h1 << 1) | (h2 << 2) | (h3 << 3));
        }
      }
      u0 = u1;
    }
    for (int i = 0; i < cnt; ++i) {
      const uint32_t bits = s.res[s.uid[i] * T + tid];
      *reinterpret_cast<char4*>(out + s.rows[i] * tile_n + o) =
          make_char4(bits & 1u, (bits >> 1) & 1u, (bits >> 2) & 1u, bits >> 3);
    }
  }
}

}  // namespace

extern "C" int mdrq_multi_scan_visit(const float* data, long long n_pad, int m_pad,
                                     const int* bids, long long n_visit,
                                     const float* lower, const float* upper, int q_n,
                                     int tile_n, signed char* out, int device,
                                     void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (n_visit <= 0) return cudaSuccess;
  if (n_visit > 0x7fffffffLL || tile_n % (VEC * 32) || q_n < 1)
    return cudaErrorInvalidValue;
  const int threads = min(256, tile_n / VEC);
  const size_t smem = static_cast<size_t>(m_pad) * sizeof(float2);
  MDRQ_TRY(mdrq::allow_smem(multi_scan_visit_kernel, smem));
  multi_scan_visit_kernel<<<static_cast<unsigned>(n_visit), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, bids, lower, upper, q_n, tile_n,
      reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

extern "C" int mdrq_multi_scan_visit_sorted(const float* data, long long n_pad, int m_pad,
                                            const long long* keys, const long long* order,
                                            long long n_visit, const float* lower,
                                            const float* upper, int q_n, int tile_n,
                                            signed char* out, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (n_visit <= 0) return cudaSuccess;
  if (n_visit > 0x7fffffffLL || tile_n % (VEC * 32) || q_n < 1 || m_pad < ROW_GROUP ||
      m_pad % ROW_GROUP)
    return cudaErrorInvalidValue;
  const int threads = min(256, tile_n / VEC);
  // less the kernel's static shared memory (one int)
  const size_t limit = static_cast<size_t>(mdrq::smem_optin(device)) - 16;
  int k = VISITS_PER_BLOCK;
  while (k > 1 && SortedSmem::bytes(k, m_pad, threads) > limit) k /= 2;
  const size_t smem = SortedSmem::bytes(k, m_pad, threads);
  if (smem > limit) return cudaErrorInvalidConfiguration;
  const long long blocks = (n_visit + k - 1) / k;
  MDRQ_TRY(mdrq::allow_smem(multi_scan_visit_sorted_kernel, smem));
  multi_scan_visit_sorted_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, reinterpret_cast<const int64_t*>(keys),
      reinterpret_cast<const int64_t*>(order), n_visit, k, lower, upper, q_n, tile_n,
      reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
