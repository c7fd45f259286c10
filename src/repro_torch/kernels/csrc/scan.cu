// Fused columnar range scans for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/multi_scan.py
// (multi_scan_tiles, multi_scan_vertical) and, as their Q=1 launches, the
// single-query bodies in src/repro/kernels/range_scan.py (range_scan_tiles,
// range_scan_vertical).
//
// What bounds them on this card: at batch size Q the full scan reads
// m_pad * n_pad * 4 bytes and writes Q * n_pad mask bytes, and does
// 2 * m_pad * Q * n_pad float32 compares. At Q = 1 the bytes bound it; at
// Q = 128 and m_pad = 24 the compares do (about as many operations as bytes
// moved, against a float32 rate of 67 TFLOP/s and 3.35 TB/s).
//
// Design. The TPU kernel puts the query axis innermost so each data tile is
// fetched once per batch. Here a thread block owns VEC * blockDim.x
// consecutive objects: it copies their m_pad attribute rows from device
// memory into shared memory once, then loops over every query of the batch.
// Queries go in groups of 32 whose bounds are staged in shared memory as
// (lo, hi) pairs, and each thread keeps one "missed" bit per query in a
// uint32 per object, so the inner loop is a broadcast load of one bound pair
// and eight compares for four objects. Masks are written as one char4 per
// (query, thread): a warp stores 128 contiguous bytes of one mask row.
// Offsets into the (Q, n_pad) mask are 64-bit: Q * n_pad passes INT32_MAX at
// n = 10 M and Q >= 256.
#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int QG = 32;  // queries per group: one bit each in a uint32

__device__ __forceinline__ uint32_t missed(float x, float2 b) {
  return !(x >= b.x && x <= b.y);
}

__device__ __forceinline__ char4 hits(uint32_t f0, uint32_t f1, uint32_t f2,
                                      uint32_t f3, int q) {
  return make_char4(static_cast<signed char>(((f0 >> q) & 1u) ^ 1u),
                    static_cast<signed char>(((f1 >> q) & 1u) ^ 1u),
                    static_cast<signed char>(((f2 >> q) & 1u) ^ 1u),
                    static_cast<signed char>(((f3 >> q) & 1u) ^ 1u));
}

// data (m_pad, n_pad) f32; lower/upper (m_pad, q_n) f32, query-minor;
// out (q_n, n_pad) int8. Shared memory: the block's (m_pad, blockDim.x)
// float4 tile, then a (m_pad, QG) float2 bounds table.
__global__ void multi_scan_kernel(const float* __restrict__ data, int64_t n_pad,
                                  int m_pad, const float* __restrict__ lower,
                                  const float* __restrict__ upper, int q_n,
                                  int8_t* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  float4* tile = smem;
  float2* bnd = reinterpret_cast<float2*>(tile + static_cast<size_t>(m_pad) * T);
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * T + tid) * VEC;

  // Each thread reads back only its own tile column, so the tile needs no
  // barrier of its own; the first group's barrier below orders it anyway.
  for (int j = 0; j < m_pad; ++j)
    tile[j * T + tid] = __ldg(reinterpret_cast<const float4*>(
        data + static_cast<int64_t>(j) * n_pad + obj0));

  for (int q0 = 0; q0 < q_n; q0 += QG) {
    const int qg = min(QG, q_n - q0);
    __syncthreads();  // the previous group is done reading bnd
    for (int i = tid; i < m_pad * QG; i += T) {
      const int j = i / QG, q = i % QG;
      const int64_t at = static_cast<int64_t>(j) * q_n + q0 + q;
      bnd[i] = q < qg ? make_float2(lower[at], upper[at]) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    uint32_t f0 = 0, f1 = 0, f2 = 0, f3 = 0;  // bit q: query q0 + q missed
    for (int j = 0; j < m_pad; ++j) {
      const float4 x = tile[j * T + tid];
      const float2* b = bnd + j * QG;
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        const float2 bq = b[q];
        f0 |= missed(x.x, bq) << q;
        f1 |= missed(x.y, bq) << q;
        f2 |= missed(x.z, bq) << q;
        f3 |= missed(x.w, bq) << q;
      }
    }
    for (int q = 0; q < qg; ++q)
      *reinterpret_cast<char4*>(out + static_cast<int64_t>(q0 + q) * n_pad + obj0) =
          hits(f0, f1, f2, f3, q);
  }
}

// The batched partial-match scan. dim_ids (q_n, d_max) int32 lists each
// query's constrained dims (short rows repeat one of their own dims). The
// block first marks the union of the batch's listed rows, loads only those
// rows of its tile (each once), then ANDs each query over its own list.
// Shared memory: the (m_pad, blockDim.x) float4 tile (unlisted rows never
// loaded), a (QG, d_max) float2 bounds table, a (QG, d_max) row table and
// an (m_pad,) row-used flag array.
__global__ void multi_scan_vertical_kernel(const float* __restrict__ data, int64_t n_pad,
                                           int m_pad, const int32_t* __restrict__ dim_ids,
                                           int d_max, const float* __restrict__ lower,
                                           const float* __restrict__ upper, int q_n,
                                           int8_t* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  float4* tile = smem;
  float2* bnd = reinterpret_cast<float2*>(tile + static_cast<size_t>(m_pad) * T);
  int* rows = reinterpret_cast<int*>(bnd + QG * d_max);
  int* used = rows + QG * d_max;
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * T + tid) * VEC;

  // Ids out of range are clamped so a bad id can never read outside the
  // data; the op layer rejects them on the host before they get here.
  auto row_of = [m_pad](int32_t d) { return min(max(d, 0), m_pad - 1); };

  for (int j = tid; j < m_pad; j += T) used[j] = 0;
  __syncthreads();
  for (int i = tid; i < q_n * d_max; i += T) used[row_of(dim_ids[i])] = 1;
  __syncthreads();
  for (int j = 0; j < m_pad; ++j)
    if (used[j])
      tile[j * T + tid] = __ldg(reinterpret_cast<const float4*>(
          data + static_cast<int64_t>(j) * n_pad + obj0));

  for (int q0 = 0; q0 < q_n; q0 += QG) {
    const int qg = min(QG, q_n - q0);
    __syncthreads();  // the previous group is done reading rows/bnd
    for (int i = tid; i < qg * d_max; i += T) {
      const int q = i / d_max;
      const int j = row_of(dim_ids[static_cast<int64_t>(q0 + q) * d_max + i % d_max]);
      const int64_t at = static_cast<int64_t>(j) * q_n + q0 + q;
      rows[i] = j;
      bnd[i] = make_float2(lower[at], upper[at]);
    }
    __syncthreads();
    for (int q = 0; q < qg; ++q) {
      bool h0 = true, h1 = true, h2 = true, h3 = true;
      for (int d = 0; d < d_max; ++d) {
        const float2 b = bnd[q * d_max + d];
        const float4 x = tile[rows[q * d_max + d] * T + tid];
        h0 &= x.x >= b.x && x.x <= b.y;
        h1 &= x.y >= b.x && x.y <= b.y;
        h2 &= x.z >= b.x && x.z <= b.y;
        h3 &= x.w >= b.x && x.w <= b.y;
      }
      *reinterpret_cast<char4*>(out + static_cast<int64_t>(q0 + q) * n_pad + obj0) =
          make_char4(h0, h1, h2, h3);
    }
  }
}

// Halve the block until its shared memory fits the device's opt-in limit.
int fit_threads(int threads, size_t per_thread, size_t fixed, int device) {
  const size_t limit = static_cast<size_t>(mdrq::smem_optin(device));
  while (threads >= 32 && per_thread * threads + fixed > limit) threads /= 2;
  return threads;
}

}  // namespace

extern "C" int mdrq_multi_scan(const float* data, long long n_pad, int m_pad,
                               const float* lower, const float* upper, int q_n,
                               signed char* out, int threads, int device,
                               void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  const size_t per_thread = static_cast<size_t>(m_pad) * sizeof(float4);
  const size_t fixed = static_cast<size_t>(m_pad) * QG * sizeof(float2);
  threads = fit_threads(threads, per_thread, fixed, device);
  if (threads < 32) return cudaErrorInvalidConfiguration;
  const size_t smem = per_thread * threads + fixed;
  MDRQ_TRY(mdrq::allow_smem(multi_scan_kernel, smem));
  const long long blocks = n_pad / (static_cast<long long>(VEC) * threads);
  multi_scan_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, lower, upper, q_n, reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

extern "C" int mdrq_multi_scan_vertical(const float* data, long long n_pad, int m_pad,
                                        const int* dim_ids, int d_max,
                                        const float* lower, const float* upper,
                                        int q_n, signed char* out, int threads,
                                        int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  const size_t per_thread = static_cast<size_t>(m_pad) * sizeof(float4);
  const size_t fixed = static_cast<size_t>(QG) * d_max * (sizeof(float2) + sizeof(int)) +
                       static_cast<size_t>(m_pad) * sizeof(int);
  threads = fit_threads(threads, per_thread, fixed, device);
  if (threads < 32) return cudaErrorInvalidConfiguration;
  const size_t smem = per_thread * threads + fixed;
  MDRQ_TRY(mdrq::allow_smem(multi_scan_vertical_kernel, smem));
  const long long blocks = n_pad / (static_cast<long long>(VEC) * threads);
  multi_scan_vertical_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, dim_ids, d_max, lower, upper, q_n,
      reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
