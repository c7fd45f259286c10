// Block-visit scan for Hopper (sm_90a): phase 2 of every two-phase index.
//
// Replaces the Pallas TPU kernels multi_scan_visit
// (src/repro/kernels/multi_scan.py) and, as its launch with one bounds
// column and no query ids, range_scan_visit (src/repro/kernels/range_scan.py).
//
// What it computes: for each visit i of a flattened (query, block) list, the
// match mask of the (m_pad, tile_n) block bids[i] (negative ids clamp to block
// 0, as the TPU kernel's index map does; the caller drops those rows) against
// column qids[i] of the query-minor (m_pad, Q) bounds -> out[i, :tile_n] int8.
//
// What bounds it on this card: device-memory bytes. Each visit reads its
// block (m_pad * tile_n * 4 bytes) and writes tile_n mask bytes, with two
// float32 compares per element read: far below the card's compute rates.
//
// Design. The TPU kernel is one grid step per visit with scalar-prefetched
// ids choosing the block. Here one thread block serves one visit: it reads
// its two ids, stages the visiting query's m_pad bound pairs in shared
// memory, and each thread streams VEC consecutive objects of every row with
// float4 loads (a warp reads 512 contiguous bytes of a row), ANDs the
// compares in registers and stores one char4. Ids are clamped into range,
// so a bad id can never read outside the data. Offsets into the (V, tile_n)
// output are 64-bit: V * tile_n passes INT32_MAX at V = 2**21 visits of
// 1024 objects (128 queries over 10 M objects can list 1.25 M visits).
#include "common.cuh"

namespace {

using mdrq::VEC;

// data (m_pad, n_pad) f32; qids (n_visit,) i32 or null (column 0 for all);
// bids (n_visit,) i32; lower/upper (m_pad, q_n) f32; out (n_visit, tile_n) i8.
// Shared memory: the visiting query's (m_pad,) float2 bounds.
__global__ void multi_scan_visit_kernel(const float* __restrict__ data, int64_t n_pad,
                                        int m_pad, const int32_t* __restrict__ qids,
                                        const int32_t* __restrict__ bids,
                                        const float* __restrict__ lower,
                                        const float* __restrict__ upper, int q_n,
                                        int tile_n, int8_t* __restrict__ out) {
  extern __shared__ float2 bnd[];
  const int64_t v = blockIdx.x;
  const int64_t n_blocks = n_pad / tile_n;
  const int64_t bid = bids[v];
  const int64_t b = bid < 0 ? 0 : (bid >= n_blocks ? n_blocks - 1 : bid);
  const int q = qids == nullptr ? 0 : min(max(qids[v], 0), q_n - 1);
  for (int j = threadIdx.x; j < m_pad; j += blockDim.x) {
    const int64_t at = static_cast<int64_t>(j) * q_n + q;
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

}  // namespace

extern "C" int mdrq_multi_scan_visit(const float* data, long long n_pad, int m_pad,
                                     const int* qids, const int* bids,
                                     long long n_visit, const float* lower,
                                     const float* upper, int q_n, int tile_n,
                                     signed char* out, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (n_visit <= 0) return cudaSuccess;
  if (n_visit > 0x7fffffffLL || tile_n % (VEC * 32) || q_n < 1)
    return cudaErrorInvalidValue;
  const int threads = min(256, tile_n / VEC);
  const size_t smem = static_cast<size_t>(m_pad) * sizeof(float2);
  MDRQ_TRY(mdrq::allow_smem(multi_scan_visit_kernel, smem));
  multi_scan_visit_kernel<<<static_cast<unsigned>(n_visit), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, qids, bids, lower, upper, q_n, tile_n,
      reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
