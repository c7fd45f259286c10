// VA-file approximation filter on packed 2-bit cell codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels multi_va_filter_packed and, as its Q=1
// launch, va_filter_packed (src/repro/kernels/va_filter.py).
//
// What it computes: word wi of object i holds dims [16 wi, 16 wi + 16) in
// 2-bit fields (dim 16 wi + k in bits [2k, 2k + 2)); object i is a candidate
// for query q when every dim d < m has its field in [cell_lo[d, q],
// cell_hi[d, q]] -> out[q, i] int8. Dims from m on are never read (the
// packed words' unused high fields are 0).
//
// What bounds it on this card: operations at large batch. It reads
// w * n_pad * 4 bytes of words once per batch and writes Q * n_pad mask
// bytes, and does about four integer operations per (query, object, dim):
// at Q = 128 and m = 19 that is ~9.7e10 operations against ~1.36 GB moved.
//
// Design. As in the TPU kernel the packed words are read once per batch: a
// thread block owns VEC * blockDim.x consecutive objects, copies their w
// words into shared memory as one int4 per (word, thread), then loops over
// the batch's queries in groups of 32. For each group it folds every
// (query, dim) bound pair into a 4-bit allowed-cell mask in shared memory,
// so the inner loop is: extract a field (shift, and), shift the allowed mask
// by it, and AND bit 0 into the object's running result. Masks are written
// as one char4 per (query, thread). Offsets into the (Q, n_pad) output are
// 64-bit.
#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int QG = 32;             // queries per shared-memory round
constexpr int BITS_PER_DIM = 2;    // kernels/va_filter.py BITS_PER_DIM
constexpr int CODE_MASK = (1 << BITS_PER_DIM) - 1;
constexpr int DIMS_PER_WORD = 32 / BITS_PER_DIM;
constexpr int CELLS = 1 << BITS_PER_DIM;

// packed (w, n_pad) i32; cell_lo/cell_hi (m_s, q_n) i32, query-minor;
// out (q_n, n_pad) i8. Shared memory: the block's (w, blockDim.x) int4
// word tile, then a (QG, m) byte table of allowed-cell masks.
__global__ void multi_va_filter_kernel(const int32_t* __restrict__ packed,
                                       int64_t n_pad, int w, int m,
                                       const int32_t* __restrict__ cell_lo,
                                       const int32_t* __restrict__ cell_hi, int q_n,
                                       int8_t* __restrict__ out) {
  extern __shared__ int4 smem_va[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  int4* tile = smem_va;
  uint8_t* allowed = reinterpret_cast<uint8_t*>(tile + static_cast<size_t>(w) * T);
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * T + tid) * VEC;

  // Each thread reads back only its own tile column; the first group's
  // barrier below orders the tile anyway.
  for (int wi = 0; wi < w; ++wi)
    tile[wi * T + tid] = __ldg(reinterpret_cast<const int4*>(
        packed + static_cast<int64_t>(wi) * n_pad + obj0));

  for (int q0 = 0; q0 < q_n; q0 += QG) {
    const int qg = min(QG, q_n - q0);
    __syncthreads();  // the previous group is done reading `allowed`
    for (int i = tid; i < qg * m; i += T) {
      const int q = i / m, d = i % m;
      const int64_t at = static_cast<int64_t>(d) * q_n + q0 + q;
      const int lo = cell_lo[at], hi = cell_hi[at];
      uint32_t bits = 0;
#pragma unroll
      for (int c = 0; c < CELLS; ++c) bits |= static_cast<uint32_t>(c >= lo && c <= hi) << c;
      allowed[i] = static_cast<uint8_t>(bits);
    }
    __syncthreads();
    for (int q = 0; q < qg; ++q) {
      const uint8_t* a = allowed + q * m;
      uint32_t h0 = 1, h1 = 1, h2 = 1, h3 = 1;
      for (int wi = 0; wi < w; ++wi) {
        const int4 x = tile[wi * T + tid];
        const int k_end = min(DIMS_PER_WORD, m - wi * DIMS_PER_WORD);
        const uint8_t* aw = a + wi * DIMS_PER_WORD;
        for (int k = 0; k < k_end; ++k) {
          const uint32_t al = aw[k];
          const int s = BITS_PER_DIM * k;
          h0 &= al >> ((x.x >> s) & CODE_MASK);
          h1 &= al >> ((x.y >> s) & CODE_MASK);
          h2 &= al >> ((x.z >> s) & CODE_MASK);
          h3 &= al >> ((x.w >> s) & CODE_MASK);
        }
      }
      *reinterpret_cast<char4*>(out + static_cast<int64_t>(q0 + q) * n_pad + obj0) =
          make_char4(static_cast<signed char>(h0 & 1u), static_cast<signed char>(h1 & 1u),
                     static_cast<signed char>(h2 & 1u), static_cast<signed char>(h3 & 1u));
    }
  }
}

}  // namespace

extern "C" int mdrq_multi_va_filter(const int* packed, long long n_pad, int w, int m,
                                    const int* cell_lo, const int* cell_hi, int q_n,
                                    signed char* out, int threads, int device,
                                    void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (m < 1 || m > w * DIMS_PER_WORD || q_n < 1) return cudaErrorInvalidValue;
  const size_t fixed = static_cast<size_t>(QG) * m;
  const size_t limit = static_cast<size_t>(mdrq::smem_optin(device));
  while (threads >= 32 && static_cast<size_t>(w) * sizeof(int4) * threads + fixed > limit)
    threads /= 2;
  if (threads < 32) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(w) * sizeof(int4) * threads + fixed;
  MDRQ_TRY(mdrq::allow_smem(multi_va_filter_kernel, smem));
  const long long blocks = n_pad / (static_cast<long long>(VEC) * threads);
  multi_va_filter_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(packed), n_pad, w, m,
      reinterpret_cast<const int32_t*>(cell_lo), reinterpret_cast<const int32_t*>(cell_hi),
      q_n, reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
