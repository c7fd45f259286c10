// VA-file approximation filter on packed 2-bit cell codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels multi_va_filter_packed and, as its Q=1
// launch, va_filter_packed (src/repro/kernels/va_filter.py).
//
// What it computes: word wi of object i holds dims [16 wi, 16 wi + 16) in
// 2-bit fields (dim 16 wi + k in bits [2k, 2k + 2)); object i is a candidate
// for query q when every dim d < m has its field in [cell_lo[d, q],
// cell_hi[d, q]] -> out[q, i] int8. Fields of dims from m on do not matter.
//
// What bounds it on this card: device-memory bytes. It reads w * n_pad * 4
// bytes of words once per batch and writes Q * n_pad mask bytes (1.36 GB at
// Q = 128, n = 10 M, m = 19); the logic is four 32-bit operations per
// (query, object, word), 1.0e10 at that shape.
//
// Design. A per-dim loop costs ~5 integer instructions per (query, object,
// dim), which is the card's integer issue limit at Q = 128. Here all 16
// fields of a word are tested at once. For each (query, word) the kernel
// builds four masks M_c: bit 2k of M_c is set when cell c lies in
// [cell_lo, cell_hi] of dim 16 wi + k (all four bits for dims from m on; odd
// bits 0) — one warp per (query, word), even lane 2k deciding dim k, one
// ballot per cell (tests/test_torch_visit_design.py models the rule). With
// l = x and h = x >> 1 (bit 2k of each: the field's low and high bit), the
// field's verdict is the 4-way select
//   r = h ? (l ? M3 : M2) : (l ? M1 : M0)
//     = (e0 & M0) | (e1 & M1) | (e2 & M2) | (e3 & M3),  e_c = [field == c],
// three LOP3s; the object is a candidate iff r == 0x55555555 in every word
// (one AND per word into a running word). The packed words are read once
// per batch: a thread block owns VEC * blockDim.x consecutive objects and
// copies their w words into shared memory as one int4 per (word, thread).
// Queries run in groups of QG (their masks in shared memory, read as
// broadcasts) and, inside a group, QSUB at a time with their running words
// in registers, so each word is loaded and shifted once per QSUB queries.
// Masks are written as one char4 per (query, thread); offsets into the
// (Q, n_pad) output are 64-bit.
#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int QG = 64;             // queries per shared-memory round of masks
constexpr int QSUB = 8;            // queries whose running words stay in registers
constexpr int BITS_PER_DIM = 2;    // kernels/va_filter.py BITS_PER_DIM
constexpr int DIMS_PER_WORD = 32 / BITS_PER_DIM;
constexpr int CELLS = 1 << BITS_PER_DIM;
constexpr uint32_t LOW_BITS = 0x55555555u;   // bit 0 of every field
constexpr unsigned FULL = 0xffffffffu;
static_assert(BITS_PER_DIM == 2, "the select below tests 2-bit fields");

// Bit 2k set iff field k of x is a cell whose bit is set in the masks.
__device__ __forceinline__ uint32_t fields_ok(uint32_t x, uint4 mk) {
  const uint32_t h = x >> 1;
  const uint32_t low_pair = (x & mk.y) | (~x & mk.x);    // cell 1 : cell 0
  const uint32_t high_pair = (x & mk.w) | (~x & mk.z);   // cell 3 : cell 2
  return (h & high_pair) | (~h & low_pair);
}

// packed (w, n_pad) i32; cell_lo/cell_hi (m_s, q_n) i32, query-minor;
// out (q_n, n_pad) i8. Shared memory: the block's (w, blockDim.x) int4 word
// tile, then the group's (QG, w) uint4 masks (M0, M1, M2, M3).
__global__ void multi_va_filter_kernel(const int32_t* __restrict__ packed,
                                       int64_t n_pad, int w, int m,
                                       const int32_t* __restrict__ cell_lo,
                                       const int32_t* __restrict__ cell_hi, int q_n,
                                       int8_t* __restrict__ out) {
  extern __shared__ int4 smem_va[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int4* tile = smem_va;
  uint4* masks = reinterpret_cast<uint4*>(tile + static_cast<size_t>(w) * T);
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * T + tid) * VEC;

  // Each thread reads back only its own tile column; the first group's
  // barrier below orders the tile anyway.
  for (int wi = 0; wi < w; ++wi)
    tile[wi * T + tid] = __ldg(reinterpret_cast<const int4*>(
        packed + static_cast<int64_t>(wi) * n_pad + obj0));

  for (int q0 = 0; q0 < q_n; q0 += QG) {
    const int qg = min(QG, q_n - q0);
    __syncthreads();  // the previous group is done reading `masks`
    for (int item = tid >> 5; item < qg * w; item += T >> 5) {
      const int q = item / w, wi = item - q * w;
      const int d = wi * DIMS_PER_WORD + (lane >> 1);
      const bool even = (lane & 1) == 0;
      int lo = 0, hi = CELLS - 1;   // dims from m on: every cell
      if (even && d < m) {
        const int64_t at = static_cast<int64_t>(d) * q_n + q0 + q;
        lo = cell_lo[at];
        hi = cell_hi[at];
      }
      uint4 mk;
      mk.x = __ballot_sync(FULL, even && 0 >= lo && 0 <= hi);
      mk.y = __ballot_sync(FULL, even && 1 >= lo && 1 <= hi);
      mk.z = __ballot_sync(FULL, even && 2 >= lo && 2 <= hi);
      mk.w = __ballot_sync(FULL, even && 3 >= lo && 3 <= hi);
      if (lane == 0) masks[item] = mk;
    }
    __syncthreads();
    for (int s0 = 0; s0 < qg; s0 += QSUB) {
      const int ns = min(QSUB, qg - s0);
      uint32_t acc[QSUB][VEC];
#pragma unroll
      for (int s = 0; s < QSUB; ++s)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[s][j] = LOW_BITS;
      for (int wi = 0; wi < w; ++wi) {
        const int4 x = tile[wi * T + tid];
#pragma unroll
        for (int s = 0; s < QSUB; ++s) {
          if (s < ns) {
            const uint4 mk = masks[(s0 + s) * w + wi];
            acc[s][0] &= fields_ok(static_cast<uint32_t>(x.x), mk);
            acc[s][1] &= fields_ok(static_cast<uint32_t>(x.y), mk);
            acc[s][2] &= fields_ok(static_cast<uint32_t>(x.z), mk);
            acc[s][3] &= fields_ok(static_cast<uint32_t>(x.w), mk);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < QSUB; ++s) {
        if (s < ns)
          *reinterpret_cast<char4*>(out + static_cast<int64_t>(q0 + s0 + s) * n_pad +
                                    obj0) =
              make_char4(acc[s][0] == LOW_BITS, acc[s][1] == LOW_BITS,
                         acc[s][2] == LOW_BITS, acc[s][3] == LOW_BITS);
      }
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
  const size_t fixed = static_cast<size_t>(QG) * w * sizeof(uint4);
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
