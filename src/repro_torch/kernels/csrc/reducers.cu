// Batched masked reducers over (Q, n_pad) match masks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/reducers.py
// (masked_fill_tiles, masked_agg_tiles).
//
// What bounds them on this card: device-memory bytes. masked_fill reads the
// Q * n_pad mask bytes and the n_pad * 4 value bytes and writes Q * n_pad * 4
// bytes; masked_agg reads the same inputs and writes only Q * n_chunks
// partials. Each does one or two operations per byte, far below the card's
// compute rates.
//
// Design. As in the TPU kernels, the values row is read once per batch: a
// thread block owns VEC * blockDim.x consecutive objects, holds their values
// in registers as one float4 per thread, and loops over every query's mask
// row. masked_agg does not keep the TPU kernel's (Q, tile_n) lane partials:
// each block reduces its objects to one partial per query -- in the thread,
// then a fixed xor-butterfly across the warp, then the warps in index order --
// and writes a (Q, n_chunks) array that the caller reduces with one torch
// call. No float atomics: the order of every addition is fixed by the shapes,
// so repeated runs give bit-identical sums.
#include "common.cuh"

namespace {

using mdrq::VEC;
constexpr int QA = 128;     // queries per shared-memory round in masked_agg
constexpr int MAX_WARPS = 8;  // blockDim.x <= 256

// masks (q_n, n_pad) int8; values (n_pad,) f32; out (q_n, n_pad) f32.
__global__ void masked_fill_kernel(const int8_t* __restrict__ masks,
                                   const float* __restrict__ values, float fill,
                                   int64_t n_pad, int q_n, float* __restrict__ out) {
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  const float4 v = __ldg(reinterpret_cast<const float4*>(values + obj0));
#pragma unroll 4
  for (int q = 0; q < q_n; ++q) {
    const int64_t at = static_cast<int64_t>(q) * n_pad + obj0;
    const char4 mk = *reinterpret_cast<const char4*>(masks + at);
    *reinterpret_cast<float4*>(out + at) =
        make_float4(mk.x ? v.x : fill, mk.y ? v.y : fill, mk.z ? v.z : fill,
                    mk.w ? v.w : fill);
  }
}

template <int OP>  // 0 = sum, 1 = min, 2 = max
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == 0) return a + b;
  if (OP == 1) return fminf(a, b);
  return fmaxf(a, b);
}

// masks (q_n, n_pad) int8; values (n_pad,) f32; partials (q_n, gridDim.x)
// f32, one per (query, block), non-matching objects contributing `ident`.
template <int OP>
__global__ void masked_agg_kernel(const int8_t* __restrict__ masks,
                                  const float* __restrict__ values, float ident,
                                  int64_t n_pad, int q_n, float* __restrict__ partials) {
  __shared__ float red[QA * MAX_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int64_t n_chunks = gridDim.x;
  const int64_t obj0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + tid) * VEC;
  const float4 v = __ldg(reinterpret_cast<const float4*>(values + obj0));

  for (int q0 = 0; q0 < q_n; q0 += QA) {
    const int qg = min(QA, q_n - q0);
    for (int q = 0; q < qg; ++q) {
      const char4 mk = *reinterpret_cast<const char4*>(
          masks + static_cast<int64_t>(q0 + q) * n_pad + obj0);
      float s = combine<OP>(combine<OP>(mk.x ? v.x : ident, mk.y ? v.y : ident),
                            combine<OP>(mk.z ? v.z : ident, mk.w ? v.w : ident));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = combine<OP>(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) red[q * MAX_WARPS + warp] = s;
    }
    __syncthreads();
    for (int q = tid; q < qg; q += blockDim.x) {
      float s = red[q * MAX_WARPS];
      for (int w = 1; w < n_warps; ++w) s = combine<OP>(s, red[q * MAX_WARPS + w]);
      partials[static_cast<int64_t>(q0 + q) * n_chunks + blockIdx.x] = s;
    }
    __syncthreads();  // red is reused by the next round
  }
}

}  // namespace

extern "C" int mdrq_masked_fill(const signed char* masks, const float* values,
                                float fill, long long n_pad, int q_n, float* out,
                                int threads, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  const long long blocks = n_pad / (static_cast<long long>(VEC) * threads);
  masked_fill_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int8_t*>(masks), values, fill, n_pad, q_n, out);
  return cudaGetLastError();
}

extern "C" int mdrq_masked_agg(const signed char* masks, const float* values,
                               int op, float ident, long long n_pad, int q_n,
                               float* partials, int threads, int device,
                               void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (threads > 32 * MAX_WARPS || threads % 32 != 0) return cudaErrorInvalidConfiguration;
  const long long blocks = n_pad / (static_cast<long long>(VEC) * threads);
  const auto* m = reinterpret_cast<const int8_t*>(masks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  switch (op) {
    case 0: masked_agg_kernel<0><<<g, threads, 0, s>>>(m, values, ident, n_pad, q_n, partials); break;
    case 1: masked_agg_kernel<1><<<g, threads, 0, s>>>(m, values, ident, n_pad, q_n, partials); break;
    case 2: masked_agg_kernel<2><<<g, threads, 0, s>>>(m, values, ident, n_pad, q_n, partials); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
