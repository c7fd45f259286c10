// Row-major range scan for Hopper (sm_90a): the paper's horizontal layout.
//
// Replaces the Pallas TPU kernel range_scan_rows
// (src/repro/kernels/range_scan.py), the row-scan path of one query.
//
// What it computes: for each row i of the row-major (n_pad, m_pad) data,
// out[i] = all_j(lower[j] <= x[i, j] <= upper[j]) as int8. Padding rows are
// +inf (never match a finite upper bound); padding dims are 0.0 under
// match-all bounds.
//
// What bounds it on this card: device-memory bytes. It reads n_pad * m_pad
// float32 once and writes n_pad bytes, with two compares per element read
// (0.96 GB and ~0.5 G compares at 10 M x 24: ~0.29 ms at 3.35 TB/s against
// ~0.007 ms of float32 compares).
//
// Design. The TPU kernel puts the dims on the lanes and reduces across them.
// Here each thread owns one row: it reads the row as m_pad / 4 float4 loads
// (m_pad is a multiple of 8, so a row is whole float4s and 16-byte aligned)
// against the bounds, staged once per block in shared memory as float4s
// (every thread reads the same bound: a broadcast, no bank conflicts), ANDs
// the compares in a register and writes one byte. A warp covers 32
// contiguous rows — 3 KB at m_pad = 24 — so every sector it fetches is used,
// by one load or the next; the row is never staged in shared memory (a
// stride of m_pad words there would conflict). Offsets are 64-bit:
// n_pad * m_pad passes INT32_MAX for a larger table than GMRQB's.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// data (n_pad, m_pad) f32; lower/upper (m_pad,) f32; out (n_pad,) i8.
// Shared memory: the (m_pad / 4,) float4 lower bounds, then the upper.
__global__ void range_scan_rows_kernel(const float* __restrict__ data, int64_t n_pad,
                                       int m_pad, const float* __restrict__ lower,
                                       const float* __restrict__ upper,
                                       int8_t* __restrict__ out) {
  extern __shared__ float4 bnd[];
  const int w = m_pad / 4;  // float4 words per row
  float* flat = reinterpret_cast<float*>(bnd);
  for (int j = threadIdx.x; j < m_pad; j += blockDim.x) {
    flat[j] = lower[j];
    flat[m_pad + j] = upper[j];
  }
  __syncthreads();
  const float4* lo = bnd;
  const float4* up = bnd + w;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_pad) return;
  const float4* x = reinterpret_cast<const float4*>(data + row * m_pad);
  bool hit = true;
  for (int j = 0; j < w; ++j) {
    const float4 v = __ldg(x + j);
    const float4 l = lo[j];
    const float4 u = up[j];
    hit &= v.x >= l.x && v.x <= u.x && v.y >= l.y && v.y <= u.y &&
           v.z >= l.z && v.z <= u.z && v.w >= l.w && v.w <= u.w;
  }
  out[row] = hit;
}

}  // namespace

extern "C" int mdrq_range_scan_rows(const float* data, long long n_pad, int m_pad,
                                    const float* lower, const float* upper,
                                    signed char* out, int device, void* stream) {
  MDRQ_TRY(cudaSetDevice(device));
  if (m_pad % 4 != 0 || m_pad < 4) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(m_pad) * sizeof(float);
  MDRQ_TRY(mdrq::allow_smem(range_scan_rows_kernel, smem));
  const long long blocks = (n_pad + THREADS - 1) / THREADS;
  range_scan_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      data, n_pad, m_pad, lower, upper, reinterpret_cast<int8_t*>(out));
  return cudaGetLastError();
}

MDRQ_ERROR_STRING_FN
