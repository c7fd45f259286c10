// Shared launch plumbing for the MDRQ kernels (plain C interface, loaded
// with ctypes). Every launcher selects the device, launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mdrq {

// Objects per thread: each thread owns one float4 (one char4 of mask bytes)
// per row, so a warp touches 512 contiguous bytes of a float32 row.
constexpr int VEC = 4;

// Grow a kernel's dynamic shared memory past the 48 KB default when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int smem_optin(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

}  // namespace mdrq

#define MDRQ_TRY(expr)                      \
  do {                                      \
    cudaError_t err_ = (expr);              \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

#define MDRQ_ERROR_STRING_FN                                  \
  extern "C" const char* mdrq_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
