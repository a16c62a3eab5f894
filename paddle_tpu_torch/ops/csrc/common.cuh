// Shared helpers of the port's CUDA kernels: element conversions, the
// masked-score sentinel, and the error-string export every library
// carries (the Python wrapper reads it when a launch returns non-zero).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// Masked scores take this value, as in the Pallas kernels (NEG_INF =
// -1e30): a score at or below NEG_INF / 2 contributes exactly zero, and
// a row whose running max never left it is dead and emits zeros.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// dtype codes shared with ops/_build.py
enum DType { kF32 = 0, kBF16 = 1 };

}  // namespace ptt

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
