// Dense decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:73 `_kernel`
// (launched by `_pallas_decode` at :140): one query token per slot over
// a dense [N, T, H, D] cache, attending positions t < lengths[n]; an
// empty slot emits zeros.  The body, its bound and its design are in
// decode_common.cuh, shared with the paged kernel; this file supplies
// the identity-table address function.

#include "decode_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(ptt::DEC_NT)
decode_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ lengths, int H, int T_,
                    float scale) {
  const int n = blockIdx.y, h = blockIdx.x;
  const int len = max(0, min(lengths[n], T_));
  ptt::decode_body<T, D>(q, k, v, o, H, n, h, len, scale,
                         ptt::DenseAddr{T_});
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* lengths, int N, int H, int T_, float scale,
                   cudaStream_t stream) {
  decode_dense_kernel<T, D><<<dim3(H, N), ptt::DEC_NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(lengths), H, T_, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* o, const void* lengths, int N, int H,
                                int T_, int D, float scale, int dtype,
                                void* stream) {
  if (N <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32 && D == 64)
    return launch<float, 64>(q, k, v, o, lengths, N, H, T_, scale, s);
  if (dtype == ptt::kF32 && D == 128)
    return launch<float, 128>(q, k, v, o, lengths, N, H, T_, scale, s);
  if (dtype == ptt::kBF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lengths, N, H, T_, scale, s);
  if (dtype == ptt::kBF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lengths, N, H, T_, scale, s);
  return cudaErrorInvalidValue;
}
