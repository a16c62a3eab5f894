// Paged decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:153 `_paged_kernel`
// (launched by `_pallas_paged` at :229): one query token per slot over
// a [NB, bs, H, D] block pool through a [N, max_blocks] int32 block
// table, attending positions t < lengths[n]; an empty slot emits zeros.
// Any block size works (the engine's default is 16); the TPU kernel
// needed bs % 128 == 0.  Each CTA reads its slot's table entries itself
// (the TPU kernel had them scalar-prefetched), and only the first
// ceil(len / bs) of them.  The body, its bound and its design are in
// decode_common.cuh, shared with the dense kernel, which makes the two
// bitwise equal on identical contents.

#include "decode_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(ptt::DEC_NT)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, int H, int bs,
                    int max_blocks, float scale) {
  const int n = blockIdx.y, h = blockIdx.x;
  const int len = max(0, min(lengths[n], max_blocks * bs));
  ptt::decode_body<T, D>(q, k, v, o, H, n, h, len, scale,
                         ptt::PagedAddr{tables, max_blocks, bs});
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* tables, const void* lengths, int N, int H,
                   int bs, int max_blocks, float scale, cudaStream_t stream) {
  decode_paged_kernel<T, D><<<dim3(H, N), ptt::DEC_NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), H,
      bs, max_blocks, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, void* o,
                                      const void* tables, const void* lengths,
                                      int N, int H, int D, int bs,
                                      int max_blocks, float scale, int dtype,
                                      void* stream) {
  if (N <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32 && D == 64)
    return launch<float, 64>(q, k_pool, v_pool, o, tables, lengths, N, H, bs,
                             max_blocks, scale, s);
  if (dtype == ptt::kF32 && D == 128)
    return launch<float, 128>(q, k_pool, v_pool, o, tables, lengths, N, H, bs,
                              max_blocks, scale, s);
  if (dtype == ptt::kBF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, o, tables, lengths, N,
                                     H, bs, max_blocks, scale, s);
  if (dtype == ptt::kBF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, o, tables, lengths,
                                      N, H, bs, max_blocks, scale, s);
  return cudaErrorInvalidValue;
}
