// Dense decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:73 `_kernel`
// (launched by `_pallas_decode` at :140): one query token per slot over
// a dense [N, T, H, D] cache, attending positions t < lengths[n]; an
// empty slot emits zeros.  The body, its bound and its design (a split
// of the key range, merged in chunk order by the last CTA of a slot's
// head group) are in decode_common.cuh, shared with the paged kernel;
// this file supplies the identity-table address function.

#include "decode_common.cuh"

namespace {

constexpr int MAX_NT = 512;  // 16 heads a CTA

template <typename T, int D>
__global__ void __launch_bounds__(MAX_NT)
    decode_dense_kernel(const ptt::DecArgs p, int T_) {
  ptt::decode_split<T, D>(p, ptt::DenseAddr{T_});
}

}  // namespace

// out from q, the caches k and v and lengths, in chunks of `chunk`
// positions (`chunks` a slot) and `hg` heads a CTA; `acc` and `ml` are
// the f32 partials' workspace, `counters` N * ceil(H / hg) ints that are
// zero between launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* o, const void* lengths, void* acc,
                                void* ml, void* counters, int N, int H,
                                int T_, int D, int chunk, int chunks, int hg,
                                float scale, int dtype, void* stream) {
  if (N <= 0 || H <= 0) return cudaSuccess;
  if (hg <= 0 || hg * 32 > MAX_NT || chunk <= 0 || chunks <= 0)
    return cudaErrorInvalidValue;
  ptt::DecArgs p{q, k, v, o, static_cast<const int*>(lengths),
                 static_cast<float*>(acc), static_cast<float*>(ml),
                 static_cast<int*>(counters), H, hg, chunk, chunks, T_,
                 scale};
  const dim3 grid(chunks, N, (H + hg - 1) / hg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32 && D == 64)
    decode_dense_kernel<float, 64><<<grid, hg * 32, 0, s>>>(p, T_);
  else if (dtype == ptt::kF32 && D == 128)
    decode_dense_kernel<float, 128><<<grid, hg * 32, 0, s>>>(p, T_);
  else if (dtype == ptt::kBF16 && D == 64)
    decode_dense_kernel<__nv_bfloat16, 64><<<grid, hg * 32, 0, s>>>(p, T_);
  else if (dtype == ptt::kBF16 && D == 128)
    decode_dense_kernel<__nv_bfloat16, 128><<<grid, hg * 32, 0, s>>>(p, T_);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
