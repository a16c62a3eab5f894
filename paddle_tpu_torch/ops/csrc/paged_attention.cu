// Paged decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:153 `_paged_kernel`
// (launched by `_pallas_paged` at :229): one query token per slot over
// a [NB, bs, H, D] block pool through a [N, max_blocks] int32 block
// table, attending positions t < lengths[n]; an empty slot emits zeros.
// Any block size works (the engine's default is 16); the TPU kernel
// needed bs % 128 == 0.  Each CTA reads its chunk's table entries itself
// (the TPU kernel had them scalar-prefetched), and only those of rows
// below the length; a chunk is whole blocks, so an entry is resolved
// once a chunk.  The body, its bound and its design are in
// decode_common.cuh, shared with the dense kernel, which makes the two
// bitwise equal on identical contents under the same chunk plan.

#include "decode_common.cuh"

namespace {

constexpr int MAX_NT = 512;  // 16 heads a CTA

template <typename T, int D>
__global__ void __launch_bounds__(MAX_NT)
    decode_paged_kernel(const ptt::DecArgs p, const int* __restrict__ tables,
                        int max_blocks, int bs) {
  ptt::decode_split<T, D>(p, ptt::PagedAddr{tables, max_blocks, bs});
}

}  // namespace

// As decode_attention (decode_attention.cu) through the block table;
// `chunk` is a multiple of bs.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const void* tables, const void* lengths, void* acc, void* ml,
    void* counters, int N, int H, int D, int bs, int max_blocks, int chunk,
    int chunks, int hg, float scale, int dtype, void* stream) {
  if (N <= 0 || H <= 0) return cudaSuccess;
  if (hg <= 0 || hg * 32 > MAX_NT || bs <= 0 || chunk <= 0 || chunk % bs ||
      chunks <= 0)
    return cudaErrorInvalidValue;
  ptt::DecArgs p{q, k_pool, v_pool, o, static_cast<const int*>(lengths),
                 static_cast<float*>(acc), static_cast<float*>(ml),
                 static_cast<int*>(counters), H, hg, chunk, chunks,
                 max_blocks * bs, scale};
  const int* tb = static_cast<const int*>(tables);
  const dim3 grid(chunks, N, (H + hg - 1) / hg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32 && D == 64)
    decode_paged_kernel<float, 64><<<grid, hg * 32, 0, s>>>(p, tb,
                                                             max_blocks, bs);
  else if (dtype == ptt::kF32 && D == 128)
    decode_paged_kernel<float, 128><<<grid, hg * 32, 0, s>>>(p, tb,
                                                              max_blocks, bs);
  else if (dtype == ptt::kBF16 && D == 64)
    decode_paged_kernel<__nv_bfloat16, 64><<<grid, hg * 32, 0, s>>>(
        p, tb, max_blocks, bs);
  else if (dtype == ptt::kBF16 && D == 128)
    decode_paged_kernel<__nv_bfloat16, 128><<<grid, hg * 32, 0, s>>>(
        p, tb, max_blocks, bs);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
