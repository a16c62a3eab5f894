// Tensor-core and asynchronous-copy primitives shared by the bf16 GEMM
// family (gemm_common.cuh) and the bf16 flash kernels (flash_tc.cuh,
// flash_fwd.cu, flash_bwd_fused.cu): shared-memory addresses, cp.async
// 16-byte copies with zero fill, ldmatrix (plain and transposed) and
// mma.sync.m16n8k16 bf16 -> f32.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4,
// q = lane % 4):
//   A 16 x 16: a[0] = A[g][2q, 2q+1],   a[1] = A[g+8][2q, 2q+1],
//              a[2] = A[g][2q+8, +9],   a[3] = A[g+8][2q+8, +9]
//   B 16 x 8:  b0 = B[2q, 2q+1][g],     b1 = B[2q+8, 2q+9][g]
//   C 16 x 8:  c[0, 1] = C[g][2q, 2q+1], c[2, 3] = C[g+8][2q, 2q+1]
// so the C tiles of columns 16k .. 16k+15 are, packed to bf16 pairs,
// the A fragment of contraction step k: a product's output feeds the
// next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace tcore {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tcore
}  // namespace ptt
