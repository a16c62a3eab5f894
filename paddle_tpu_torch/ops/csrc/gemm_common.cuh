// The f32 forward GEMM of the fused-epilogue matmul (matmul_bias_act.cu)
// and of the 1x1-conv + BN kernels (conv_bn_relu.cu, conv_bn_stats.cu),
// and the epilogue pieces every GEMM of the port shares: one templated
// tile GEMM in exact f32 FMA (`simt::gemm_f32`, no TF32)
//
//   C[r][c] = sum_k A(r, k) B(c, k),   y [M, N] = x w^T
//
// over the port's weight layout w [N, K] (nn.Linear's): A = x [M][K] and
// B = w [N][K], both K-major (the contraction index contiguous).  What
// it replaces, in f32: paddle_tpu/ops/pallas/matmul.py:200 `_fwd_kernel`
// (kernel 5) with the bias + activation epilogue (the bias added to the
// f32 accumulator, the activation applied before the one writeback,
// optionally z written too); benchmarks/fused_conv_bn_relu_experiment.py:32
// `fused_kernel` (kernel 10) with the kBnRelu epilogue, max(acc *
// scale[c] + shift[c], 0) (the folded eval-mode BatchNorm and relu); and
// :141 `fused_stats_kernel` (kernel 11) with the kStats epilogue, which
// stores the accumulator as it is and writes the tile's per-column
// (mean, M2) of its valid rows, the tile's mean first and then the
// squares about it (two passes over the registers, so no sum of squares
// cancels), to partials that a second launch merges (conv_bn_stats.cu).
// Tiles: 64 x 64 x 16 in shared memory, 4 x 4 outputs a thread, 256
// threads; any shape (edges masked).  The card's FMA rate (67 TFLOP/s)
// bounds it at most of the path's shapes.
//
// Every bf16 GEMM of the port is gemm_tc.cuh's (wgmma + TMA): the
// forward body of kernels 5, 10 and 11 and the backward of kernels 6
// and 7.  The f32 backward (kernels 6 and 7) is gemm_tf32x3.cuh's (wgmma
// on a 3xTF32 split).  They share the activation codes, `act_fwd`,
// `act_bwd` and the vector loads and stores below.
#pragma once

#include "common.cuh"

namespace ptt {
namespace gemm {

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };
// activation codes shared with ops/matmul.py (`_ACT_CODES`); kBnRelu is
// the forward's BN-affine + relu epilogue, launched by conv_bn_relu.cu;
// kStats the forward's BN-statistics epilogue, launched by conv_bn_stats.cu
enum Act { kNone = 0, kRelu = 1, kTanh = 2, kGelu = 3, kGeluTanh = 4,
           kBnRelu = 5, kStats = 6 };

struct Args {
  const void* a;      // A: x
  const void* b;      // B: w
  void* c;            // y
  void* z;            // the pre-activation output, or null
  const void* bias;   // [N] or null
  const float* scale; // kBnRelu: [N] f32
  const float* shift; // kBnRelu: [N] f32
  float* stats;       // kStats: [2][row tiles][N] f32 partials, the tiles'
                      // means, then their M2s
  int rows, cols, depth;   // output rows / cols, contraction length
  long long lda, ldb, ldc;
  int bias_dtype;     // DType of bias
};

constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kGeluC = 0.044715f;

// `_apply_act` (matmul.py:154) on an f32 value
template <int ACT>
__device__ __forceinline__ float act_fwd(float z) {
  if (ACT == kRelu) return fmaxf(z, 0.f);
  if (ACT == kTanh) return tanhf(z);
  if (ACT == kGelu) return 0.5f * z * (1.f + erff(z * kSqrtHalf));
  if (ACT == kGeluTanh)
    return 0.5f * z * (1.f + tanhf(kSqrt2OverPi * (z + kGeluC * z * z * z)));
  return z;
}

// `_dact_from_residual` (matmul.py:167): dZ from dY and the residual
template <int ACT>
__device__ __forceinline__ float act_bwd(float g, float r) {
  if (ACT == kRelu) return g * (r > 0.f ? 1.f : 0.f);
  if (ACT == kTanh) return g * (1.f - r * r);
  if (ACT == kGelu) {
    const float cdf = 0.5f * (1.f + erff(r * kSqrtHalf));
    const float pdf = kInvSqrt2Pi * expf(-0.5f * r * r);
    return g * (cdf + r * pdf);
  }
  if (ACT == kGeluTanh) {
    const float t = tanhf(kSqrt2OverPi * (r + kGeluC * r * r * r));
    const float dinner = kSqrt2OverPi * (1.f + 3.f * kGeluC * r * r);
    return g * (0.5f * (1.f + t) + 0.5f * r * (1.f - t * t) * dinner);
  }
  return g;
}

__device__ __forceinline__ float load_vec(const void* p, int dtype, int i) {
  return dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                        : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_vec(void* p, int dtype, int i, float v) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

// The BN-affine + relu epilogue of one f32 accumulator in column c
__device__ __forceinline__ float bn_relu(const Args& p, int c, float v) {
  return fmaxf(v * p.scale[c] + p.shift[c], 0.f);
}

// The forward's epilogue for two neighbouring outputs (r, c), (r, c + 1):
// bias, z and activation (or the BN affine + relu).
template <typename T, int ACT>
__device__ __forceinline__ void epilogue2(const Args& p, int r, int c,
                                          float v0, float v1) {
  const long long o = static_cast<long long>(r) * p.ldc + c;
  if (ACT == kBnRelu) {
    v0 = bn_relu(p, c, v0);
    v1 = bn_relu(p, c + 1, v1);
  } else {
    if (p.bias) {
      v0 += load_vec(p.bias, p.bias_dtype, c);
      v1 += load_vec(p.bias, p.bias_dtype, c + 1);
    }
    if (p.z) store2(static_cast<T*>(p.z) + o, v0, v1);
    v0 = act_fwd<ACT>(v0);
    v1 = act_fwd<ACT>(v1);
  }
  store2(static_cast<T*>(p.c) + o, v0, v1);
}

// ---------------------------------------------------------------------------
// f32: exact FMA
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64, BK = 16, NT = 256, LD = BM + 4;

// kStats: partial (mean, M2) of each column over the CTA's valid rows,
// written at row tile blockIdx.y.  Column c's 64 rows lie in the 16
// threads of one tx (4 rows each), whose sums meet in shared memory and
// are added in a fixed order: deterministic.  `red` and `mean` reuse the
// operand tiles, which the mainloop's last barrier has freed.
__device__ __forceinline__ void tile_stats(const Args& p,
                                           const float (&acc)[4][4],
                                           float (*red)[LD], float* mean,
                                           int row0, int col0) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nrows = min(BM, p.rows - row0);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const float m = pass ? mean[c] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ty * 4 + i < nrows) {
          const float d = acc[i][j] - m;
          s += pass ? d * d : d;
        }
      red[ty][c] = s;
    }
    __syncthreads();
    if (tid < BM) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < NT / 16; ++i) t += red[i][tid];
      if (pass == 0) {
        mean[tid] = t / nrows;
      } else if (col0 + tid < p.cols) {
        const long long o = static_cast<long long>(blockIdx.y) * p.cols + col0 + tid;
        p.stats[o] = mean[tid];
        p.stats[static_cast<long long>(gridDim.y) * p.cols + o] = t;
      }
    }
    __syncthreads();
  }
}

template <int ACT>
__device__ __forceinline__ void gemm_f32(const Args& p) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  const auto* A = static_cast<const float*>(p.a);
  const auto* B = static_cast<const float*>(p.b);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.depth; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int id = tid + i * NT;
      const int r = id >> 4, k = id & 15;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = gr < p.rows && gk < p.depth ? A[gr * p.lda + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int id = tid + i * NT;
      const int c = id >> 4, k = id & 15;
      const int gc = col0 + c, gk = k0 + k;
      Bs[k][c] = gc < p.cols && gk < p.depth ? B[gc * p.ldb + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int c = col0 + tx * 4 + j;
      if (r >= p.rows) continue;
      if (c + 1 < p.cols) {
        epilogue2<float, ACT>(p, r, c, acc[i][j], acc[i][j + 1]);
      } else if (c < p.cols) {  // an odd last column
        float v = acc[i][j];
        if (ACT == kBnRelu) {
          v = bn_relu(p, c, v);
        } else {
          if (p.bias) v += load_vec(p.bias, p.bias_dtype, c);
          if (p.z) static_cast<float*>(p.z)[static_cast<long long>(r) * p.ldc + c] = v;
          v = act_fwd<ACT>(v);
        }
        static_cast<float*>(p.c)[static_cast<long long>(r) * p.ldc + c] = v;
      }
    }
  }
  if constexpr (ACT == kStats)
    tile_stats(p, acc, As, &Bs[0][0], row0, col0);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One kernel name per epilogue family, so a profile bills each on its
// own (chip_smoke.py's KERNEL_CATEGORIES).
#define PTT_GEMM_F32(NAME)                                              \
  template <int ACT>                                                    \
  __global__ void __launch_bounds__(simt::NT) NAME##_f32(const Args p) { \
    simt::gemm_f32<ACT>(p);                                             \
  }
PTT_GEMM_F32(matmul_fwd)
PTT_GEMM_F32(conv_bn_relu)
PTT_GEMM_F32(conv_bn_stats)
#undef PTT_GEMM_F32

// the kernels of one epilogue family only, so each library instantiates
// its own
template <int ACT>
auto f32_kernel() {
  if constexpr (ACT == kBnRelu) return conv_bn_relu_f32<ACT>;
  else if constexpr (ACT == kStats) return conv_bn_stats_f32<ACT>;
  else return matmul_fwd_f32<ACT>;
}

// The f32 forward GEMM with epilogue ACT, one CTA a 64 x 64 tile.
template <int ACT>
cudaError_t launch_act(const Args& p, cudaStream_t stream) {
  dim3 grid((p.cols + simt::BM - 1) / simt::BM,
            (p.rows + simt::BM - 1) / simt::BM);
  f32_kernel<ACT>()<<<grid, simt::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace ptt
