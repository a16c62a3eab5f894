// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/attention.py:196 `_fwd_kernel` (the
// flash forward launched by `_fwd` at :313), on the prefill path of the
// generation engine.  Computes, per (batch, head),
//
//   O = softmax(scale * Q K^T + causal mask) V
//
// with the mask bottom-right aligned (key j is visible to query row i
// iff j <= i + Sk - Sq, as `coff` at attention.py:739), f32 online
// softmax and f32 accumulation, for f32 or bf16 inputs.  A row whose
// every key is masked emits zeros (attention.py:251-252).  No row bias,
// segment ids or LSE in this kernel: the wrapper refuses them.
//
// Layout: Q/K/V/O are read through (batch, seq, head) element strides
// with a unit-stride head dim, so BSHD and BHSD tensors, and the Q/K/V
// column slices of the fused QKV projection, need no transpose or copy.
// Ragged lengths: keys >= Sk are masked and rows >= Sq are not stored,
// so any S works without a padding copy.
//
// What bounds it on this card: at the prefill shapes (S <= 1024, D = 64)
// the work is 4 * S^2 / 2 * D flops per head against 4 * S * D * 4 bytes,
// ~S/8 flop per byte: compute-bound.  This first version does the two
// products with plain f32 FMA from shared memory (the card's 67 TFLOP/s
// f32 rate, not the tensor cores); it skips key tiles wholly above the
// causal diagonal (attention.py:238-239) so causal prefill does half the
// work.  Tensor-core MMA (mma.sync / wgmma), TMA and warp specialisation
// are later work.
//
// Design: one CTA of 256 threads per (batch*head, 64-row query tile).
// The Q tile and each 64-row K/V tile are staged in shared memory as
// f32 (rows padded by one word against bank conflicts).  Thread (ty, tx)
// of a 16 x 16 grid owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4), and output columns tx + 16 c.  The running (m, l) of a row
// live in the registers of the 16 threads that share it; row max and
// row sum reduce across them with warp shuffles.

#include "common.cuh"

namespace {

using ptt::NEG_INF;
using ptt::store;
using ptt::to_f;

constexpr int BM = 64;   // query rows per CTA
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per CTA

template <int D>
constexpr int smem_bytes() {
  return (BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
                 int Sk, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh, float scale,
                 int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = BN + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // [BM][LD]
  float* Ks = Qs + BM * LD;   // [BN][LD]
  float* Vs = Ks + BN * LD;   // [BN][LD]
  float* Ps = Vs + BN * LD;   // [BM][LP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int coff = Sk - Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = m0 + r;
    Qs[r * LD + c] = row < Sq ? to_f(qb[row * q_ss + c]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys past the last visible one of this tile's last row are never
  // read: whole tiles above the causal diagonal are skipped
  int n_end = Sk;
  if (causal) {
    const int last_row = min(m0 + BM, Sq) - 1;
    n_end = min(Sk, last_row + coff + 1);
  }

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int col = n0 + r;
      const bool ok = col < Sk;
      Ks[r * LD + c] = ok ? to_f(kb[col * k_ss + c]) : 0.f;
      Vs[r * LD + c] = ok ? to_f(vb[col * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row + coff);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = Vs[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= Sq) continue;
    const bool dead = m_i[i] <= NEG_INF / 2;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(&ob[row * o_ss + tx + 16 * c], dead ? 0.f : acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Sk, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Sq, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         int dtype, void* stream) {
  if (Sq <= 0 || B * H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32 && D == 64)
    return launch<float, 64>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == ptt::kF32 && D == 128)
    return launch<float, 128>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == ptt::kBF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Sq, Sk, strides, scale,
                                     causal, s);
  if (dtype == ptt::kBF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Sq, Sk, strides,
                                      scale, causal, s);
  return cudaErrorInvalidValue;
}
