// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/attention.py:196 `_fwd_kernel` (the
// flash forward launched by `_fwd` at :313), on the engine's prefill
// path and on every attention forward of BERT training.  Computes, per
// (batch, head),
//
//   O = softmax(scale * Q K^T + bias + masks) V,   LSE = logsumexp(row)
//
// with f32 online softmax and f32 accumulation, for f32 or bf16 inputs.
// Masks, as `_apply_masks` (attention.py:114): an additive row bias
// [B, 1 or H, 1, Sk] (read through its batch / head strides, so a
// broadcast bias is never expanded), segment ids (query row i sees key
// j only when q_seg[b, i] == kv_seg[b, j], built from the two O(S) id
// vectors, never an [S, S] mask) and causal, bottom-right aligned (key j
// is visible to row i iff j <= i + Sk - Sq, as `coff` at :739).  A row
// whose every key is masked emits zeros and LSE = NEG_INF
// (attention.py:251-256).  The LSE [B*H, Sq] f32 is the backward's
// residual; the inference call passes no LSE pointer and skips it.
//
// Layout: Q/K/V/O are read through (batch, seq, head) element strides
// with a unit-stride head dim, so BSHD and BHSD tensors, and the Q/K/V
// column slices of the fused QKV projection, need no transpose or copy.
// Ragged lengths: keys >= Sk are masked and rows >= Sq are not stored,
// so any S works without a padding copy.
//
// What bounds it on this card: at S = 512..1024, D = 64 the work is
// 4 S^2 D flops per head (halved under causal masking) against 4 S D
// elements of traffic, ~S/8 flop per byte: compute-bound.  This version
// does the two products with plain f32 FMA from shared memory (the
// card's 67 TFLOP/s f32 rate, not the tensor cores); it skips key tiles
// wholly above the causal diagonal (attention.py:238-239).  Tensor-core
// MMA (mma.sync / wgmma), TMA and warp specialisation are later work.
//
// Design: one CTA of 256 threads per (batch*head, 64-row query tile);
// the tile scheme of flash_common.cuh.  The running (m, l) of a row live
// in the registers of the 16 threads that share it; row max and row sum
// reduce across them with warp shuffles.  A call without bias or
// segment ids (prefill, the BERT step) runs the MASKED = false
// instantiation, which compiles the mask operands out.  Shared memory, D = 64:
// Q, K, V and P tiles, 66,560 bytes, plus 768 bytes of mask operands.

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;
using ptt::NEG_INF;

template <int D>
constexpr int smem_bytes() {
  return (BM * (D + 1) + 2 * BN * (D + 1) + BM * LP + 2 * BN) * 4 + BM * 4;
}

template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BM][LD]
  float* Ks = Qs + BM * LD;       // [BN][LD]
  float* Vs = Ks + BN * LD;       // [BN][LD]
  float* Ps = Vs + BN * LD;       // [BM][LP]
  float* bias_s = Ps + BM * LP;   // [BN]
  int* kseg_s = reinterpret_cast<int*>(bias_s + BN);  // [BN]
  int* qseg_s = kseg_s + BN;                           // [BM]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int Sq = p.Sq, Sk = p.Sk;
  const int coff = Sk - Sq;

  const T* qb = head_ptr<const T>(p.q, p.q_s, b, h);
  const T* kb = head_ptr<const T>(p.k, p.k_s, b, h);
  const T* vb = head_ptr<const T>(p.v, p.v_s, b, h);
  T* ob = head_ptr<T>(p.o, p.o_s, b, h);

  load_tile<T, D>(Qs, qb, p.q_s[1], m0, Sq);
  if (MASKED) load_query_segs(qseg_s, p, b, m0, BM);

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
  if (p.causal) {
    const int last_row = min(m0 + BM, Sq) - 1;
    n_end = min(Sk, last_row + coff + 1);
  }

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_pair<T, D>(Ks, kb, p.k_s[1], Vs, vb, p.v_s[1], n0, Sk);
    if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0);
    __syncthreads();

    float s[4][4];
    dot_tile<D>(s, Qs, Ks);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = score<MASKED>(s[i][j], p, m0 + r, n0 + c, bias_s, kseg_s,
                                c, qseg_s, r);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = prob(s[i][j], m_new);
        Ps[r * LP + tx + 16 * j] = pr;
        rs += pr;
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
    acc_tile<D, false>(acc, Ps, Vs);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    const bool dead = m_i[i] <= NEG_INF / 2;
    const float inv = 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = dead ? 0.f : acc[i][c] * inv;
    if (p.lse && tx == 0 && row < Sq)
      p.lse[static_cast<long long>(bh) * Sq + row] =
          dead ? NEG_INF : m_i[i] + logf(l_i[i] == 0.f ? 1.f : l_i[i]);
  }
  store_tile<T, D>(ob, p.o_s[1], m0, Sq, acc);
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = has_masks(p) ? flash_fwd_kernel<T, D, true>
                           : flash_fwd_kernel<T, D, false>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BM - 1) / BM, p.B * p.H);
  kern<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

#define PTT_LAUNCH_FWD(T, D) launch<T, D>(*p, s)

// The forward: O (and LSE when p->lse is set) from Q, K, V and the
// optional bias / segment ids of *p.
extern "C" int flash_fwd(const ptt::flash::Params* p, void* stream) {
  if (p->Sq <= 0 || p->B * p->H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_FLASH_DISPATCH(*p, PTT_LAUNCH_FWD);
}
