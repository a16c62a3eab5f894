// Fused flash-attention backward for short rows, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/attention.py:490 `_bwd_fused_kernel`
// (launched by `_bwd_fused` at :580), the single-block backward the
// reference takes when one block covers the whole row (nq = nk = 1: the
// flagship BERT step at S = 512).  It computes dQ, dK, dV and dbias in
// one launch that shares s, p, dP and dS, so S and dP are computed once
// instead of twice (5 products of S^2 D per head instead of the pair's
// 7), with the math and masks of flash_bwd.cu.
//
// It is the short-row counterpart of the TPU kernel, not a copy of its
// one-block schedule: a TPU core holds a whole 512 x 512 score block in
// VMEM; an SM does not.  One CTA per (batch*head) walks the key tiles;
// for each it keeps that tile's dK and dV in registers while it walks
// the query tiles, and accumulates dQ for every query row in shared
// memory, so no atomics are needed and the result is deterministic.
// The LSE is the one the forward saved (the TPU kernel recomputed it
// from the full score row, `_recompute_lse` :165); delta = rowsum(dO*O)
// is computed once for all rows in the prologue.
//
// Taken (ops/attention.py `_use_fused_bwd`) when D = 64 and Sq, Sk <=
// 512.  Shared memory at Sq = 512: the f32 dQ accumulator 512 x 65
// (133,120 bytes), K, V, Q and dO tiles 4 x 64 x 65 (66,560), the
// P / dS tile 64 x 65 (16,640) and the row statistics (LSE, delta, query
// segment ids: 6,144) and key masks (512): 222,976 bytes, under the 227
// KB a CTA may take once `launch` raises the limit with
// cudaFuncSetAttribute.
//
// What bounds it on this card: 5 products of S^2 D per head against ~7
// S D elements of traffic: compute-bound.  Plain f32 FMA from shared
// memory, as flash_fwd.cu.  One CTA per SM (by shared memory) and B*H
// CTAs: the BERT step (B = 60, H = 12) gives 720 CTAs, 5.5 waves.

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;
using ptt::NEG_INF;

constexpr int D = 64;
constexpr int LD = D + 1;
constexpr int DC = D / 16;
constexpr int MAX_S = 512;

constexpr int smem_bytes(int sq) {
  return (sq * LD + 4 * 64 * LD + 64 * LP + 3 * MAX_S + 2 * 64) * 4;
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(NT) flash_bwd_fused_kernel(const Params p) {
  const int Sq = p.Sq, Sk = p.Sk;
  const int sq_pad = (Sq + BM - 1) / BM * BM;
  extern __shared__ float smem[];
  float* dQs = smem;               // [sq_pad][LD] f32 dQ accumulator
  float* Ks = dQs + sq_pad * LD;   // [BN][LD]
  float* Vs = Ks + BN * LD;        // [BN][LD]
  float* Qs = Vs + BN * LD;        // [BM][LD]
  float* dOs = Qs + BM * LD;       // [BM][LD]
  float* Ps = dOs + BM * LD;       // [BN][LP]: P^T, then dS^T
  float* lse_s = Ps + BN * LP;     // [MAX_S]
  float* delta_s = lse_s + MAX_S;  // [MAX_S]
  int* qseg_s = reinterpret_cast<int*>(delta_s + MAX_S);  // [MAX_S]
  float* bias_s = reinterpret_cast<float*>(qseg_s + MAX_S);  // [BN]
  int* kseg_s = reinterpret_cast<int*>(bias_s + BN);         // [BN]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const T* qb = head_ptr<const T>(p.q, p.q_s, b, h);
  const T* kb = head_ptr<const T>(p.k, p.k_s, b, h);
  const T* vb = head_ptr<const T>(p.v, p.v_s, b, h);
  const T* ob = head_ptr<const T>(p.o, p.o_s, b, h);
  const T* dob = head_ptr<const T>(p.dout, p.do_s, b, h);

  for (int idx = threadIdx.x; idx < sq_pad * LD; idx += NT) dQs[idx] = 0.f;
  for (int r = threadIdx.x; r < sq_pad; r += NT)
    lse_s[r] = r < Sq ? p.lse[row_base + r] : NEG_INF;
  if (MASKED) load_query_segs(qseg_s, p, b, 0, sq_pad);
  row_delta<T, D>(delta_s, ob, p.o_s[1], dob, p.do_s[1], 0, sq_pad, Sq);

  for (int n0 = 0; n0 < Sk; n0 += BN) {
    __syncthreads();  // the previous key tile's readers are done
    load_tile_pair<T, D>(Ks, kb, p.k_s[1], Vs, vb, p.v_s[1], n0, Sk);
    if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0);

    float dk[4][DC], dv[4][DC], db[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      db[a] = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) dk[a][c] = dv[a][c] = 0.f;
    }

    int m_start = 0;
    if (p.causal) m_start = max(0, n0 - (Sk - Sq)) / BM * BM;
    for (int m0 = m_start; m0 < Sq; m0 += BM) {
      __syncthreads();  // the previous query tile's readers are done
      load_tile_pair<T, D>(Qs, qb, p.q_s[1], dOs, dob, p.do_s[1], m0, Sq);
      __syncthreads();

      key_tile_step<D, MASKED>(dk, dv, db, Ps, Ks, Vs, Qs, dOs, lse_s + m0,
                               delta_s + m0, qseg_s + m0, bias_s, kseg_s, p,
                               m0, n0);
      // dQ rows m0 + ty + 16 i += dS K: each (row, column) of the
      // accumulator belongs to one thread
      float dq[4][DC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
      acc_tile<D, true>(dq, Ps, Ks);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          dQs[(m0 + ty + 16 * i) * LD + tx + 16 * c] += dq[i][c];
    }

    store_key_tile<T, D>(p, b, h, n0, dk, dv, db);
  }
  __syncthreads();

  T* dqb = head_ptr<T>(p.dq, p.dq_s, b, h);
  for (int idx = threadIdx.x; idx < Sq * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    ptt::store(&dqb[r * p.dq_s[1] + c], dQs[r * LD + c]);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = has_masks(p) ? flash_bwd_fused_kernel<T, true>
                           : flash_bwd_fused_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MAX_S));
  if (err != cudaSuccess) return err;
  const int bytes = smem_bytes((p.Sq + BM - 1) / BM * BM);
  kern<<<p.B * p.H, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dQ, dK, dV and (when p->dbias is set) dbias in one launch; D = 64 and
// Sq, Sk <= 512 only.
extern "C" int flash_bwd_fused(const ptt::flash::Params* p, void* stream) {
  if (p->B * p->H <= 0 || p->Sq <= 0 || p->Sk <= 0) return cudaSuccess;
  if (p->D != D || p->Sq > MAX_S || p->Sk > MAX_S)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == ptt::kF32) return launch<float>(*p, s);
  if (p->dtype == ptt::kBF16) return launch<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
