// Flash-attention backward for Hopper (sm_90a): the row-parallel dQ
// kernel and the column-parallel dK/dV(/dbias) kernel.
//
// Replaces: paddle_tpu/ops/pallas/attention.py:343 `_bwd_dq_kernel`
// (launched at :817) and :399 `_bwd_dkv_kernel` (launched at :867), the
// two-kernel backward of `_flash_core` for shapes that span several
// tiles.  From the forward's residuals (Q, K, V, O and the row LSE) and
// dO, per (batch, head):
//
//   P  = exp(scale * Q K^T + bias + masks - LSE)   (0 where masked)
//   dP = dO V^T,  delta = rowsum(dO * O),  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO,
//   dbias = colsum(dS)                     (only when the bias needs it)
//
// with the masks of flash_fwd.cu.  A dead row (every key masked) has
// LSE = NEG_INF and gets P = 0 exactly, never exp(NaN)
// (attention.py:373-375).
//
// Hopper has no sequential grid: the TPU kernels carry dq / dk / dv
// accumulators across grid steps in VMEM scratch (attention.py:352-356,
// 414-420).  Here one CTA loops over the other axis:
//   * flash_bwd_dq: a CTA per (b*h, 64-row query tile) walks the key
//     tiles (stopping at the causal diagonal).  It first computes delta
//     for its rows and writes it to [B*H, Sq] f32 for dK/dV, which runs
//     next on the same stream;
//   * flash_bwd_dkv: a CTA per (b*h, 64-row key tile) walks the query
//     tiles, skipping those wholly above the causal diagonal; dbias is
//     the column sum of dS inside the same CTA.
// No atomics: the backward is deterministic.
//
// What bounds it on this card: 7 products of S^2 D per head (S and dP
// are recomputed in both kernels; halved under causal masking) against
// ~7 S D elements of traffic: compute-bound at S >= 128.  Plain f32 FMA
// from shared memory, as flash_fwd.cu; tensor-core MMA is later work.
//
// Shared memory, D = 64: four 64 x 65 f32 operand tiles and the 64 x 65
// P / dS tile, 83,200 bytes, plus 1 KB of row statistics and masks (two
// CTAs per SM).  The raise above 48 KB is the cudaFuncSetAttribute in
// `launch`.

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;
using ptt::NEG_INF;

template <int D>
constexpr int smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * LP) * 4 + 5 * 64 * 4;
}

template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BM][LD]
  float* dOs = Qs + BM * LD;      // [BM][LD]
  float* Ks = dOs + BM * LD;      // [BN][LD]
  float* Vs = Ks + BN * LD;       // [BN][LD]
  float* Ps = Vs + BN * LD;       // [BM][LP]: dS of the key tile
  float* lse_s = Ps + BM * LP;    // [BM]
  float* delta_s = lse_s + BM;    // [BM]
  float* bias_s = delta_s + BM;   // [BN]
  int* kseg_s = reinterpret_cast<int*>(bias_s + BN);  // [BN]
  int* qseg_s = kseg_s + BN;                           // [BM]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int Sq = p.Sq, Sk = p.Sk;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const T* qb = head_ptr<const T>(p.q, p.q_s, b, h);
  const T* kb = head_ptr<const T>(p.k, p.k_s, b, h);
  const T* vb = head_ptr<const T>(p.v, p.v_s, b, h);
  const T* ob = head_ptr<const T>(p.o, p.o_s, b, h);
  const T* dob = head_ptr<const T>(p.dout, p.do_s, b, h);

  load_tile_pair<T, D>(Qs, qb, p.q_s[1], dOs, dob, p.do_s[1], m0, Sq);
  if (MASKED) load_query_segs(qseg_s, p, b, m0, BM);
  for (int r = threadIdx.x; r < BM; r += NT)
    lse_s[r] = m0 + r < Sq ? p.lse[row_base + m0 + r] : NEG_INF;
  row_delta<T, D>(delta_s, ob, p.o_s[1], dob, p.do_s[1], m0, BM, Sq);
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += NT)
    if (m0 + r < Sq) p.delta[row_base + m0 + r] = delta_s[r];

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_end = Sk;
  if (p.causal) {
    const int last_row = min(m0 + BM, Sq) - 1;
    n_end = min(Sk, last_row + (Sk - Sq) + 1);
  }

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_pair<T, D>(Ks, kb, p.k_s[1], Vs, vb, p.v_s[1], n0, Sk);
    if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, Qs, Ks);
    dot_tile<D>(dp, dOs, Vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sc = score<MASKED>(s[i][j], p, m0 + r, n0 + c, bias_s,
                                       kseg_s, c, qseg_s, r);
        const float pr = prob(sc, lse_s[r]);
        Ps[r * LP + c] = pr * (dp[i][j] - delta_s[r]) * p.scale;
      }
    }
    __syncthreads();
    acc_tile<D, false>(acc, Ps, Ks);
  }

  store_tile<T, D>(head_ptr<T>(p.dq, p.dq_s, b, h), p.dq_s[1], m0, Sq, acc);
}

template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BN][LD]
  float* Vs = Ks + BN * LD;       // [BN][LD]
  float* Qs = Vs + BN * LD;       // [BM][LD]
  float* dOs = Qs + BM * LD;      // [BM][LD]
  float* Ps = dOs + BM * LD;      // [BN][LP]: P^T, then dS^T
  float* lse_s = Ps + BN * LP;    // [BM]
  float* delta_s = lse_s + BM;    // [BM]
  float* bias_s = delta_s + BM;   // [BN]
  int* kseg_s = reinterpret_cast<int*>(bias_s + BN);  // [BN]
  int* qseg_s = kseg_s + BN;                           // [BM]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * BN;
  const int Sq = p.Sq, Sk = p.Sk;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const T* qb = head_ptr<const T>(p.q, p.q_s, b, h);
  const T* dob = head_ptr<const T>(p.dout, p.do_s, b, h);

  load_tile_pair<T, D>(Ks, head_ptr<const T>(p.k, p.k_s, b, h), p.k_s[1], Vs,
                       head_ptr<const T>(p.v, p.v_s, b, h), p.v_s[1], n0, Sk);
  if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0);

  float dk[4][DC], dv[4][DC], db[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    db[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[a][c] = dv[a][c] = 0.f;
  }

  // under causal masking key n0 is first visible to row n0 - (Sk - Sq):
  // query tiles wholly above it are skipped
  int m_start = 0;
  if (p.causal) m_start = max(0, n0 - (Sk - Sq)) / BM * BM;

  for (int m0 = m_start; m0 < Sq; m0 += BM) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_pair<T, D>(Qs, qb, p.q_s[1], dOs, dob, p.do_s[1], m0, Sq);
    if (MASKED) load_query_segs(qseg_s, p, b, m0, BM);
    for (int r = threadIdx.x; r < BM; r += NT) {
      const bool ok = m0 + r < Sq;
      lse_s[r] = ok ? p.lse[row_base + m0 + r] : NEG_INF;
      delta_s[r] = ok ? p.delta[row_base + m0 + r] : 0.f;
    }
    __syncthreads();

    key_tile_step<D, MASKED>(dk, dv, db, Ps, Ks, Vs, Qs, dOs, lse_s, delta_s,
                             qseg_s, bias_s, kseg_s, p, m0, n0);
  }
  store_key_tile<T, D>(p, b, h, n0, dk, dv, db);
}

template <typename T, int D, bool DQ, bool MASKED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = DQ ? flash_bwd_dq_kernel<T, D, MASKED>
                 : flash_bwd_dkv_kernel<T, D, MASKED>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = DQ ? p.Sq : p.Sk;
  dim3 grid((rows + 63) / 64, p.B * p.H);
  kern<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

#define PTT_LAUNCH_DQ(T, D)                                    \
  (ptt::flash::has_masks(*p) ? launch<T, D, true, true>(*p, s)  \
                             : launch<T, D, true, false>(*p, s))
#define PTT_LAUNCH_DKV(T, D)                                    \
  (ptt::flash::has_masks(*p) ? launch<T, D, false, true>(*p, s) \
                             : launch<T, D, false, false>(*p, s))

// dQ, and delta = rowsum(dO * O) into p->delta for flash_bwd_dkv.
extern "C" int flash_bwd_dq(const ptt::flash::Params* p, void* stream) {
  if (p->Sq <= 0 || p->B * p->H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_FLASH_DISPATCH(*p, PTT_LAUNCH_DQ);
}

// dK, dV and (when p->dbias is set) dbias; reads the delta that
// flash_bwd_dq wrote on the same stream.
extern "C" int flash_bwd_dkv(const ptt::flash::Params* p, void* stream) {
  if (p->Sk <= 0 || p->B * p->H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_FLASH_DISPATCH(*p, PTT_LAUNCH_DKV);
}
