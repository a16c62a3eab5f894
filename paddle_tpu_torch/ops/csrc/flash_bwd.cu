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
//   * flash_bwd_dq: a CTA per (b*h, query tile) walks the key tiles
//     (stopping at the causal diagonal).  It first computes delta for
//     its rows and writes it to [B*H, Sq] f32 for dK/dV, which runs next
//     on the same stream;
//   * flash_bwd_dkv: a CTA per (b*h, key tile) walks the query tiles,
//     skipping those wholly above the causal diagonal; dbias is the
//     column sum of dS inside the same CTA.
// No atomics: the backward is deterministic, bit for bit.
//
// What bounds it on this card: 7 products of S^2 D per head (S and dP
// are recomputed in both kernels; halved under causal masking) against
// ~7 S D elements of traffic: compute-bound at S >= 128.  Two designs:
//
// bf16 (`flash_bwd_dq_tc`, `flash_bwd_dkv_tc`): mma.sync.m16n8k16 bf16
// -> f32 on the tensor cores (tc_common.cuh), 8 warps, each owning 16
// rows of the CTA's tile, the operands it forms itself (P, dS) entering
// the products as (hi, lo) bf16 pairs (flash_tc.cuh's numerical
// contract), so the pair does 10 MMAs of S^2 D per head against the
// fused kernel's 8 (counting both halves).
//   * dQ: 128 query rows a CTA.  Q and dO stay as the warps' A fragments
//     for the whole walk; the 64-key K and V tiles come through a
//     2-stage cp.async ring with zero fill (and the tile's key masks
//     through registers beside it).  A warp forms S = Q K^T and dP =
//     dO V^T for its 16 rows in f32 (K and V read K-major by ldmatrix),
//     P and dS in registers, and adds dQ += scale dS K with dS as the
//     (hi, lo) A fragments and K read MN-major by ldmatrix.trans; dQ
//     stays in f32 registers.
//   * dK/dV: kernel 4's key-tile body (flash_bwd_fused.cu) without its
//     dQ: 128 keys a CTA, the 64-query Q and dO tiles (and their rows'
//     lse, delta and segment ids) through a 2-stage ring.  A warp forms
//     S^T = K Q^T and dP^T = V dO^T for its 16 keys, P^T and dS^T in
//     registers, and adds dV += P^T dO and dK += scale dS^T Q (dO and Q
//     read MN-major by ldmatrix.trans); dbias is summed in registers.
//   Registers: at D = 64 the dK/dV kernel keeps K and V as A fragments
//   for the whole walk (32 registers) beside its dK and dV (64) and
//   takes 32 queries a score sub-tile; at D = 128 dK and dV alone take
//   128, so K and V stay in shared memory and are read again for each
//   sub-tile, of 16 queries.  The dQ kernel's Q, dO fragments and dQ
//   take 64 registers at D = 64 and 128 at D = 128, with score sub-tiles
//   of 64 and 32 keys.  Shared memory: dQ 76,288 bytes at D = 64 and
//   141,824 at D = 128 (Q and dO 128 rows, the K / V ring 2 x 2 x 64
//   rows, rows padded to D + 8); dK/dV the same (K and V 128 rows, the
//   Q / dO ring 2 x 2 x 64 rows).  One CTA an SM (registers).
//
// f32 (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`): plain f32 FMA
// from shared memory (TF32 is not f32), 64-row tiles: four 64 x 65 f32
// operand tiles and the 64 x 65 P / dS tile, 83,200 bytes at D = 64,
// plus 1 KB of row statistics and masks (two CTAs per SM).

#include "flash_common.cuh"
#include "flash_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

using namespace ptt::tcore;
using ptt::hopper::c_to_a;
using ptt::hopper::load_rows;
using bf16 = __nv_bfloat16;

constexpr int WROWS = 16;         // rows of a CTA tile a warp owns
constexpr int TILE = NT / 32 * WROWS;  // 128: query rows (dQ), keys (dK/dV)
constexpr int RING = 64;          // keys (dQ) or queries (dK/dV) a stage

template <int D>
constexpr int tc_smem_bytes() {
  // the CTA's two 128-row operands, the 2-stage ring of two 64-row
  // operands, rows padded to D + 8; then 5 x 128 words of row
  // statistics and masks
  return (2 * TILE + 4 * RING) * (D + 8) * 2 + 5 * TILE * 4;
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_tc(const Params p) {
  constexpr int LDT = D + 8;
  constexpr int DK = D / 16;              // 16-deep steps of the head dim
  constexpr int KS = D == 64 ? 64 : 32;   // keys of a warp's score sub-tile
  constexpr int NS = KS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LDT]
  bf16* dOs = Qs + TILE * LDT;                   // [TILE][LDT]
  bf16* KV = dOs + TILE * LDT;          // [2 stages][K, V][RING][LDT]
  float* lse_s = reinterpret_cast<float*>(KV + 4 * RING * LDT);  // [TILE]
  float* delta_s = lse_s + TILE;                                 // [TILE]
  int* qseg_s = reinterpret_cast<int*>(delta_s + TILE);          // [TILE]
  float* bias_s = reinterpret_cast<float*>(qseg_s + TILE);  // [2][RING]
  int* kseg_s = reinterpret_cast<int*>(bias_s + 2 * RING);  // [2][RING]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const bf16* qb = head_ptr<const bf16>(p.q, p.q_s, b, h);
  const bf16* kb = head_ptr<const bf16>(p.k, p.k_s, b, h);
  const bf16* vb = head_ptr<const bf16>(p.v, p.v_s, b, h);
  const bf16* ob = head_ptr<const bf16>(p.o, p.o_s, b, h);
  const bf16* dob = head_ptr<const bf16>(p.dout, p.do_s, b, h);

  // under causal masking the tile's last row sees keys up to it + Sk - Sq
  int n_end = Sk;
  if (p.causal) n_end = min(Sk, min(m0 + TILE, Sq) + (Sk - Sq));

  load_rows<TILE, D>(Qs, qb, p.q_s[1], m0, Sq);
  load_rows<TILE, D>(dOs, dob, p.do_s[1], m0, Sq);
  if (n_end > 0) {
    load_rows<RING, D>(KV, kb, p.k_s[1], 0, Sk);
    load_rows<RING, D>(KV + RING * LDT, vb, p.v_s[1], 0, Sk);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < TILE; r += NT)
    lse_s[r] = m0 + r < Sq ? p.lse[row_base + m0 + r] : NEG_INF;
  if (MASKED) {
    load_query_segs(qseg_s, p, b, m0, TILE);
    load_key_masks(bias_s, kseg_s, p, b, h, 0, RING);
  }
  row_delta<bf16, D>(delta_s, ob, p.o_s[1], dob, p.do_s[1], m0, TILE, Sq);
  cp_async_wait<0>();
  __syncthreads();
  for (int r = threadIdx.x; r < TILE; r += NT)
    if (m0 + r < Sq) p.delta[row_base + m0 + r] = delta_s[r];

  // this warp's 16 rows: Q and dO as A fragments, and the rows' statistics
  const int wr = warp * WROWS;  // the warp's first row in the tile
  uint32_t qf[DK][4], dof[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int off = (wr + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[kk], Qs + off);
    ldsm_x4(dof[kk], dOs + off);
  }
  const float lse_r[2] = {lse_s[wr + g], lse_s[wr + g + 8]};
  const float delta_r[2] = {delta_s[wr + g], delta_s[wr + g + 8]};
  // the last key any of the warp's rows sees
  const int wlast = p.causal ? m0 + wr + WROWS - 1 + (Sk - Sq) : Sk - 1;
  const bool wlive = m0 + wr < Sq;

  float dq[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int it = 0;
  for (int n0 = 0; n0 < n_end; n0 += RING, ++it) {
    const int sg = it & 1;
    const bf16* Ks = KV + sg * 2 * RING * LDT;
    const bf16* Vs = Ks + RING * LDT;
    const float* bias_t = bias_s + sg * RING;
    const int* kseg_t = kseg_s + sg * RING;
    cp_async_wait<0>();
    __syncthreads();  // this stage has landed; the other one is free
    const bool more = n0 + RING < n_end;
    float bias_n = 0.f;
    int kseg_n = 0;
    if (more) {
      bf16* nxt = KV + (sg ^ 1) * 2 * RING * LDT;
      load_rows<RING, D>(nxt, kb, p.k_s[1], n0 + RING, Sk);
      load_rows<RING, D>(nxt + RING * LDT, vb, p.v_s[1], n0 + RING, Sk);
      // the next tile's key masks, into registers now and into the free
      // stage after this tile's products
      const int col = n0 + RING + threadIdx.x;
      if (MASKED && threadIdx.x < RING && col < Sk) {
        if (p.bias) bias_n = p.bias[b * p.bias_sb + h * p.bias_sh + col];
        if (p.kseg) kseg_n = p.kseg[b * Sk + col];
      }
    }
    cp_async_commit();

#pragma unroll 1
    for (int ko = 0; ko < RING; ko += KS) {
      if (!wlive || n0 + ko > wlast) break;
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x keys ko .. ko + KS
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          const int off =
              (ko + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDT + kk * 16 +
              ((lane >> 3) & 1) * 8;
          uint32_t t[4];
          ldsm_x4(t, Ks + off);
          mma(s[2 * nj], qf[kk], t[0], t[1]);
          mma(s[2 * nj + 1], qf[kk], t[2], t[3]);
          ldsm_x4(t, Vs + off);
          mma(dp[2 * nj], dof[kk], t[0], t[1]);
          mma(dp[2 * nj + 1], dof[kk], t[2], t[3]);
        }

      // P and scale dS in registers: element (n, e) is row wr + g +
      // 8 (e / 2), key n0 + ko + 8 n + 2 q + e % 2.  A sub-tile that no
      // mask reaches skips the mask tests.
      const bool interior =
          !MASKED && m0 + wr + WROWS <= Sq && n0 + ko + KS <= Sk &&
          (!p.causal || n0 + ko + KS - 1 <= m0 + wr + (Sk - Sq));
      if (interior) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = __expf(s[n][e] * p.scale - lse_r[e / 2]);
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = wr + g + 8 * (e / 2);
            const int kc = ko + 8 * n + 2 * q + (e & 1);
            s[n][e] = prob(score<MASKED>(s[n][e], p, m0 + qr, n0 + kc,
                                         bias_t, kseg_t, kc, qseg_s, qr),
                           lse_r[e / 2]);
          }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] * (dp[n][e] - delta_r[e / 2]) * p.scale;

      // dQ += scale dS K: dS (hi, lo) is the A fragment, K MN-major
      // through ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc) {
        uint32_t ah[4], al[4];
        c_to_a(s[2 * kc], s[2 * kc + 1], ah, al);
#pragma unroll
        for (int nd = 0; nd < DK; ++nd) {
          const int off = (ko + kc * 16 + (lane & 7) +
                           ((lane >> 3) & 1) * 8) * LDT +
                          nd * 16 + (lane >> 4) * 8;
          uint32_t t[4];
          ldsm_x4_t(t, Ks + off);
          mma(dq[2 * nd], ah, t[0], t[1]);
          mma(dq[2 * nd], al, t[0], t[1]);
          mma(dq[2 * nd + 1], ah, t[2], t[3]);
          mma(dq[2 * nd + 1], al, t[2], t[3]);
        }
      }
    }

    if (MASKED && more && threadIdx.x < RING) {
      bias_s[(sg ^ 1) * RING + threadIdx.x] = bias_n;
      kseg_s[(sg ^ 1) * RING + threadIdx.x] = kseg_n;
    }
  }

  bf16* dqb = head_ptr<bf16>(p.dq, p.dq_s, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wr + g + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * p.dq_s[1] + 8 * n +
                                         2 * q) =
          __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_tc(const Params p) {
  constexpr int LDT = D + 8;
  constexpr int DK = D / 16;
  // K and V as A fragments in registers for the whole walk, or (D = 128,
  // where dK and dV alone take 128 registers) read from shared memory
  constexpr bool KV_REGS = D == 64;
  constexpr int QS = D == 64 ? 32 : 16;  // queries of a warp's sub-tile
  constexpr int NQ = QS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LDT]
  bf16* Vs = Ks + TILE * LDT;                    // [TILE][LDT]
  bf16* QdO = Vs + TILE * LDT;          // [2 stages][Q, dO][RING][LDT]
  float* lse_s = reinterpret_cast<float*>(QdO + 4 * RING * LDT);  // [2][RING]
  float* delta_s = lse_s + 2 * RING;                    // [2][RING]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * RING);  // [2][RING]
  float* bias_s = reinterpret_cast<float*>(qseg_s + 2 * RING);  // [TILE]
  int* kseg_s = reinterpret_cast<int*>(bias_s + TILE);          // [TILE]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const bf16* qb = head_ptr<const bf16>(p.q, p.q_s, b, h);
  const bf16* dob = head_ptr<const bf16>(p.dout, p.do_s, b, h);

  // under causal masking key n0 is first visible to row n0 - (Sk - Sq):
  // query tiles wholly above it are skipped
  const int m_start =
      p.causal ? max(0, n0 - (Sk - Sq)) / RING * RING : 0;

  load_rows<TILE, D>(Ks, head_ptr<const bf16>(p.k, p.k_s, b, h), p.k_s[1],
                     n0, Sk);
  load_rows<TILE, D>(Vs, head_ptr<const bf16>(p.v, p.v_s, b, h), p.v_s[1],
                     n0, Sk);
  if (m_start < Sq) {
    load_rows<RING, D>(QdO, qb, p.q_s[1], m_start, Sq);
    load_rows<RING, D>(QdO + RING * LDT, dob, p.do_s[1], m_start, Sq);
  }
  cp_async_commit();
  if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0, TILE);
  // the statistics of a query tile's rows: thread t < RING loads lse,
  // RING <= t < 2 RING delta, 2 RING <= t < 3 RING the segment id of
  // row t % RING
  const int sr = threadIdx.x % RING, sw = threadIdx.x / RING;
  auto load_stat = [&](int m, float& f, int& i) {
    const int row = m + sr;
    const bool ok = row < Sq;
    if (sw == 0) f = ok ? p.lse[row_base + row] : NEG_INF;
    if (sw == 1) f = ok ? p.delta[row_base + row] : 0.f;
    if (MASKED && sw == 2 && p.qseg) i = ok ? p.qseg[b * Sq + row] : 0;
  };
  auto store_stat = [&](int stage, float f, int i) {
    if (sw == 0) lse_s[stage * RING + sr] = f;
    if (sw == 1) delta_s[stage * RING + sr] = f;
    if (MASKED && sw == 2) qseg_s[stage * RING + sr] = i;
  };
  {
    float f = 0.f;
    int i = 0;
    if (m_start < Sq) load_stat(m_start, f, i);
    store_stat(0, f, i);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 keys
  const int wk = warp * WROWS;
  const int key0 = n0 + wk;
  uint32_t kf[KV_REGS ? DK : 1][4], vf[KV_REGS ? DK : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int off = (wk + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(kf[kk], Ks + off);
      ldsm_x4(vf[kk], Vs + off);
    }
  }

  float dk[2 * DK][4], dv[2 * DK][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int it = 0;
  for (int m0 = m_start; m0 < Sq; m0 += RING, ++it) {
    const int sg = it & 1;
    const bf16* Qs = QdO + sg * 2 * RING * LDT;
    const bf16* dOs = Qs + RING * LDT;
    const float* lse_t = lse_s + sg * RING;
    const float* delta_t = delta_s + sg * RING;
    const int* qseg_t = qseg_s + sg * RING;
    cp_async_wait<0>();
    __syncthreads();  // this stage has landed; the other one is free
    const bool more = m0 + RING < Sq;
    float stat_f = 0.f;
    int stat_i = 0;
    if (more) {
      bf16* nxt = QdO + (sg ^ 1) * 2 * RING * LDT;
      load_rows<RING, D>(nxt, qb, p.q_s[1], m0 + RING, Sq);
      load_rows<RING, D>(nxt + RING * LDT, dob, p.do_s[1], m0 + RING, Sq);
      load_stat(m0 + RING, stat_f, stat_i);
    }
    cp_async_commit();

#pragma unroll 1
    for (int qo = 0; qo < RING; qo += QS) {
      // keys past Sk, or a sub-tile wholly above the causal diagonal
      if (key0 >= Sk ||
          (p.causal && m0 + qo + QS - 1 + (Sk - Sq) < key0))
        continue;
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x queries
      // qo .. qo + QS, f32
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ka[r] = kf[kk][r];
            va[r] = vf[kk][r];
          }
        } else {
          const int off =
              (wk + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
          ldsm_x4(ka, Ks + off);
          ldsm_x4(va, Vs + off);
        }
#pragma unroll
        for (int nj = 0; nj < NQ / 2; ++nj) {
          const int off =
              (qo + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDT + kk * 16 +
              ((lane >> 3) & 1) * 8;
          uint32_t t[4];
          ldsm_x4(t, Qs + off);
          mma(st[2 * nj], ka, t[0], t[1]);
          mma(st[2 * nj + 1], ka, t[2], t[3]);
          ldsm_x4(t, dOs + off);
          mma(dpt[2 * nj], va, t[0], t[1]);
          mma(dpt[2 * nj + 1], va, t[2], t[3]);
        }
      }

      // P^T and dS^T in registers: element (n, e) is key key0 + g +
      // 8 (e / 2), query m0 + qo + 8 n + 2 q + e % 2
      const bool interior = !MASKED && key0 + WROWS <= Sk &&
                            m0 + RING <= Sq &&
                            (!p.causal || key0 + WROWS - 1 <=
                                              m0 + qo + (Sk - Sq));
      if (interior) {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[n][e] = __expf(st[n][e] * p.scale -
                               lse_t[qo + 8 * n + 2 * q + (e & 1)]);
      } else {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = wk + g + 8 * (e / 2);
            const int qr = qo + 8 * n + 2 * q + (e & 1);
            st[n][e] = prob(score<MASKED>(st[n][e], p, m0 + qr, n0 + kc,
                                           bias_s, kseg_s, kc, qseg_t, qr),
                             lse_t[qr]);
          }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds =
              st[n][e] * (dpt[n][e] - delta_t[qo + 8 * n + 2 * q + (e & 1)]);
          db[e / 2] += ds;
          dpt[n][e] = ds * p.scale;
        }

      // dV += P^T dO and dK += scale dS^T Q: P^T and dS^T (hi, lo) are the
      // A fragments; dO and Q MN-major through ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NQ / 2; ++kq) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        c_to_a(st[2 * kq], st[2 * kq + 1], ph, pl);
        c_to_a(dpt[2 * kq], dpt[2 * kq + 1], sh, sl);
#pragma unroll
        for (int nd = 0; nd < DK; ++nd) {
          const int off =
              (qo + kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT +
              nd * 16 + (lane >> 4) * 8;
          uint32_t t[4];
          ldsm_x4_t(t, dOs + off);
          mma(dv[2 * nd], ph, t[0], t[1]);
          mma(dv[2 * nd], pl, t[0], t[1]);
          mma(dv[2 * nd + 1], ph, t[2], t[3]);
          mma(dv[2 * nd + 1], pl, t[2], t[3]);
          ldsm_x4_t(t, Qs + off);
          mma(dk[2 * nd], sh, t[0], t[1]);
          mma(dk[2 * nd], sl, t[0], t[1]);
          mma(dk[2 * nd + 1], sh, t[2], t[3]);
          mma(dk[2 * nd + 1], sl, t[2], t[3]);
        }
      }
    }

    if (more) store_stat(sg ^ 1, stat_f, stat_i);
  }

  // this warp's dK, dV rows and dbias columns
  bf16* dkb = head_ptr<bf16>(p.dk, p.dk_s, b, h);
  bf16* dvb = head_ptr<bf16>(p.dv, p.dv_s, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    float v = db[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (key >= Sk) continue;
    if (p.dbias && q == 0)
      p.dbias[static_cast<long long>(bh) * Sk + key] = v;
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n) {
      const int c = 8 * n + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * p.dk_s[1] + c) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * p.dv_s[1] + c) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D, bool DQ, bool MASKED>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  auto kern = DQ ? flash_bwd_dq_tc<D, MASKED> : flash_bwd_dkv_tc<D, MASKED>;
  constexpr int bytes = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = DQ ? p.Sq : p.Sk;
  dim3 grid((rows + TILE - 1) / TILE, p.B * p.H);
  kern<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// f32 (T = float) on FMA, bf16 on the tensor cores, at D = 64 or 128
template <bool DQ>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  const bool m = has_masks(p);
  if (p.dtype == ptt::kF32 && p.D == 64)
    return m ? launch<float, 64, DQ, true>(p, s)
             : launch<float, 64, DQ, false>(p, s);
  if (p.dtype == ptt::kF32 && p.D == 128)
    return m ? launch<float, 128, DQ, true>(p, s)
             : launch<float, 128, DQ, false>(p, s);
  if (p.dtype == ptt::kBF16 && p.D == 64)
    return m ? launch_tc<64, DQ, true>(p, s) : launch_tc<64, DQ, false>(p, s);
  if (p.dtype == ptt::kBF16 && p.D == 128)
    return m ? launch_tc<128, DQ, true>(p, s)
             : launch_tc<128, DQ, false>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dQ, and delta = rowsum(dO * O) into p->delta for flash_bwd_dkv.
extern "C" int flash_bwd_dq(const ptt::flash::Params* p, void* stream) {
  if (p->Sq <= 0 || p->B * p->H <= 0) return cudaSuccess;
  return dispatch<true>(*p, static_cast<cudaStream_t>(stream));
}

// dK, dV and (when p->dbias is set) dbias; reads the delta that
// flash_bwd_dq wrote on the same stream.
extern "C" int flash_bwd_dkv(const ptt::flash::Params* p, void* stream) {
  if (p->Sk <= 0 || p->B * p->H <= 0) return cudaSuccess;
  return dispatch<false>(*p, static_cast<cudaStream_t>(stream));
}
