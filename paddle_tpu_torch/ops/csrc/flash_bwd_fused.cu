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
// 512.  What bounds it on this card: 5 products of S^2 D per head
// against ~7 S D elements of traffic: compute-bound.  Two
// instantiations, one per dtype, each split MASKED or not:
//
// bf16 (`flash_bwd_fused_tc`, the BERT step): mma.sync.m16n8k16 bf16 ->
// f32 on the tensor cores (tc_common.cuh), 8 warps.  The CTA walks key
// tiles of 128 (each warp owns 16 keys) and, for each, the query tiles
// of 64.  The key tile's K and V come in by cp.async and stay as the
// warps' A fragments in registers for the whole query loop; the Q and
// dO tiles come through a 2-stage cp.async ring with zero fill, the
// next tile loading while this one is used.  A warp forms S^T = K Q^T
// and dP^T = V dO^T for its 16 keys (in sub-tiles of 32 queries, which
// keeps it within 255 registers: ptxas reports a 12-byte spill unmasked,
// none when MASKED), turns them into P^T
// and dS^T in registers and adds dV += P^T dO and dK += scale dS^T Q
// with P^T and dS^T themselves as (hi, lo) A fragments (flash_tc.cuh's
// numerical contract), dO and Q read MN-major by ldmatrix.trans.  dQ +=
// scale dS K needs dS in the other orientation: dS^T (hi, lo) goes to
// shared memory and comes back by ldmatrix.trans, as the GEMM's dZ tile
// does (gemm_common.cuh `make_dz`); each element of the f32 dQ
// accumulator belongs to one thread.  Shared memory at Sq = 512: the dQ
// accumulator 131,072 bytes (columns swizzled by row), K 18,432, the
// Q / dO ring 36,864, dS^T hi and lo 36,864 (the V tile is staged
// there before its fragments load), the row statistics 6,144 and key
// masks 1,024: 230,400 bytes.
//
// f32 (`flash_bwd_fused_kernel`): plain f32 FMA from shared memory, the
// tile scheme of flash_common.cuh with 64-key tiles.  Shared memory at
// Sq = 512: the f32 dQ accumulator 512 x 65 (133,120 bytes), K, V, Q and
// dO tiles 4 x 64 x 65 (66,560), the P / dS tile 64 x 65 (16,640), the
// row statistics (6,144) and key masks (512): 222,976 bytes.
//
// Both give one CTA per SM (by shared memory) and B*H CTAs: the BERT
// step (B = 60, H = 12) gives 720 CTAs, 5.5 waves.

#include "flash_common.cuh"
#include "flash_tc.cuh"

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


// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

using namespace ptt::tcore;
using ptt::hopper::c_to_a;
using ptt::hopper::load_rows;
using ptt::hopper::split2;
using bf16 = __nv_bfloat16;

constexpr int KT = 128;     // keys of a tile: 8 warps x 16
constexpr int QT = 64;      // queries of a tile
constexpr int LDT = D + 8;  // padded bf16 row of a shared tile
constexpr int QS = 32;     // queries of the score sub-tile a warp holds

constexpr int tc_smem_bytes(int sq_pad) {
  return sq_pad * D * 4 + (KT + 4 * QT + 2 * KT) * LDT * 2 + 3 * MAX_S * 4 +
         2 * KT * 4;
}

// dQ accumulator element (r, c): columns swizzled by row against bank
// conflicts (pairs of columns stay together)
__device__ __forceinline__ int dq_at(int r, int c) {
  return r * D + (c ^ ((r & 7) << 3));
}

template <bool MASKED>
__global__ void __launch_bounds__(NT, 1) flash_bwd_fused_tc(const Params p) {
  const int Sq = p.Sq, Sk = p.Sk;
  const int sq_pad = (Sq + QT - 1) / QT * QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dQs = reinterpret_cast<float*>(smem_raw);   // [sq_pad][D] f32
  bf16* Ks = reinterpret_cast<bf16*>(dQs + sq_pad * D);  // [KT][LDT]
  bf16* QdO = Ks + KT * LDT;        // [2 stages][Q, dO][QT][LDT]
  bf16* dSh = QdO + 4 * QT * LDT;   // [KT][LDT]: dS^T hi
  bf16* dSl = dSh + KT * LDT;       // [KT][LDT]: dS^T lo
  bf16* Vst = dSh;                  // the V tile, until its fragments load
  float* lse_s = reinterpret_cast<float*>(dSl + KT * LDT);  // [MAX_S]
  float* delta_s = lse_s + MAX_S;                            // [MAX_S]
  int* qseg_s = reinterpret_cast<int*>(delta_s + MAX_S);     // [MAX_S]
  float* bias_s = reinterpret_cast<float*>(qseg_s + MAX_S);  // [KT]
  int* kseg_s = reinterpret_cast<int*>(bias_s + KT);         // [KT]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const long long row_base = static_cast<long long>(bh) * Sq;

  const bf16* qb = head_ptr<const bf16>(p.q, p.q_s, b, h);
  const bf16* kb = head_ptr<const bf16>(p.k, p.k_s, b, h);
  const bf16* vb = head_ptr<const bf16>(p.v, p.v_s, b, h);
  const bf16* ob = head_ptr<const bf16>(p.o, p.o_s, b, h);
  const bf16* dob = head_ptr<const bf16>(p.dout, p.do_s, b, h);

  for (int idx = threadIdx.x; idx < sq_pad * D; idx += NT) dQs[idx] = 0.f;
  for (int r = threadIdx.x; r < sq_pad; r += NT)
    lse_s[r] = r < Sq ? p.lse[row_base + r] : NEG_INF;
  if (MASKED) load_query_segs(qseg_s, p, b, 0, sq_pad);
  row_delta<bf16, D>(delta_s, ob, p.o_s[1], dob, p.do_s[1], 0, sq_pad, Sq);

  for (int n0 = 0; n0 < Sk; n0 += KT) {
    const int m_start =
        p.causal ? max(0, n0 - (Sk - Sq)) / QT * QT : 0;
    __syncthreads();  // the previous key tile's readers are done
    load_rows<KT, D>(Ks, kb, p.k_s[1], n0, Sk);
    load_rows<KT, D>(Vst, vb, p.v_s[1], n0, Sk);
    cp_async_commit();
    if (m_start < Sq) {
      load_rows<QT, D>(QdO, qb, p.q_s[1], m_start, Sq);
      load_rows<QT, D>(QdO + QT * LDT, dob, p.do_s[1], m_start, Sq);
    }
    cp_async_commit();
    if (MASKED) load_key_masks(bias_s, kseg_s, p, b, h, n0, KT);
    cp_async_wait<0>();
    __syncthreads();

    // this warp's 16 keys: K and V as A fragments, 4 steps of the head dim
    uint32_t kf[4][4], vf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int off =
          (warp * 16 + (lane & 15)) * LDT + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(kf[kk], Ks + off);
      ldsm_x4(vf[kk], Vst + off);
    }

    float dk[8][4], dv[8][4], db[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    int it = 0;
    for (int m0 = m_start; m0 < Sq; m0 += QT, ++it) {
      bf16* Qs = QdO + (it & 1) * 2 * QT * LDT;
      bf16* dOs = Qs + QT * LDT;
      cp_async_wait<0>();
      __syncthreads();  // this tile has landed; the other stage is free
      if (m0 + QT < Sq) {
        bf16* nxt = QdO + ((it + 1) & 1) * 2 * QT * LDT;
        load_rows<QT, D>(nxt, qb, p.q_s[1], m0 + QT, Sq);
        load_rows<QT, D>(nxt + QT * LDT, dob, p.do_s[1], m0 + QT, Sq);
      }
      cp_async_commit();

      // the query tile in sub-tiles of QS: a warp holds S^T, dP^T for
      // 16 keys x QS queries
#pragma unroll 1
      for (int qo = 0; qo < QT; qo += QS) {
        // S^T = K Q^T and dP^T = V dO^T: keys x queries qo .. qo + QS, f32
        constexpr int NQ = QS / 8;
        float st[NQ][4], dpt[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nj = 0; nj < NQ / 2; ++nj) {
            const int off =
                (qo + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDT +
                kk * 16 + ((lane >> 3) & 1) * 8;
            uint32_t t[4];
            ldsm_x4(t, Qs + off);
            mma(st[2 * nj], kf[kk], t[0], t[1]);
            mma(st[2 * nj + 1], kf[kk], t[2], t[3]);
            ldsm_x4(t, dOs + off);
            mma(dpt[2 * nj], vf[kk], t[0], t[1]);
            mma(dpt[2 * nj + 1], vf[kk], t[2], t[3]);
          }

        // P and dS in registers: element (n, e) is key 16 warp + g +
        // 8 (e / 2), query m0 + qo + 8 n + 2 q + e % 2.  A sub-tile that no
        // mask reaches (its keys < Sk, the query tile's rows < Sq, below
        // the causal diagonal) skips the mask tests; each path is
        // straight-line code.
        const bool interior = !MASKED && n0 + warp * 16 + 16 <= Sk &&
            m0 + QT <= Sq &&
            (!p.causal || n0 + warp * 16 + 15 <= m0 + qo + (Sk - Sq));
        if (interior) {
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = m0 + qo + 8 * n + 2 * q + (e & 1);
              st[n][e] = __expf(st[n][e] * p.scale - lse_s[qr]);
            }
        } else {
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kc = warp * 16 + g + 8 * (e / 2);
              const int qr = m0 + qo + 8 * n + 2 * q + (e & 1);
              st[n][e] = prob(score<MASKED>(st[n][e], p, qr, n0 + kc, bias_s,
                                            kseg_s, kc, qseg_s, qr),
                              lse_s[qr]);
            }
        }
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds =
                st[n][e] * (dpt[n][e] - delta_s[m0 + qo + 8 * n + 2 * q +
                                                (e & 1)]);
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
          for (int nd = 0; nd < 4; ++nd) {
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

        // scale dS^T (hi, lo) to shared memory for dQ
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t hi, lo;
            split2(dpt[n][2 * i], dpt[n][2 * i + 1], hi, lo);
            const int off = (warp * 16 + g + 8 * i) * LDT + qo + 8 * n + 2 * q;
            *reinterpret_cast<uint32_t*>(dSh + off) = hi;
            *reinterpret_cast<uint32_t*>(dSl + off) = lo;
          }
      }
      __syncthreads();

      // dQ rows m0 + 16 wr .. +16, columns 32 wc .. +32 += dS K over the
      // tile's 128 keys; each accumulator element belongs to one thread
      const int wr = warp & 3, wc = warp >> 2;
      float dq[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const int aoff = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDT +
                         wr * 16 + ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, dSh + aoff);
        ldsm_x4_t(al, dSl + aoff);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t t[4];
          ldsm_x4_t(t, Ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDT + wc * 32 + nj * 16 + (lane >> 4) * 8);
          mma(dq[2 * nj], ah, t[0], t[1]);
          mma(dq[2 * nj], al, t[0], t[1]);
          mma(dq[2 * nj + 1], ah, t[2], t[3]);
          mma(dq[2 * nj + 1], al, t[2], t[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + wr * 16 + g + 8 * i;
          float2* a = reinterpret_cast<float2*>(
              dQs + dq_at(r, wc * 32 + 8 * n + 2 * q));
          float2 v = *a;
          v.x += dq[n][2 * i];
          v.y += dq[n][2 * i + 1];
          *a = v;
        }
    }

    // this warp's dK, dV rows and dbias columns
    bf16* dkb = head_ptr<bf16>(p.dk, p.dk_s, b, h);
    bf16* dvb = head_ptr<bf16>(p.dv, p.dv_s, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = n0 + warp * 16 + g + 8 * i;
      float v = db[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (key >= Sk) continue;
      if (p.dbias && q == 0)
        p.dbias[static_cast<long long>(bh) * Sk + key] = v;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * q;
        *reinterpret_cast<__nv_bfloat162*>(dkb + key * p.dk_s[1] + c) =
            __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key * p.dv_s[1] + c) =
            __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
  __syncthreads();

  bf16* dqb = head_ptr<bf16>(p.dq, p.dq_s, b, h);
  for (int idx = threadIdx.x; idx < Sq * D / 2; idx += NT) {
    const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
    const float2 v = *reinterpret_cast<const float2*>(dQs + dq_at(r, c));
    *reinterpret_cast<__nv_bfloat162*>(dqb + r * p.dq_s[1] + c) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  auto kern = has_masks(p) ? flash_bwd_fused_tc<true>
                           : flash_bwd_fused_tc<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes(MAX_S));
  if (err != cudaSuccess) return err;
  const int bytes = tc_smem_bytes((p.Sq + QT - 1) / QT * QT);
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
  if (p->dtype == ptt::kBF16) return launch_tc(*p, s);
  return cudaErrorInvalidValue;
}
