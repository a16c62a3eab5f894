// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_bwd_fused.cu): the parameter block the Python
// wrapper fills (ops/attention.py `FlashParams` mirrors it field for
// field), the tile shape, tile loads from strided (batch, seq, head)
// views, the score mask, and the register-tile products of the f32 FMA
// kernels.
//
// Tile scheme of the FMA kernels (the f32 forward, fused backward and
// dQ + dK/dV pair; the bf16 kernels run on the tensor cores,
// flash_tc.cuh, and share only the parameter block, the masks and the
// row statistics here): 256 threads
// as a 16 x 16 grid (ty, tx).  A 64 x 64 score tile is owned as 4 x 4
// registers per thread: rows ty + 16 i, columns tx + 16 j.  A 64 x D
// output tile is owned as rows ty + 16 i, columns tx + 16 c (c < D /
// 16).  Operand tiles are staged in shared memory as f32 with rows
// padded by one word against bank conflicts.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int BM = 64;   // rows of a query tile
constexpr int BN = 64;   // rows of a key tile
constexpr int NT = 256;  // threads per CTA
constexpr int LP = BN + 1;

// Mirrored by ops/attention.py `FlashParams`: keep the two in step.
// Pointers the call does not use are null.  Strides are element strides
// of (batch, seq, head); the head dim has unit stride.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // forward: output; backward: the saved output
  const void* dout;  // backward: dO
  void* dq;
  void* dk;
  void* dv;
  float* lse;        // [B*H, Sq]: forward writes (optional), backward reads
  float* delta;      // [B*H, Sq]: rowsum(dO * O), dQ writes, dK/dV reads
  float* dbias;      // [B*H, Sk] f32, or null when the bias needs no grad
  const float* bias; // additive row bias, [B, Hb, Sk] through bias_sb/sh
  const int* qseg;   // [B, Sq] segment ids (with kseg, or both null)
  const int* kseg;   // [B, Sk]
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3],
      dv_s[3];
  long long bias_sb, bias_sh;
  int B, H, Sq, Sk, D, causal, dtype;
  float scale;
};

// Base pointer of (batch b, head h) in a strided (batch, seq, head) view.
template <typename T>
__device__ __forceinline__ T* head_ptr(const void* base, const long long* s,
                                       int b, int h) {
  return static_cast<T*>(const_cast<void*>(base)) + b * s[0] + h * s[2];
}

// Rows [row0, row0 + 64) of a [S, D] slice with seq stride `ss` into an
// f32 [64][D + 1] shared tile; rows at or past S read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int S) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < S ? to_f(src[row * ss + c]) : 0.f;
  }
}

// The same rows of two [S, D] slices (K and V, or Q and dO) in one
// loop, so each thread has both loads in flight.
template <typename T, int D>
__device__ __forceinline__ void load_tile_pair(float* dst_a, const T* src_a,
                                               long long ss_a, float* dst_b,
                                               const T* src_b, long long ss_b,
                                               int row0, int S) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    const bool ok = row < S;
    dst_a[r * LD + c] = ok ? to_f(src_a[row * ss_a + c]) : 0.f;
    dst_b[r * LD + c] = ok ? to_f(src_b[row * ss_b + c]) : 0.f;
  }
}

// The per-key-tile mask operands (bias row and key segment ids) and the
// per-query-tile segment ids, staged in shared memory.
__device__ __forceinline__ void load_key_masks(float* bias_s, int* kseg_s,
                                               const Params& p, int b, int h,
                                               int n0, int rows = BN) {
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int col = n0 + r;
    const bool ok = col < p.Sk;
    if (p.bias)
      bias_s[r] = ok ? p.bias[b * p.bias_sb + h * p.bias_sh + col] : 0.f;
    if (p.kseg) kseg_s[r] = ok ? p.kseg[b * p.Sk + col] : 0;
  }
}

__device__ __forceinline__ void load_query_segs(int* qseg_s, const Params& p,
                                                int b, int m0, int rows) {
  if (!p.qseg) return;
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int row = m0 + r;
    qseg_s[r] = row < p.Sq ? p.qseg[b * p.Sq + row] : 0;
  }
}

// The masked, scaled score of (query row, key col), as
// `attention.py:_apply_masks` builds it: bias added, then segment,
// causal (bottom-right, coff = Sk - Sq) and range masks to NEG_INF.
// `kc` and `qr` index the key and query mask operands, staged tiles or
// (the bf16 forward) global rows; they are read only for a (row, col)
// inside (Sq, Sk).  A row at or past Sq is masked too, so the backward's
// padded rows get P = 0.
//
// MASKED is a template flag, true when the call has a bias or segment
// ids: the kernels are instantiated both ways and the launcher picks
// (`has_masks`).  Checking the two pointers at run time in every score
// made the unmasked calls (prefill, the BERT step) markedly slower.
template <bool MASKED>
__device__ __forceinline__ float score(float dot, const Params& p, int row,
                                       int col, const float* bias_s,
                                       const int* kseg_s, int kc,
                                       const int* qseg_s, int qr) {
  float s = dot * p.scale;
  bool ok = row < p.Sq && col < p.Sk;
  if (MASKED && ok) {
    if (p.bias) s += bias_s[kc];
    if (p.qseg) ok = ok && qseg_s[qr] == kseg_s[kc];
  }
  if (p.causal) ok = ok && col <= row + (p.Sk - p.Sq);
  return ok ? s : NEG_INF;
}

// P = exp(s - lse), exactly zero where s was masked: a dead row has
// lse = NEG_INF and must not resurrect p = 1 (attention.py:373-375).
__device__ __forceinline__ float prob(float s, float lse) {
  return s <= NEG_INF / 2 ? 0.f : expf(s - lse);
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, both [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* B) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_k P(ty + 16 i, k) * X[k][tx + 16 c] over a 64-deep k,
// with P read from the shared [64][LP] tile `Ps` as Ps[r][k] or, when
// TRANS, as Ps[k][r].
template <int D, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16],
                                         const float* Ps, const float* X) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = TRANS ? Ps[k * LP + ty + 16 * i] : Ps[(ty + 16 * i) * LP + k];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float xv = X[k * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], xv, acc[i][c]);
    }
  }
}

// rowsum(dO * O) of rows [m0, m0 + rows) into delta_s, one warp per row
// (dO and O read from global memory); rows past Sq get 0.
template <typename T, int D>
__device__ __forceinline__ void row_delta(float* delta_s, const T* ob,
                                          long long o_ss, const T* dob,
                                          long long do_ss, int m0, int rows,
                                          int Sq) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    const int row = m0 + r;
    float acc = 0.f;
    if (row < Sq)
      for (int c = lane; c < D; c += 32)
        acc += to_f(ob[row * o_ss + c]) * to_f(dob[row * do_ss + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta_s[r] = acc;
  }
}

// Stores a 64 x D register tile (rows ty + 16 i, cols tx + 16 c) to rows
// [r0, r0 + 64) of a strided [S, D] slice, skipping rows at or past S.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, long long ss, int r0,
                                           int S,
                                           const float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      store(&dst[row * ss + tx + 16 * c], acc[i][c]);
  }
}

// Whether a call has mask operands (the MASKED instantiation).
inline bool has_masks(const Params& p) {
  return p.bias != nullptr || p.qseg != nullptr;
}

// One query tile's share of a 64-row key tile's gradients, the step
// flash_bwd.cu's dK/dV kernel and flash_bwd_fused.cu share.  From the
// staged K, V, Q and dO tiles and the query rows' lse / delta / segment
// ids (indexed from the query tile's first row m0):
//   dV += P^T dO,  dK += scale * dS^T Q,  db += colsum(dS),
// leaving scale * dS^T in `Ps` for a dQ update.  The score tiles are
// transposed: register row a is key ty + 16 a, column j query tx + 16 j.
template <int D, bool MASKED>
__device__ __forceinline__ void key_tile_step(
    float (&dk)[4][D / 16], float (&dv)[4][D / 16], float (&db)[4],
    float* Ps, const float* Ks, const float* Vs, const float* Qs,
    const float* dOs, const float* lse_r, const float* delta_r,
    const int* qseg_r, const float* bias_s, const int* kseg_s,
    const Params& p, int m0, int n0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float st[4][4], dpt[4][4];
  dot_tile<D>(st, Ks, Qs);
  dot_tile<D>(dpt, Vs, dOs);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kr = ty + 16 * a;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = tx + 16 * j;
      const float sc = score<MASKED>(st[a][j], p, m0 + qr, n0 + kr, bias_s,
                                     kseg_s, kr, qseg_r, qr);
      const float pr = prob(sc, lse_r[qr]);
      const float ds = pr * (dpt[a][j] - delta_r[qr]);
      db[a] += ds;
      Ps[kr * LP + qr] = pr;
      dpt[a][j] = ds * p.scale;
    }
  }
  __syncthreads();
  acc_tile<D, false>(dv, Ps, dOs);
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(ty + 16 * a) * LP + tx + 16 * j] =
        dpt[a][j];
  __syncthreads();
  acc_tile<D, false>(dk, Ps, Qs);
}

// A key tile's dK and dV rows, and its dbias columns (the row sums of
// db across the 16 threads of a key row) when the call asks for them.
template <typename T, int D>
__device__ __forceinline__ void store_key_tile(
    const Params& p, int b, int h, int n0, const float (&dk)[4][D / 16],
    const float (&dv)[4][D / 16], const float (&db)[4]) {
  store_tile<T, D>(head_ptr<T>(p.dk, p.dk_s, b, h), p.dk_s[1], n0, p.Sk, dk);
  store_tile<T, D>(head_ptr<T>(p.dv, p.dv_s, b, h), p.dv_s[1], n0, p.Sk, dv);
  if (!p.dbias) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long base = static_cast<long long>(b * p.H + h) * p.Sk;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float v = db[a];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int col = n0 + ty + 16 * a;
    if (tx == 0 && col < p.Sk) p.dbias[base + col] = v;
  }
}

}  // namespace flash
}  // namespace ptt
