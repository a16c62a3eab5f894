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
// elements of traffic, ~S/8 flop per byte: compute-bound.  Whole key
// tiles above the causal diagonal are skipped (attention.py:238-239).
//
// Two instantiations, one per dtype; a call without bias or segment ids
// (prefill, the BERT step) runs the MASKED = false variant of each,
// which compiles the mask operands out.
//
// bf16 (`flash_fwd_tc`, the BERT step): the tensor cores.  One CTA per
// (batch*head, 128-row query tile) of two consumer warpgroups (64 rows
// each) and one producer warp.  The producer loads Q once and each
// 64-key K and V tile through TMA (flash_tc.cuh: 4-D tensor maps over
// the view's strides, so BSHD, BHSD and the fused-QKV column slices all
// load without a copy; rows past S arrive as zeros) into a 2-stage ring
// of 128-byte-swizzled bf16 tiles guarded by full / empty mbarriers.
// Each consumer warpgroup computes S = Q K^T with wgmma m64n64k16 (Q and
// K from shared memory through descriptors), applies the masks and the
// online softmax to the f32 accumulator in registers (row max and sum
// reduce over the four lanes of a row), and adds P V with wgmma whose A
// operand is P itself, from registers, split into (hi, lo) bf16 halves
// (two wgmmas, flash_tc.cuh's numerical contract) and whose B operand
// is the V tile, MN-major through the descriptor's transpose bit.  A
// tile that no mask reaches takes a straight-line softmax (scale, max,
// __expf) with no per-element tests: per-element branches (BSSY / BSYNC
// around each exponential) cost more than the tensor-core work.  A
// warpgroup runs its two products and its softmax in turn; the overlap
// comes from the other warpgroups on the SM (two CTAs of two at D = 64,
// 96 registers a thread, which spills: ptxas reports 40 bytes of spill
// stores and 52 of loads, 100 and 124 when MASKED; starting S_{j+1}
// before the softmax of S_j in one warpgroup needs more registers and
// ran slower at one CTA an SM).
// Shared memory: Q 16 KB and two stages of K and V, 32 KB (D = 64;
// twice that at D = 128).
//
// f32 (`flash_fwd_kernel`, the engine's prefill): plain f32 FMA from
// shared memory (the card's 67 TFLOP/s f32 rate), one CTA of 256 threads
// per (batch*head, 64-row query tile), the tile scheme of
// flash_common.cuh; the running (m, l) of a row live in the registers of
// the 16 threads that share it.  Shared memory, D = 64: Q, K, V and P
// tiles, 66,560 bytes, plus 768 bytes of mask operands.

#include "flash_common.cuh"
#include "flash_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

using namespace ptt::hopper;

constexpr int TC_BM = 128;    // query rows of a CTA: 2 consumer warpgroups
constexpr int TC_BN = 64;     // keys of a tile
constexpr int TC_STAGES = 2;  // of the K / V ring
constexpr int TC_NT = 288;    // 256 consumer threads + the producer warp
constexpr int TC_CONSUMER_WARPS = 8;

// Shared memory of the bf16 kernel: every tile is D / 64 chunks of
// [rows][64] bf16 (128-byte rows, swizzled by TMA), each chunk 1024-byte
// aligned; then the barriers (full[2], empty[2], Q).
template <int D>
struct TcSmem {
  static constexpr int Q_CHUNK = TC_BM * 128;
  static constexpr int KV_CHUNK = TC_BN * 128;
  static constexpr int KV_TILE = (D / 64) * KV_CHUNK;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + (D / 64) * Q_CHUNK;
  static constexpr int V_OFF = K_OFF + TC_STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 5 * 8;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};

__device__ __forceinline__ void zero_s(float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    fence_reg(s[i]);
  }
}
template <int D>
__device__ __forceinline__ void fence_o_frags(float (&o)[D / 2],
                                              uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_reg(hi[kk][i]);
      fence_reg(lo[kk][i]);
    }
}
__device__ __forceinline__ void fence_s(float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(s[i]);
}

// S += Q K^T of one warpgroup's 64 rows and a 64-key tile: D / 16 wgmmas
// along the head dim, Q and K K-major through their descriptors
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_m64n64k16(
        s, desc_sw128(q_base + c * TcSmem<D>::Q_CHUNK + off, 16, 1024),
        desc_sw128(k_base + c * TcSmem<D>::KV_CHUNK + off, 16, 1024));
  }
}

// O += P V over a 64-key tile: P's (hi, lo) register fragments, V
// MN-major (the descriptor's transpose bit), 16 keys a step
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < TC_BN / 16; ++kk) {
    const uint64_t dv =
        desc_sw128(v_base + kk * 16 * 128, TcSmem<D>::KV_CHUNK, 1024);
    wgmma_rs<D>(o, hi[kk], dv);
    wgmma_rs<D>(o, lo[kk], dv);
  }
}

// Masks and the online softmax of one score tile in the accumulator
// registers: s[4 t + e] is row rows[e / 2], key n0 + 8 t + 2 q + e % 2.
// Leaves P in s, updates (m, l) and returns the rescale of O in corr.
// A tile that no mask reaches (every key < Sk, both rows < Sq, below
// the causal diagonal) only scales, and its exponentials need no test
// for masked scores: each path is straight-line code.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const Params& p, int n0, const int (&rows)[2], int q,
    const float* brow, const int* kseg, const int (&qseg)[2],
    float (&m_i)[2], float (&l_i)[2], float (&corr)[2]) {
  const int Sq = p.Sq, Sk = p.Sk;
  float mx[2] = {NEG_INF, NEG_INF};
  const bool interior = !MASKED && n0 + TC_BN <= Sk && rows[1] < Sq &&
      (!p.causal || n0 + TC_BN - 1 <= rows[0] + (Sk - Sq));
  if (interior) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= p.scale;
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i % 4;
      const int col = n0 + 8 * (i / 4) + 2 * q + (e & 1);
      s[i] = score<MASKED>(s[i], p, rows[e / 2], col, brow, kseg, col, qseg,
                           e / 2);
      mx[e / 2] = fmaxf(mx[e / 2], s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m_i[i], mx[i]);
    corr[i] = expf(m_i[i] - mx[i]);
    m_i[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
  if (interior) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __expf(s[i] - m_i[(i / 2) & 1]);
      rs[(i / 2) & 1] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = prob(s[i], m_i[(i / 2) & 1]);
      rs[(i / 2) & 1] += s[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l_i[i] = l_i[i] * corr[i] + rs[i];
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(TC_NT, D == 64 ? 2 : 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p,
                 const MapOrder oq, const MapOrder ok, const MapOrder ov) {
  using SM = TcSmem<D>;
  constexpr int CH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (ptt::tcore::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + SM::BAR_OFF);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* qbar = empty + TC_STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int m0 = blockIdx.x * TC_BM;
  const int Sq = p.Sq, Sk = p.Sk;
  int n_end = Sk;
  if (p.causal) n_end = min(Sk, min(m0 + TC_BM, Sq) + (Sk - Sq));
  const int ntiles = n_end > 0 ? (n_end + TC_BN - 1) / TC_BN : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TC_CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == TC_CONSUMER_WARPS) {
    // the producer: Q once, then the K / V ring
    if (lane == 0) {
      mbar_expect_tx(qbar, CH * SM::Q_CHUNK);
      for (int c = 0; c < CH; ++c)
        tma_load(sm + SM::Q_OFF + c * SM::Q_CHUNK, &tq, qbar, oq, c * 64, m0,
                 h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % TC_STAGES, round = j / TC_STAGES;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * SM::KV_TILE);
        for (int c = 0; c < CH; ++c) {
          tma_load(sm + SM::K_OFF + st * SM::KV_TILE + c * SM::KV_CHUNK, &tk,
                   &full[st], ok, c * 64, j * TC_BN, h, b);
          tma_load(sm + SM::V_OFF + st * SM::KV_TILE + c * SM::KV_CHUNK, &tv,
                   &full[st], ov, c * 64, j * TC_BN, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg + 16 (warp % 4) + g (+ 8)
  const int wg = warp / 4, g = lane / 4, q = lane % 4;
  const int r_lo = m0 + wg * 64 + (warp % 4) * 16 + g;
  const int rows[2] = {r_lo, r_lo + 8};
  const float* brow = nullptr;
  const int* kseg = nullptr;
  int qseg[2] = {0, 0};
  if (MASKED) {
    if (p.bias) brow = p.bias + b * p.bias_sb + h * p.bias_sh;
    if (p.qseg) {
      kseg = p.kseg + static_cast<long long>(b) * Sk;
      for (int i = 0; i < 2; ++i)
        if (rows[i] < Sq) qseg[i] = p.qseg[static_cast<long long>(b) * Sq +
                                           rows[i]];
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f}, corr[2];
  const uint32_t q_base =
      ptt::tcore::smem_u32(sm + SM::Q_OFF) + wg * 64 * 128;
  const uint32_t k_ring = ptt::tcore::smem_u32(sm + SM::K_OFF);
  const uint32_t v_ring = ptt::tcore::smem_u32(sm + SM::V_OFF);

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % TC_STAGES;
    mbar_wait(&full[st], (j / TC_STAGES) & 1);
    float s[32];
    zero_s(s);
    wgmma_fence();
    wgmma_qk<D>(s, q_base, k_ring + st * SM::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_s(s);
    softmax_tile<MASKED>(s, p, j * TC_BN, rows, q, brow, kseg, qseg, m_i,
                         l_i, corr);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      o[i] *= corr[(i / 2) & 1];
      fence_reg(o[i]);
    }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk)
      c_to_a(&s[8 * kk], &s[8 * kk + 4], hi[kk], lo[kk]);
    wgmma_fence();
    wgmma_pv<D>(o, hi, lo, v_ring + st * SM::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o_frags<D>(o, hi, lo);
    if (lane == 0) mbar_arrive(&empty[st]);  // K_j and V_j are read
  }

  // o[4 t + e]: row rows[e / 2], column 8 t + 2 q + e % 2
  __nv_bfloat16* ob = head_ptr<__nv_bfloat16>(p.o, p.o_s, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= Sq) continue;
    const bool dead = m_i[i] <= NEG_INF / 2;
    const float inv = dead ? 0.f : 1.f / (l_i[i] == 0.f ? 1.f : l_i[i]);
    __nv_bfloat16* orow = ob + row * p.o_s[1];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t + 2 * q) =
          __floats2bfloat162_rn(o[4 * t + 2 * i] * inv,
                                o[4 * t + 2 * i + 1] * inv);
    if (p.lse && q == 0)
      p.lse[static_cast<long long>(bh) * Sq + row] =
          dead ? NEG_INF : m_i[i] + logf(l_i[i] == 0.f ? 1.f : l_i[i]);
  }
}

template <int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  MapOrder oq, ok, ov;
  if (!encode_map(&tq, &oq, p.q, p.q_s, p.B, p.Sq, p.H, D, TC_BM) ||
      !encode_map(&tk, &ok, p.k, p.k_s, p.B, p.Sk, p.H, D, TC_BN) ||
      !encode_map(&tv, &ov, p.v, p.v_s, p.B, p.Sk, p.H, D, TC_BN))
    return cudaErrorInvalidValue;
  auto kern = has_masks(p) ? flash_fwd_tc<D, true> : flash_fwd_tc<D, false>;
  constexpr int bytes = TcSmem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + TC_BM - 1) / TC_BM, p.B * p.H);
  kern<<<grid, TC_NT, bytes, stream>>>(tq, tk, tv, p, oq, ok, ov);
  return cudaGetLastError();
}

}  // namespace

// The forward: O (and LSE when p->lse is set) from Q, K, V and the
// optional bias / segment ids of *p.
extern "C" int flash_fwd(const ptt::flash::Params* p, void* stream) {
  if (p->Sq <= 0 || p->B * p->H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == ptt::kF32 && p->D == 64) return launch<float, 64>(*p, s);
  if (p->dtype == ptt::kF32 && p->D == 128) return launch<float, 128>(*p, s);
  if (p->dtype == ptt::kBF16 && p->D == 64) return launch_tc<64>(*p, s);
  if (p->dtype == ptt::kBF16 && p->D == 128) return launch_tc<128>(*p, s);
  return cudaErrorInvalidValue;
}
