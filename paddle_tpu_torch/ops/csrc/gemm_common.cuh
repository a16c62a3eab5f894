// The GEMM scheme shared by the fused-epilogue matmul kernels
// (matmul_bias_act.cu, matmul_bwd.cu) and the 1x1-conv + BN kernels
// (conv_bn_relu.cu, conv_bn_stats.cu): one templated tile GEMM
//
//   C[r][c] = sum_k A(r, k) B(c, k)        (f32 accumulation)
//
// in three modes over the port's weight layout w [N, K] (nn.Linear's):
//
//   mode  C          A(r, k)                  B(c, k)     contraction
//   kFwd  y  [M, N]  x[r][k]     (K-major)    w[c][k]     K  (K-major)
//   kDx   dx [M, K]  dZ[r][k]    (K-major)    w[k][c]     N  (MN-major)
//   kDw   dw [N, K]  dZ[k][r]    (MN-major)   x[k][c]     M  (MN-major)
//
// "K-major": the contraction index is the contiguous one; "MN-major":
// the output index is.  dZ = dY * act'(residual) is formed on chip from
// the dY and residual tiles (the residual is z for gelu, y for relu and
// tanh, absent for none) and never written to device memory.  The
// forward adds the f32 bias and applies the activation to the f32
// accumulator before its one writeback, and optionally writes z; with
// the kBnRelu epilogue it applies max(acc * scale[c] + shift[c], 0)
// instead (the folded eval-mode BatchNorm and relu, f32); with the
// kStats epilogue it stores the accumulator as it is and writes the
// CTA's per-column (mean, M2) of its valid rows of the f32 accumulator,
// the tile's mean first and then the squares about it (two passes over
// the registers, so no sum of squares cancels), to a partials buffer
// that a second launch merges (conv_bn_stats.cu).  The
// dW mode also sums dZ over M into dbias in the CTAs of column tile 0
// (every M tile of a row tile passes through the same CTA, so no
// atomics and no second pass: deterministic), as the reference sums it
// in its kb == 0 sweep (paddle_tpu/ops/pallas/matmul.py:322-333).
//
// Two kernels per mode:
// * bf16 (`tc::gemm_bf16`): tensor cores, mma.sync.m16n8k16 bf16 -> f32.
//   CTA tile 128 x 128 x 32, 8 warps of 64 x 32, a cp.async ring of
//   shared tiles padded against bank conflicts ([128][40] K-major,
//   [32][136] MN-major), 3 stages in the forward and 2 in dX / dW (whose
//   shared memory also holds the dZ tile and a gelu-derivative table, and
//   two CTAs must fit an SM).  Fragments come from ldmatrix: K-major operands
//   plain, MN-major operands with ldmatrix.trans, which is how the forward
//   reads both x and w along K, dX reads w [N, K] transposed, and dW reads
//   dZ and x transposed.  In the dX / dW modes the 256 threads turn each
//   stage's dY and residual tiles into one shared dZ tile (rounded to
//   bf16 for the tensor cores; the dbias sum takes the f32 value) before
//   the warps multiply; gelu's derivative comes from a table of every
//   bf16 z in range (`build_table`).  Ragged M, N, K edges load as zeros
//   (cp.async zero-fill; a zero dY gives a zero dZ) and are not stored;
//   16-byte loads need K and N to be multiples of 8.
// * f32 (`simt::gemm_f32`): exact f32 FMA (no TF32), 64 x 64 x 16 tiles of
//   shared memory, 4 x 4 outputs a thread, dZ formed as the A tile is
//   stored; any shape.
//
// What is left for later (measured on the H100 at the BERT FFN shape,
// PERF.md): the mainloop runs at about a third of cuBLAS's rate on the
// same products, so wgmma + TMA with warp specialisation; forming dZ
// doubles the time of dX (each of the K / 128 column CTAs forms the same
// dZ tile again, and its lookups and tile traffic load shared memory);
// split-M for the dW grid (N/128 x K/128 = 144 CTAs, barely one wave of
// 132 SMs); a shared staging of the output tile for full-line stores.
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
  const void* a;      // A: x (kFwd) or dY (kDx, kDw)
  const void* res;    // residual (z or y), same layout as dY; or null
  const void* b;      // B: w (kFwd, kDx) or x (kDw)
  void* c;            // y, dx or dw
  void* z;            // kFwd: the pre-activation output, or null
  const void* bias;   // kFwd: [N] or null
  const float* scale; // kFwd with kBnRelu: [N] f32
  const float* shift; // kFwd with kBnRelu: [N] f32
  void* dbias;        // kDw: [N] or null
  float* stats;       // kFwd with kStats: [2][row tiles][N] f32 partials,
                      // the tiles' means, then their M2s
  int rows, cols, depth;   // output rows / cols, contraction length
  long long lda, ldb, ldc;
  int bias_dtype;     // DType of bias / dbias
};

template <int MODE>
struct Geo {
  static constexpr bool A_KM = MODE != kDw;   // A read K-major
  static constexpr bool B_KM = MODE == kFwd;  // B read K-major
  static constexpr bool DZ = MODE != kFwd;    // A is dZ from dY, residual
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

// The shared epilogue of both kernels for two neighbouring outputs
// (r, c), (r, c + 1): bias, z and activation in the forward (or the
// BN affine + relu), a plain store otherwise.
template <typename T, int MODE, int ACT>
__device__ __forceinline__ void epilogue2(const Args& p, int r, int c,
                                          float v0, float v1) {
  const long long o = static_cast<long long>(r) * p.ldc + c;
  if (MODE == kFwd && ACT == kBnRelu) {
    v0 = bn_relu(p, c, v0);
    v1 = bn_relu(p, c + 1, v1);
  } else if (MODE == kFwd) {
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
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int KM_LD = BK + 8;     // K-major tile [128][40]
constexpr int MN_LD = BM + 8;     // MN-major tile [32][136]
constexpr int TILE = BM * KM_LD;  // elements of one tile buffer
static_assert(BK * MN_LD <= TILE, "an MN-major tile fits a buffer");
static_assert(BM == BN, "one tile geometry for A and B");

// The gelu derivative of every bf16 z with 2^-16 <= |z| < 2^4 (20
// binades x 128 mantissas x 2 signs), built in shared memory by each CTA
// of the dX / dW kernels from the same act_bwd, so a table entry times
// dY is the value act_bwd would give.  It replaces the erf and exp of
// each dZ element by one lookup; z outside the range (0.002% of a
// N(0, 0.55^2) pre-activation falls below it) takes act_bwd itself.  At
// the BERT FFN shape on the H100 it took dX from 1.47 to 1.35 ms and dW
// from 2.75 to 2.16 ms (chip_smoke.py's matmul_main_shape); its 20 KB
// take the place of a third cp.async stage, so that two CTAs still fit
// an SM.
constexpr int TAB_BINADES = 20;
constexpr int TAB_LO = (127 + 4 - TAB_BINADES) << 7;  // bits of 2^(4 - binades)
constexpr int TAB_HALF = TAB_BINADES * 128;
constexpr int TAB_SIZE = 2 * TAB_HALF;

template <int ACT>
__host__ __device__ constexpr bool has_table() {
  return ACT == kGelu || ACT == kGeluTanh;
}

template <int MODE>
__host__ __device__ constexpr int stages() {  // of the cp.async ring
  return Geo<MODE>::DZ ? 2 : 3;
}

template <int MODE>
__host__ __device__ constexpr int stage_tiles() {  // A (R), B
  return Geo<MODE>::DZ ? 3 : 2;
}

// the cp.async ring, the dZ tile, and the derivative table
template <int MODE, int ACT>
__host__ __device__ constexpr int smem_bytes() {
  return (stages<MODE>() * stage_tiles<MODE>() + (Geo<MODE>::DZ ? 1 : 0)) *
             TILE * static_cast<int>(sizeof(__nv_bfloat16)) +
         (Geo<MODE>::DZ && has_table<ACT>() ? TAB_SIZE * 4 : 0);
}

template <int ACT>
__device__ __forceinline__ void build_table(float* tab) {
  for (int i = threadIdx.x; i < TAB_SIZE; i += NT) {
    const int bits = (i / TAB_HALF) << 15 | (TAB_LO + i % TAB_HALF);
    tab[i] = act_bwd<ACT>(
        1.f, __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits))));
  }
}

// dZ of one element from dY (f32) and the bf16 residual
template <int ACT>
__device__ __forceinline__ float dz_of(float g, __nv_bfloat16 r,
                                       const float* tab) {
  if (has_table<ACT>()) {
    const unsigned short bits = __bfloat16_as_ushort(r);
    const unsigned u = static_cast<unsigned>((bits & 0x7FFF) - TAB_LO);
    if (u < TAB_HALF) return g * tab[(bits >> 15) * TAB_HALF + u];
  }
  return act_bwd<ACT>(g, __bfloat162float(r));
}

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

// Thread's 16-byte chunk i of a tile: its shared offset and its (row,
// k) in the tile.  K-major [128][BK]: 4 chunks a row; MN-major [BK][128]:
// 16 chunks a contraction row.
template <bool KM>
__device__ __forceinline__ void chunk(int id, int& off, int& r, int& k) {
  if (KM) {
    r = id >> 2;
    k = (id & 3) * 8;
    off = r * KM_LD + k;
  } else {
    k = id >> 4;
    r = (id & 15) * 8;
    off = k * MN_LD + r;
  }
}

// One operand tile of rows [r0, r0 + 128) and contraction [k0, k0 + BK)
template <bool KM>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          long long ld, int r0, int rlim,
                                          int k0, int klim) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int off, r, k;
    chunk<KM>(threadIdx.x + i * NT, off, r, k);
    const int gr = r0 + r, gk = k0 + k;
    const bool ok = gr < rlim && gk < klim;
    const long long o = KM ? gr * ld + gk : gk * ld + gr;
    cp_async16(s + off, ok ? g + o : g, ok);
  }
}

// dZ tile from a stage's dY and residual tiles.  In kDw (MN-major) a
// thread always holds the same 8 output rows (tid & 15), so `bsum`
// carries their f32 column sums of dZ across the whole M loop.
template <bool KM, int ACT>
__device__ __forceinline__ void make_dz(__nv_bfloat16* dz,
                                        const __nv_bfloat16* g,
                                        const __nv_bfloat16* res,
                                        const float* tab, float (&bsum)[8],
                                        bool sum) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int off, r, k;
    chunk<KM>(threadIdx.x + i * NT, off, r, k);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + off);
    uint4 rv = make_uint4(0, 0, 0, 0);
    if (ACT != kNone) rv = *reinterpret_cast<const uint4*>(res + off);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat16* r1 = reinterpret_cast<const __nv_bfloat16*>(&rv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(g2[j]);
      const float d0 = dz_of<ACT>(gf.x, r1[2 * j], tab);
      const float d1 = dz_of<ACT>(gf.y, r1[2 * j + 1], tab);
      if (sum) {
        bsum[2 * j] += d0;
        bsum[2 * j + 1] += d1;
      }
      o2[j] = __floats2bfloat162_rn(d0, d1);
    }
    *reinterpret_cast<uint4*>(dz + off) = ov;
  }
}

// One BK slice of the CTA tile: warp (wr, wc) owns rows wr*64 .. +64 and
// columns wc*32 .. +32, i.e. 4 x 4 mma tiles of 16 x 8.
template <bool A_KM, bool B_KM>
__device__ __forceinline__ void mma_slice(const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs,
                                          float (&acc)[4][4][4], int wr,
                                          int wc, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r0 = wr * 64 + mi * 16;
      if (A_KM)
        ldsm_x4(a[mi], As + (r0 + (lane & 15)) * KM_LD + kk + (lane >> 4) * 8);
      else
        ldsm_x4_t(a[mi], As + (kk + (lane & 7) + (lane >> 4) * 8) * MN_LD +
                             r0 + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int c0 = wc * 32 + nj * 16;
      uint32_t t[4];
      if (B_KM)
        ldsm_x4(t, Bs + (c0 + (lane & 7) + (lane >> 4) * 8) * KM_LD + kk +
                       ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(t, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * MN_LD +
                         c0 + (lane >> 4) * 8);
      b[2 * nj][0] = t[0];
      b[2 * nj][1] = t[1];
      b[2 * nj + 1][0] = t[2];
      b[2 * nj + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// kStats: partial (mean, M2) of each column over the CTA's valid rows,
// written at row tile blockIdx.y.  Column c's 128 rows lie in 16
// threads (warp row wr, lane group g; 8 rows each), whose sums meet in
// shared memory and are added in a fixed order: deterministic.
__device__ __forceinline__ void tile_stats(const Args& p,
                                           const float (&acc)[4][4][4],
                                           unsigned char* smem_raw, int row0,
                                           int col0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, q = lane & 3;
  const int nrows = min(BM, p.rows - row0);
  float* red = reinterpret_cast<float*>(smem_raw);  // [16][BN]
  float* mean = red + 16 * BN;                      // [BN]
  __syncthreads();  // every warp is done with the operand ring
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // the sum, then the squares
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc * 32 + ni * 8 + q * 2 + j;
        const float m = pass ? mean[c] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (wr * 64 + mi * 16 + g + h * 8 < nrows) {
              const float d = acc[mi][ni][2 * h + j] - m;
              s += pass ? d * d : d;
            }
        red[(wr * 8 + g) * BN + c] = s;
      }
    __syncthreads();
    if (tid < BN) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) t += red[i * BN + tid];
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

template <int MODE, int ACT>
__device__ __forceinline__ void gemm_bf16(const Args& p) {
  using G = Geo<MODE>;
  constexpr int ST = stage_tiles<MODE>();
  constexpr int STAGES = stages<MODE>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dzbuf = smem + STAGES * ST * TILE;
  float* tab = reinterpret_cast<float*>(dzbuf + TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const auto* A = static_cast<const __nv_bfloat16*>(p.a);
  const auto* R = static_cast<const __nv_bfloat16*>(p.res);
  const auto* B = static_cast<const __nv_bfloat16*>(p.b);
  const int nk = (p.depth + BK - 1) / BK;
  const bool sum = MODE == kDw && p.dbias != nullptr && blockIdx.x == 0;

  auto load_stage = [&](int kt) {
    __nv_bfloat16* s = smem + (kt % STAGES) * ST * TILE;
    const int k0 = kt * BK;
    load_tile<G::A_KM>(s, A, p.lda, row0, p.rows, k0, p.depth);
    if (G::DZ && ACT != kNone)
      load_tile<G::A_KM>(s + TILE, R, p.lda, row0, p.rows, k0, p.depth);
    load_tile<G::B_KM>(s + (ST - 1) * TILE, B, p.ldb, col0, p.cols, k0,
                       p.depth);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float bsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bsum[j] = 0.f;

#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) load_stage(kt);
    cp_async_commit();
  }
  if (G::DZ && has_table<ACT>()) build_table<ACT>(tab);  // read after a sync
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* s = smem + (kt % STAGES) * ST * TILE;
    const __nv_bfloat16* As = s;
    if (G::DZ) {
      make_dz<G::A_KM, ACT>(dzbuf, s, s + TILE, tab, bsum, sum);
      __syncthreads();
      As = dzbuf;
    }
    mma_slice<G::A_KM, G::B_KM>(As, s + (ST - 1) * TILE, acc, wr, wc, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wr * 64 + mi * 16 + g + h * 8;
        const int c = col0 + wc * 32 + ni * 8 + q * 2;
        if (r < p.rows && c < p.cols)
          epilogue2<__nv_bfloat16, MODE, ACT>(p, r, c, acc[mi][ni][2 * h],
                                              acc[mi][ni][2 * h + 1]);
      }
  if constexpr (MODE == kFwd && ACT == kStats)
    tile_stats(p, acc, smem_raw, row0, col0);

  if (sum) {  // uniform over the CTA
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);  // [16][BM]
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(tid >> 4) * BM + (tid & 15) * 8 + j] = bsum[j];
    __syncthreads();
    if (tid < BM && row0 + tid < p.rows) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) s += red[i * BM + tid];
      store_vec(p.dbias, p.bias_dtype, row0 + tid, s);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: exact FMA
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64, BK = 16, NT = 256, LD = BM + 4;

// kStats, as tc::tile_stats: column c's 64 rows lie in the 16 threads
// of one tx (4 rows each); `red` and `mean` reuse the operand tiles,
// which the mainloop's last barrier has freed.
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

template <int MODE, int ACT>
__device__ __forceinline__ void gemm_f32(const Args& p) {
  using G = Geo<MODE>;
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];
  __shared__ float red[NT / BM][BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  const auto* A = static_cast<const float*>(p.a);
  const auto* R = static_cast<const float*>(p.res);
  const auto* B = static_cast<const float*>(p.b);
  const bool sum = MODE == kDw && p.dbias != nullptr && blockIdx.x == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;  // kDw: the row tid & 63 of every A tile

  for (int k0 = 0; k0 < p.depth; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int id = tid + i * NT;
      const int r = G::A_KM ? id >> 4 : id & 63;
      const int k = G::A_KM ? id & 15 : id >> 6;
      const int gr = row0 + r, gk = k0 + k;
      float v = 0.f;
      if (gr < p.rows && gk < p.depth) {
        const long long o = G::A_KM ? gr * p.lda + gk : gk * p.lda + gr;
        v = G::DZ ? act_bwd<ACT>(A[o], ACT == kNone ? 0.f : R[o]) : A[o];
      }
      As[k][r] = v;
      bsum += v;
    }
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int id = tid + i * NT;
      const int c = G::B_KM ? id >> 4 : id & 63;
      const int k = G::B_KM ? id & 15 : id >> 6;
      const int gc = col0 + c, gk = k0 + k;
      float v = 0.f;
      if (gc < p.cols && gk < p.depth)
        v = B[G::B_KM ? gc * p.ldb + gk : gk * p.ldb + gc];
      Bs[k][c] = v;
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
        epilogue2<float, MODE, ACT>(p, r, c, acc[i][j], acc[i][j + 1]);
      } else if (c < p.cols) {  // an odd last column
        float v = acc[i][j];
        if (MODE == kFwd && ACT == kBnRelu) {
          v = bn_relu(p, c, v);
        } else if (MODE == kFwd) {
          if (p.bias) v += load_vec(p.bias, p.bias_dtype, c);
          if (p.z) static_cast<float*>(p.z)[static_cast<long long>(r) * p.ldc + c] = v;
          v = act_fwd<ACT>(v);
        }
        static_cast<float*>(p.c)[static_cast<long long>(r) * p.ldc + c] = v;
      }
    }
  }
  if constexpr (MODE == kFwd && ACT == kStats)
    tile_stats(p, acc, As, &Bs[0][0], row0, col0);

  if (sum) {  // uniform over the CTA
    red[tid / BM][tid % BM] = bsum;
    __syncthreads();
    if (tid < BM && row0 + tid < p.rows) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NT / BM; ++i) s += red[i][tid];
      store_vec(p.dbias, p.bias_dtype, row0 + tid, s);
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One kernel name per mode and dtype, so a profile bills each on its own
// (chip_smoke.py's KERNEL_CATEGORIES).
#define PTT_GEMM_KERNELS(MODE, NAME)                                  \
  template <int ACT>                                                  \
  __global__ void __launch_bounds__(tc::NT, 2) NAME##_bf16(const Args p) { \
    tc::gemm_bf16<MODE, ACT>(p);                                      \
  }                                                                   \
  template <int ACT>                                                  \
  __global__ void __launch_bounds__(simt::NT) NAME##_f32(const Args p) {   \
    simt::gemm_f32<MODE, ACT>(p);                                     \
  }
PTT_GEMM_KERNELS(kFwd, matmul_fwd)
PTT_GEMM_KERNELS(kDx, matmul_dx)
PTT_GEMM_KERNELS(kDw, matmul_dw)
PTT_GEMM_KERNELS(kFwd, conv_bn_relu)
PTT_GEMM_KERNELS(kFwd, conv_bn_stats)
#undef PTT_GEMM_KERNELS

// the kernels of one mode only, so each library instantiates its own
template <int MODE, int ACT>
auto bf16_kernel() {
  if constexpr (MODE == kFwd && ACT == kBnRelu) return conv_bn_relu_bf16<ACT>;
  else if constexpr (MODE == kFwd && ACT == kStats) return conv_bn_stats_bf16<ACT>;
  else if constexpr (MODE == kFwd) return matmul_fwd_bf16<ACT>;
  else if constexpr (MODE == kDx) return matmul_dx_bf16<ACT>;
  else return matmul_dw_bf16<ACT>;
}
template <int MODE, int ACT>
auto f32_kernel() {
  if constexpr (MODE == kFwd && ACT == kBnRelu) return conv_bn_relu_f32<ACT>;
  else if constexpr (MODE == kFwd && ACT == kStats) return conv_bn_stats_f32<ACT>;
  else if constexpr (MODE == kFwd) return matmul_fwd_f32<ACT>;
  else if constexpr (MODE == kDx) return matmul_dx_f32<ACT>;
  else return matmul_dw_f32<ACT>;
}

template <int MODE, int ACT>
cudaError_t launch_act(const Args& p, int dtype, cudaStream_t stream) {
  if (dtype == kBF16) {
    auto kern = bf16_kernel<MODE, ACT>();
    constexpr int bytes = tc::smem_bytes<MODE, ACT>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.cols + tc::BN - 1) / tc::BN, (p.rows + tc::BM - 1) / tc::BM);
    kern<<<grid, tc::NT, bytes, stream>>>(p);
  } else {
    auto kern = f32_kernel<MODE, ACT>();
    dim3 grid((p.cols + simt::BM - 1) / simt::BM,
              (p.rows + simt::BM - 1) / simt::BM);
    kern<<<grid, simt::NT, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Args& p, int act, int dtype, cudaStream_t stream) {
  switch (act) {
    case kNone: return launch_act<MODE, kNone>(p, dtype, stream);
    case kRelu: return launch_act<MODE, kRelu>(p, dtype, stream);
    case kTanh: return launch_act<MODE, kTanh>(p, dtype, stream);
    case kGelu: return launch_act<MODE, kGelu>(p, dtype, stream);
    case kGeluTanh: return launch_act<MODE, kGeluTanh>(p, dtype, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace ptt
