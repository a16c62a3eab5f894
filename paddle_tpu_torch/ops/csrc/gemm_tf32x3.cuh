// The f32 GEMM backward of the fused-epilogue matmul for Hopper (sm_90a):
// kernels 6 (dX) and 7 (dW + dbias) in f32, launched by matmul_bwd.cu,
// on the tensor cores with a 3xTF32 split.
//
// Replaces, in f32: paddle_tpu/ops/pallas/matmul.py:272 `_bwd_dx_kernel`
// (its pallas_call at :361) and :296 `_bwd_dw_kernel` (:405), the custom
// VJP of `_mba_core` (:429-443).  With dZ = dY * act'(residual) (the
// residual is z for gelu, y for relu and tanh, absent for none) and the
// port's w [N, K]:
//
//   kDx  dX [M, K] = dZ w      A(r, k) = dZ[r][k]   B(c, k) = w[k][c]
//   kDw  dW [N, K] = dZ^T x    A(r, k) = dZ[k][r]   B(c, k) = x[k][c]
//        dbias [N] = sum_M dZ
//
// What bounds it.  At the static BERT step's FFN (M = 4096, K = 768, N =
// 3072, gelu) each product is 2 M N K = 19.33 GFLOP: 0.2885 ms at the
// card's FMA rate (67 TFLOP/s), 0.117 ms as three TF32 products at 495
// TFLOP/s.  Its ~122 MB of traffic (dY, z, w or x, the output) takes
// 0.036 ms at 3.35 TB/s.  So the tensor cores bound it, with dZ's
// derivative (gelu: an erf and an exp) on the CUDA cores beside them.
//
// The split.  Each operand element a = hi + lo with hi = tf32(a) and lo
// = tf32(a - hi) (cvt.rna), so |a - hi - lo| <= 2^-22 |a|.  A product
// a b takes lo_a hi_b, then hi_a lo_b, then hi_a hi_b, each exact in f32
// (11 x 11 significant bits), and drops lo_a lo_b (2^-22 of it): three
// TF32 products keep about an f32 product's precision, where one (2^-11)
// misses chip_smoke.py's f32 limit (tests/test_torch_gemm_tf32x3.py).
//
// The accumulator.  The tensor cores add each product into the f32
// accumulator with a truncation, not a rounding: over this path's
// contractions (3072 for dX, 4096 for dW) that is some 1,100 biased
// steps, and unpromoted the outputs landed 2.2e-5 / 1.0e-5 of their
// scale from a float64 product (the plain cuBLAS version: 5.3e-7 /
// 4.9e-7; tools/gemm_tf32x3_probe.py on the H100).  So each k block's
// partial (32 contraction rows, 12 products) goes into a second f32
// register sum with FADD every PROMOTE k blocks (then 3.7e-7 / 3.4e-7),
// and the next block's first product starts the partial anew (wgmma's
// scale-d 0).
//
// Design: wgmma m64n128k8 tf32, 256 threads (two warpgroups of 64
// output rows), 128 x 128 outputs a CTA, 32 contraction rows a stage.
// * Why wgmma and not mma.sync: wgmma is the card's only path to the full
//   TF32 rate, and its A operand may come from registers, so dZ is formed
//   and split by the threads and never written to device memory.  TF32
//   operands in shared memory must be K-major (the transpose flags exist
//   for 16-bit types only), which B (w for dX, x for dW) is not in device
//   memory, and dW's A is not either.  B is split by the threads anyway,
//   so the transposition comes with the split; A is gathered element by
//   element from the raw tile.  mma.sync would reload every fragment from
//   shared memory in every warp each k step.
// * Loads: every operand tile is copied raw, as it lies in device memory,
//   into a ring of ST stages: by TMA when N and K are multiples of 4
//   floats (one thread issues a stage's boxes on its mbarrier), else by
//   4-byte cp.async into the same layout.  Both fill zeros past every
//   edge, so a ragged M, N or K takes no branch in the mainloop (a zero
//   dY gives a zero dZ).  The raw boxes are 128-byte swizzled, so the
//   gathers below meet distinct banks (kDw's A: 2-way).  TMA took 7-9% off
//   cp.async's 16-byte copies, whose address arithmetic the threads paid.
// * A (dZ): each thread forms the 16 elements of its four k steps'
//   fragments (rows g and g + 8 of its warp's 16, contraction q and q + 4
//   of each 8; g = lane / 4, q = lane % 4) from the raw dY and residual
//   with act_bwd, splits them into hi and lo and stages them in its own
//   slots of shared memory, read back into registers just before the
//   stage's wgmmas (holding a second register set made the compiler
//   serialise the derivative's work at 255 registers); in kDw it adds the
//   f32 dZ into its rows' dbias sums.  Each dZ element is formed once a
//   CTA: the derivative runs K / 128 times an element in all (6 at the
//   FFN).  Sharing the fragments between a cluster's two column tiles
//   halved that but cost more in cluster barriers (+11-14%, not kept).
// * B: the threads split the raw tile into hi and lo tiles, [128
//   columns][32 contraction] each, K-major with the 128-byte swizzle (the
//   layout the wgmma descriptors read): a lane takes four contraction rows
//   of one column and writes one 16-byte chunk of each.  Two buffers:
//   stage it + 1's are written while stage it's wgmmas read the other.
// * The k loop: stage it's 12 wgmmas are issued (lo_a hi_b, hi_a lo_b,
//   hi_a hi_b a k step), then, while they run, stage it + 2's loads are
//   issued, stage it + 1's B is split and its A fragments formed; then
//   the wgmmas are awaited and the partial promoted.  Two barriers a
//   stage.  At the FFN the threads' work (the gelu derivative most of
//   it) takes longer than the wgmmas, which run at ~60% of the TF32 rate
//   between the stage's drains.
// * Either mode may split its contraction into chunks of whole stages
//   (blockIdx.z; ops/matmul.py `dx_split_plan`, `dw_split_plan`: at the
//   FFN dX's 192 tiles are 1.45 waves of 132 SMs, dW's 144 1.09), whose
//   f32 partials a second launch adds up in split order
//   (`matmul_dx_merge_f32`, `matmul_dw_merge_f32`): no float atomics, so
//   two launches agree bit for bit.  dbias is summed by the CTAs of
//   column tile 0 from the f32 dZ, each thread over its rows in a fixed
//   order, then the four lanes of a row in a fixed order.
#pragma once

#include <type_traits>

#include "flash_tc.cuh"
#include "gemm_common.cuh"

// k blocks between promotions of the tensor cores' partial (a build of
// tools/gemm_tf32x3_probe.py may set it to measure the truncation)
#ifndef PTT_TF32X3_PROMOTE
#define PTT_TF32X3_PROMOTE 1
#endif

namespace ptt {
namespace gemm {
namespace x3 {

using namespace ::ptt::hopper;
using ::ptt::tcore::cp_async_commit;
using ::ptt::tcore::cp_async_wait;
using ::ptt::tcore::smem_u32;

constexpr int BM = 128;   // output rows of a CTA: two warpgroups of 64
constexpr int BN = 128;   // output columns of a CTA
constexpr int BK = 32;    // contraction rows of a stage (128 bytes of tf32)
constexpr int ST = 2;     // stages of the load ring
constexpr int NT = 256;
constexpr int PROMOTE = PTT_TF32X3_PROMOTE;
static_assert(PROMOTE >= 1, "promote every k block or fewer");

// Every raw tile is made of boxes of 128-byte rows (32 floats), 128-byte
// swizzled as TMA writes them: 16-byte chunk j of row r at chunk j ^ (r %
// 8).  A stage holds dY, the residual and B, 16 KB each: kDx's dY is one
// box [BM rows][32 contraction]; kDw's is four boxes [32 contraction][32
// rows], box b holding rows 32 b ..; B is four boxes [32 contraction][32
// columns] likewise.
constexpr int TILE_BYTES = BM * BK * 4;
constexpr int BOX_BYTES = 32 * 128;
constexpr int STAGE_BYTES = 3 * TILE_BYTES;
// Shared memory: the ring, two buffers of the split B (hi, then lo:
// [BN][128 bytes] each), the A fragments a thread formed for the next
// stage (its own 8 x 16 bytes, [8][NT] so a warp's 16-byte accesses are
// contiguous), the ring's barriers.
constexpr int SPLIT_BYTES = BN * BK * 4;
constexpr int SPLIT_OFF = ST * STAGE_BYTES;
constexpr int FRAG_OFF = SPLIT_OFF + 4 * SPLIT_BYTES;
constexpr int FRAG_VECS = 2 * BK / 8;  // uint4s a thread: hi, lo a k step
constexpr int BAR_OFF = FRAG_OFF + FRAG_VECS * NT * 16;
constexpr int SMEM_ALLOC = BAR_OFF + ST * 8 + 1024;
static_assert(SMEM_ALLOC <= 232448, "a CTA's shared memory");

struct Args {
  const float* g;    // dY [M, N]
  const float* res;  // the residual, as dY; null for act none
  const float* b;    // B: w [N, K] (kDx) or x [M, K] (kDw)
  float* out;        // dX [M, K] or dW [N, K]; or the partials [S][.][K]
  void* dbias;       // kDw: [N] in bias_dtype, or the partials [S][N] f32;
                     // null for none
  int M, N, K;
  int chunk;         // contraction rows of a split (a multiple of BK)
  int split;         // non-zero: write the partials of split blockIdx.z
  int bias_dtype;
  int tma;           // N and K multiples of 4 (16-byte rows): TMA loads;
                     // else 4-byte cp.async
};

// The byte offset of element (r, c) of a swizzled box of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// 4 bytes global -> shared, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(void* s, const void* g, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(ok ? 4 : 0));
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + 32 BOXES) of the row-major
// `src` (leading dimension ld) into BOXES swizzled boxes [ROWS][32] at
// dst, zero at rows >= nr or columns >= nc, 4 bytes a copy: the loads of
// a shape whose rows are not 16-byte aligned, where TMA cannot go.
template <int ROWS, int BOXES>
__device__ __forceinline__ void load_tile4(unsigned char* dst,
                                           const float* src, int ld, int r0,
                                           int c0, int nr, int nc) {
  static_assert(ROWS * 32 * BOXES % NT == 0, "whole rounds of the CTA");
#pragma unroll 4
  for (int i = 0; i < ROWS * 32 * BOXES / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int b = id / (ROWS * 32), r = id / 32 % ROWS, c = id % 32;
    const int gr = r0 + r, gc = c0 + 32 * b + c;
    const bool ok = gr < nr && gc < nc;
    cp_async4(dst + b * ROWS * 128 + swz(r, c),
              ok ? src + static_cast<long long>(gr) * ld + gc : src, ok);
  }
}

__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// A stage's raw B (four boxes [32 contraction][32 columns]) as the hi and
// lo tiles [BN columns][32 contraction], K-major, 128-byte swizzled (the
// layout a wgmma descriptor reads).  A warp's lanes take 32 neighbouring
// columns of one box: each read meets 8 chunks x 4 words, and each
// 8-lane phase of its 16-byte writes 8 distinct chunks.
__device__ __forceinline__ void split_b(const unsigned char* raw,
                                        unsigned char* hi, unsigned char* lo) {
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int c = id % BN, j = id / BN;  // column, 16-byte chunk
    const unsigned char* box = raw + (c >> 5) * BOX_BYTES;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(*reinterpret_cast<const float*>(box + swz(4 * j + e, c & 31)),
                 h[e], l[e]);
    const int off = c * 128 + ((j ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The byte offset of A element (row rr, contraction k) in a stage's raw dY
// (or residual) tile
template <int MODE>
__device__ __forceinline__ int a_off(int rr, int k) {
  return MODE == kDx ? swz(rr, k) : (rr >> 5) * BOX_BYTES + swz(k, rr & 31);
}

// The A fragments (hi, lo) of a stage's four k steps for the thread whose
// first row is r (its warp's row g) and contraction column q, into its
// staging slots `fs` (fs[s * NT] the hi fragment of k step s, fs[(BK / 8
// + s) * NT] the lo one): fragment element j of k step s is row r + 8 (j
// & 1), contraction 8 s + q + 4 (j >> 1) (wgmma's tf32 register layout).
// With `sum`, the f32 dZ of rows r and r + 8 is added into bs[0], bs[1].
template <int MODE, int ACT>
__device__ __forceinline__ void form_a(const unsigned char* st, int r, int q,
                                       bool sum, uint4* fs, float (&bs)[2]) {
  const unsigned char* res = st + TILE_BYTES;
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = a_off<MODE>(r + 8 * (j & 1), 8 * s + q + 4 * (j >> 1));
      const float d = act_bwd<ACT>(
          *reinterpret_cast<const float*>(st + o),
          ACT == kNone ? 0.f : *reinterpret_cast<const float*>(res + o));
      if (sum) bs[j & 1] += d;
      split_tf32(d, hi[j], lo[j]);
    }
    fs[s * NT] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    fs[(BK / 8 + s) * NT] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// d[64] (+)= A (64 x 8, registers) * B (8 x 128, shared, K-major), tf32;
// scale_d 0: d = A B, the accumulator's old value ignored
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_frags(uint32_t (&hi)[BK / 8][4],
                                            uint32_t (&lo)[BK / 8][4]) {
#pragma unroll
  for (int s = 0; s < BK / 8; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_reg(hi[s][j]);
      fence_reg(lo[s][j]);
    }
}

template <int MODE, int ACT>
__device__ __forceinline__ void bwd_x3(const CUtensorMap& tg,
                                       const CUtensorMap& tr,
                                       const CUtensorMap& tb, const Args& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint4* fs = reinterpret_cast<uint4*>(sm + FRAG_OFF) + threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);

  const int rows = MODE == kDx ? p.M : p.N;
  const int depth = MODE == kDx ? p.N : p.M;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_beg = blockIdx.z * p.chunk;
  const int k_end = min(depth, k_beg + p.chunk);
  const int nk = (k_end - k_beg + BK - 1) / BK;
  const bool tma = p.tma != 0;
  constexpr int TX = (ACT == kNone ? 2 : 3) * TILE_BYTES;

  // stage it's raw tiles into ring slot it % ST: with TMA, one thread
  // issues them on the slot's barrier (the boxes past an edge of the
  // matrix are filled with zeros; a split's chunk is whole stages, so no
  // stage crosses into the next split's rows); else every thread copies
  // its elements and commits a group, a group even past the last stage
  // (the wait counts stay uniform)
  auto load = [&](int it) {
    unsigned char* s = sm + (it % ST) * STAGE_BYTES;
    const int k0 = k_beg + it * BK;
    if (tma) {
      if (threadIdx.x != 0 || it >= nk) return;
      uint64_t* bar = &full[it % ST];
      fence_async_shared();  // the slot's last generic reads come first
      mbar_expect_tx(bar, TX);
      if (MODE == kDx) {
        tma_load_2d(s, &tg, bar, k0, row0);
        if (ACT != kNone) tma_load_2d(s + TILE_BYTES, &tr, bar, k0, row0);
      } else {
        for (int b = 0; b < 4; ++b) {
          tma_load_2d(s + b * BOX_BYTES, &tg, bar, row0 + 32 * b, k0);
          if (ACT != kNone)
            tma_load_2d(s + TILE_BYTES + b * BOX_BYTES, &tr, bar,
                        row0 + 32 * b, k0);
        }
      }
      for (int b = 0; b < 4; ++b)
        tma_load_2d(s + 2 * TILE_BYTES + b * BOX_BYTES, &tb, bar,
                    col0 + 32 * b, k0);
      return;
    }
    if (it < nk) {
      if (MODE == kDx) {
        load_tile4<BM, 1>(s, p.g, p.N, row0, k0, rows, k_end);
        if (ACT != kNone)
          load_tile4<BM, 1>(s + TILE_BYTES, p.res, p.N, row0, k0, rows,
                            k_end);
      } else {
        load_tile4<BK, 4>(s, p.g, p.N, k0, row0, k_end, rows);
        if (ACT != kNone)
          load_tile4<BK, 4>(s + TILE_BYTES, p.res, p.N, k0, row0, k_end,
                            rows);
      }
      load_tile4<BK, 4>(s + 2 * TILE_BYTES, p.b, p.K, k0, col0, k_end, p.K);
    }
    cp_async_commit();
  };
  // stage it's tiles are in shared memory, for this thread (the caller's
  // barrier then makes the cp.async copies of every thread visible);
  // `pending`: the cp.async groups issued after stage it's
  auto wait_stage = [&](int it, auto pending) {
    if (tma)
      mbar_wait(&full[it % ST], (it / ST) & 1);
    else
      cp_async_wait<decltype(pending)::value>();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r = (warp / 4) * 64 + (warp % 4) * 16 + g;  // within the tile
  const bool sum = MODE == kDw && p.dbias != nullptr && blockIdx.x == 0;
  float bs[2] = {0.f, 0.f};

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int it = 0; it < ST; ++it) load(it);
  wait_stage(0, std::integral_constant<int, ST - 1>());
  __syncthreads();
  split_b(sm + 2 * TILE_BYTES, sm + SPLIT_OFF, sm + SPLIT_OFF + SPLIT_BYTES);
  form_a<MODE, ACT>(sm, r, q, sum, fs, bs);
  fence_async_shared();  // the split B, written by threads, read by wgmma
  __syncthreads();

  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = tot[i] = 0.f;
    fence_reg(acc[i]);
  }
  int fresh = 1;  // the next product starts the partial anew

  // Stage it: its A fragments from the thread's staging slots, its split
  // B from buffer it % 2; while its wgmmas run, stage it + 1 is split
  // into buffer (it + 1) % 2 and its fragments formed into the slots.
  for (int it = 0; it < nk; ++it) {
    uint32_t ch[BK / 8][4], cl[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint4 h = fs[s * NT], l = fs[(BK / 8 + s) * NT];
      ch[s][0] = h.x, ch[s][1] = h.y, ch[s][2] = h.z, ch[s][3] = h.w;
      cl[s][0] = l.x, cl[s][1] = l.y, cl[s][2] = l.z, cl[s][3] = l.w;
    }
    const uint32_t hb = smem_u32(sm + SPLIT_OFF + (it & 1) * 2 * SPLIT_BYTES);
    const uint32_t lb = hb + SPLIT_BYTES;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      wgmma_tf32_m64n128k8(acc, cl[s], desc_sw128(hb + 32 * s, 16, 1024),
                           s == 0 ? !fresh : 1);
      wgmma_tf32_m64n128k8(acc, ch[s], desc_sw128(lb + 32 * s, 16, 1024), 1);
      wgmma_tf32_m64n128k8(acc, ch[s], desc_sw128(hb + 32 * s, 16, 1024), 1);
    }
    wgmma_commit();
    if (it + 1 < nk) {
      wait_stage(it + 1, std::integral_constant<int, ST - 2>());
      __syncthreads();  // every thread's copies; ring slot it % ST is free
      load(it + ST);
      const unsigned char* s1 = sm + ((it + 1) % ST) * STAGE_BYTES;
      unsigned char* b1 = sm + SPLIT_OFF + ((it + 1) & 1) * 2 * SPLIT_BYTES;
      split_b(s1 + 2 * TILE_BYTES, b1, b1 + SPLIT_BYTES);
      form_a<MODE, ACT>(s1, r, q, sum, fs, bs);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    fence_frags(ch, cl);
    fresh = (it + 1) % PROMOTE == 0 || it + 1 == nk;
    if (fresh) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) tot[i] += acc[i];
    }
    fence_async_shared();
    __syncthreads();  // buffer (it + 1) % 2 is written; buffer it % 2 is
                      // free
  }

  // tot[4t + e]: row r + 8 (e / 2), column 8t + 2q + e % 2 of the tile
  float* out = p.out + (p.split ? static_cast<long long>(blockIdx.z) * rows *
                                      p.K
                                : 0ll);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + r + 8 * h;
    if (gr >= rows) continue;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int c = col0 + 8 * t + 2 * q;
      float* o = out + static_cast<long long>(gr) * p.K + c;
      if (c < p.K) o[0] = tot[4 * t + 2 * h];
      if (c + 1 < p.K) o[1] = tot[4 * t + 2 * h + 1];
    }
  }
  if (sum) {  // uniform over the CTA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = bs[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int gr = row0 + r + 8 * h;
      if (q == 0 && gr < rows) {
        if (p.split)
          static_cast<float*>(p.dbias)[static_cast<long long>(blockIdx.z) *
                                           rows + gr] = v;
        else
          store_vec(p.dbias, p.bias_dtype, gr, v);
      }
    }
  }
}

// One kernel name per mode, so a profile bills each on its own
// (chip_smoke.py's KERNEL_CATEGORIES: the matmul_dx_ / matmul_dw_ prefix).
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    matmul_dx_tf32x3(const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tr,
                     const __grid_constant__ CUtensorMap tb, const Args p) {
  bwd_x3<kDx, ACT>(tg, tr, tb, p);
}
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    matmul_dw_tf32x3(const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tr,
                     const __grid_constant__ CUtensorMap tb, const Args p) {
  bwd_x3<kDw, ACT>(tg, tr, tb, p);
}

// The output (dX or dW) and dbias from the f32 partials of `splits`
// chunks of the contraction: each sum in split order.  Thread i takes
// output element i and, for i < rows, dbias[i].
constexpr int MERGE_NT = 256;

__device__ __forceinline__ void merge(const float* part, int splits,
                                      long long elems, float* out,
                                      const float* bpart, int rows,
                                      void* dbias, int bias_dtype) {
  const long long i = static_cast<long long>(blockIdx.x) * MERGE_NT +
                      threadIdx.x;
  if (i < elems) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * elems + i];
    out[i] = s;
  }
  if (dbias != nullptr && i < rows) {
    float s = bpart[i];
    for (int k = 1; k < splits; ++k)
      s += bpart[static_cast<long long>(k) * rows + i];
    store_vec(dbias, bias_dtype, static_cast<int>(i), s);
  }
}

// one name a mode, billed with its kernel
__global__ void __launch_bounds__(MERGE_NT)
    matmul_dx_merge_f32(const float* part, int splits, long long elems,
                        float* dx) {
  merge(part, splits, elems, dx, nullptr, 0, nullptr, 0);
}
__global__ void __launch_bounds__(MERGE_NT)
    matmul_dw_merge_f32(const float* part, int splits, long long elems,
                        float* dw, const float* bpart, int rows, void* dbias,
                        int bias_dtype) {
  merge(part, splits, elems, dw, bpart, rows, dbias, bias_dtype);
}

// A 2-D f32 tensor map over the row-major [rows][cols] matrix at base
// (row stride ld elements) in boxes of 32 columns (128 bytes, swizzled)
// by box_rows rows; false where cuTensorMapEncodeTiled refuses it.
inline bool encode_map_f32(CUtensorMap* map, const void* base, long long rows,
                           long long cols, long long ld, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, int ACT>
cudaError_t launch_act(const CUtensorMap& tg, const CUtensorMap& tr,
                       const CUtensorMap& tb, const Args& p, dim3 grid,
                       cudaStream_t stream) {
  auto kern = MODE == kDx ? matmul_dx_tf32x3<ACT> : matmul_dw_tf32x3<ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ALLOC);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, SMEM_ALLOC, stream>>>(tg, tr, tb, p);
  return cudaGetLastError();
}

// The f32 backward GEMM of MODE with `splits` chunks of the contraction:
// the tensor maps of dY, the residual and B when N and K allow TMA (16-
// byte rows), then the launch.
template <int MODE>
cudaError_t launch(Args p, int act, int splits, cudaStream_t stream) {
  const int rows = MODE == kDx ? p.M : p.N;
  const int depth = MODE == kDx ? p.N : p.M;
  dim3 grid((p.K + BN - 1) / BN, (rows + BM - 1) / BM, splits);
  CUtensorMap tg{}, tr{}, tb{};
  const int a_box = MODE == kDx ? BM : BK;  // rows of a dY box
  p.tma = p.N % 4 == 0 && p.K % 4 == 0 &&
          encode_map_f32(&tg, p.g, p.M, p.N, p.N, a_box) &&
          (p.res == nullptr ||
           encode_map_f32(&tr, p.res, p.M, p.N, p.N, a_box)) &&
          encode_map_f32(&tb, p.b, depth, p.K, p.K, BK);
  switch (act) {
    case kNone: return launch_act<MODE, kNone>(tg, tr, tb, p, grid, stream);
    case kRelu: return launch_act<MODE, kRelu>(tg, tr, tb, p, grid, stream);
    case kTanh: return launch_act<MODE, kTanh>(tg, tr, tb, p, grid, stream);
    case kGelu: return launch_act<MODE, kGelu>(tg, tr, tb, p, grid, stream);
    case kGeluTanh:
      return launch_act<MODE, kGeluTanh>(tg, tr, tb, p, grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace x3
}  // namespace gemm
}  // namespace ptt
