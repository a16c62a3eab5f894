// The bf16 GEMMs of the port for Hopper (sm_90a): the forward body of the
// fused-epilogue matmul (kernel 5, launched by matmul_bias_act.cu) and of
// the 1x1-conv + BN kernels (kernels 10 and 11, conv_bn_relu.cu and
// conv_bn_stats.cu), and the matmul's backward (kernels 6 and 7,
// matmul_bwd.cu).  With the port's w [N, K] and, in the backward, dZ =
// dY * act'(residual) (the residual is z for gelu, y for relu and tanh,
// absent for none),
//
//   kFwd acc [M, N] = x w^T        A = x [M][K], K-major;  B = w [N][K], K-major
//        kernel 5:  z = acc + bias, y = act(z)
//        kernel 10: y = max(acc scale + shift, 0)
//        kernel 11: y = acc, and each column's (mean, M2) a row tile
//   kDx  dX [M, K] = dZ w          A = dZ [M x N], K-major; B = w [N][K], MN-major
//   kDw  dW [N, K] = dZ^T x        A = dZ^T [N x M], MN-major; B = x [M][K], MN-major
//        dbias [N] = sum_M dZ
//
// ("K-major": the contraction index is the contiguous one; "MN-major":
// the output index is.)
//
// One CTA computes a 128 x TN output tile (TN = 256, and 64 or 128 in
// the forward) over a contraction range, BK = 64 deep a stage, with 384
// threads: a producer warpgroup (one thread issues the loads;
// `setmaxnreg` hands most of its registers to the others) and two
// consumer warpgroups of 64 output rows each.
// * The producer keeps a ring of ST stages in flight with TMA (2-D
//   tensor maps, 128-byte swizzle; flash_tc.cuh's primitives).  A `full`
//   mbarrier a stage counts the bytes in; an `empty` one counts the
//   eight consumer warps out.  TMA fills loads past an edge with zeros
//   (and a zero dY gives a zero dZ), so ragged M, N and K take no branch
//   in the mainloop.
// * The forward (`fwd_tc<EPI, TN>`): a stage holds the x tile [128][64]
//   and the w tile [TN][64], both read by wgmma m64nTNk16 through
//   shared-memory descriptors (the simplest case: no operand is formed
//   in registers).  The epilogue EPI runs on the f32 accumulator, which
//   holds TN / 2 floats a thread: kernel 5's bias added in f32, z rounded
//   once to bf16, y = act_fwd(z) of the f32 z (no table: y must be act of
//   the f32 value, not of its rounding) rounded once; kernel 10's affine
//   and relu in f32; kernel 11's y as it is, then `tile_stats` on the
//   unrounded accumulator.  Each consumer warpgroup writes z, then y,
//   into its own swizzled [64][TN] staging tile and one thread stores it
//   with TMA (full lines; the parts past M or N are not written).  A CTA
//   walks the tiles blockIdx.x, + gridDim.x, ... in row-major tile order:
//   with as many CTAs as tiles that is one tile a CTA; with fewer
//   (persistent), the producer loads the next tile's stages while the
//   consumers run the epilogue, and the TMA stores drain under the next
//   mainloop.  Kernel 5 takes TN = 256; kernels 10 and 11 the width
//   ops/conv_bn.py `conv_schedule` picks from N (the narrowest that
//   holds N: a 256-wide tile at N = 64 would leave three quarters of its
//   columns masked).
// * The backward (`bwd_tc`): each stage holds the dY tile, the residual
//   tile (not for act none) and the B tile (w or x) as boxes of [64
//   contraction][64 columns]; stores are masked.  A consumer thread
//   reads its A fragment of dY and of the residual straight from the
//   swizzled tiles with ldmatrix (kDx: plain, rows of dZ; kDw: .trans,
//   so the fragment is of dZ^T), forms dZ in f32 with act_bwd (gelu's
//   derivative from a table, below), rounds it once to bf16 into the
//   register A operand, and runs wgmma m64n256k16 with B read MN-major
//   through a descriptor, as V enters P V in flash_fwd.cu.  dZ is never
//   written to shared or device memory.  Forming dZ costs as much as the
//   products, so the two overlap: while one stage's wgmmas run, the
//   thread forms the next stage's fragments into a second register set.
// * kDw sums dbias in the CTAs of column tile 0 from the f32 dZ, before
//   its rounding: each thread over its own rows and contraction indices
//   in a fixed order, then the four lanes of a row in a fixed order.
// * kDw may split M into chunks (blockIdx.z): each writes f32 partials
//   [S][N][K] and [S][N], which `matmul_dw_merge` adds up in split
//   order and rounds once.  No float atomics: launches agree bit for
//   bit.
//
// The swizzle: TMA stores 16-byte chunk c of row r of a 128-byte-row
// box at chunk c ^ (r % 8), the pattern the wgmma descriptors assume;
// the ldmatrix addresses and the forward's staging writes below apply
// the same XOR.
#pragma once

#include "flash_tc.cuh"
#include "gemm_common.cuh"

namespace ptt {
namespace gemm {
namespace wg {

using namespace ::ptt::hopper;
using ::ptt::tcore::ldsm_x4;
using ::ptt::tcore::ldsm_x4_t;
using ::ptt::tcore::smem_u32;

constexpr int BM = 128;              // output rows of a CTA
constexpr int BN = 256;              // output columns of a CTA
constexpr int BK = 64;               // contraction of a stage
constexpr int ST = 3;                // stages of the TMA ring
constexpr int NT = 384;              // 2 consumer warpgroups + the producer's
constexpr int CONSUMER_WARPS = 8;
// registers a thread of the producer's warpgroup gives up, and the
// consumers take: 128 x 40 + 256 x 232 fits the 65,536 of an SM
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BOX = BK * 128;        // bytes of a [64][64] bf16 box
constexpr int A_BYTES = BM * 128;    // the dY (or residual) tile of a stage

// The gelu derivative of every bf16 z with 2^-16 <= |z| < 2^4 (20
// binades x 128 mantissas x 2 signs), built in shared memory by each CTA
// from the same act_bwd, so a table entry times dY is the value act_bwd
// would give.  It replaces the erf and exp of each dZ element by one
// lookup.  A warp with a z outside the range forms the stage again on
// the exact path (act_bwd there), a branch uniform over the warp: with a
// branch for each element the compiler predicated erf and exp into
// every one.
constexpr int TAB_BINADES = 20;
constexpr int TAB_LO = (127 + 4 - TAB_BINADES) << 7;  // bits of 2^(4 - binades)
constexpr int TAB_HALF = TAB_BINADES * 128;
constexpr int TAB_SIZE = 2 * TAB_HALF;

template <int ACT>
__host__ __device__ constexpr bool has_table() {
  return ACT == kGelu || ACT == kGeluTanh;
}

template <int ACT>
__device__ __forceinline__ void build_table(float* tab) {
  for (int i = threadIdx.x; i < TAB_SIZE; i += NT) {
    const int bits = (i / TAB_HALF) << 15 | (TAB_LO + i % TAB_HALF);
    tab[i] = act_bwd<ACT>(1.f, __bfloat162float(__ushort_as_bfloat16(
                                   static_cast<unsigned short>(bits))));
  }
}

// dZ of one element from dY (f32) and the bf16 residual's bits.  With
// a table and !EXACT: the table alone (its nearest entry for a residual
// outside it), and `out` is set when the residual lies outside it;
// EXACT: act_bwd itself there.  Without a table: act_bwd.
template <int ACT, bool EXACT>
__device__ __forceinline__ float dz_of(float g, unsigned bits,
                                       const float* tab, bool& out) {
  if (!has_table<ACT>())
    return act_bwd<ACT>(g, __uint_as_float(bits << 16));
  const unsigned u = (bits & 0x7FFF) - TAB_LO;
  if (EXACT && u >= TAB_HALF)
    return act_bwd<ACT>(g, __uint_as_float(bits << 16));
  out |= u >= TAB_HALF;
  return g * tab[(bits >> 15) * TAB_HALF + min(u, TAB_HALF - 1u)];
}

// Two neighbouring dZ values (f32 in d0, d1) from packed bf16 pairs of dY
// and the residual, and their bf16 pair packed as an A operand register.
template <int ACT, bool EXACT>
__device__ __forceinline__ uint32_t dz_pair(uint32_t gv, uint32_t rv,
                                            const float* tab, float& d0,
                                            float& d1, bool& out) {
  const float g0 = __uint_as_float(gv << 16);
  const float g1 = __uint_as_float(gv & 0xFFFF0000u);
  if (ACT == kNone) {  // dZ = dY, already bf16
    d0 = g0;
    d1 = g1;
    return gv;
  }
  d0 = dz_of<ACT, EXACT>(g0, rv & 0xFFFFu, tab, out);
  d1 = dz_of<ACT, EXACT>(g1, rv >> 16, tab, out);
  const __nv_bfloat162 o = __floats2bfloat162_rn(d0, d1);
  return *reinterpret_cast<const uint32_t*>(&o);
}

// Shared memory: the ring (each stage dY, residual, B; every tile
// 1024-byte aligned, as the swizzle needs), the table, the barriers.
template <int ACT>
struct Smem {
  static constexpr bool RES = ACT != kNone;
  static constexpr int B_OFF = A_BYTES * (RES ? 2 : 1);  // within a stage
  static constexpr int STAGE = B_OFF + BN * 128;
  static constexpr int TAB_OFF = ST * STAGE;
  static constexpr int BAR_OFF =
      TAB_OFF + (has_table<ACT>() ? TAB_SIZE * 4 : 0);
  static constexpr int BYTES = BAR_OFF + 2 * ST * 8;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};

struct BwdArgs {
  int rows, cols, depth;  // of the whole product: output rows, columns,
                          // contraction length
  int chunk;              // kDw: contraction rows of a split (a multiple
                          // of BK); depth when unsplit
  void* out;              // dx / dw (bf16), or f32 partials [S][rows][cols]
  void* dbias;            // kDw: [rows] in bias_dtype, or f32 partials
                          // [S][rows]; null for none
  int bias_dtype;
  int split;              // non-zero: write the partials of split blockIdx.z
};

// The A fragment (wgmma's register layout, tc_common.cuh's A tile per
// warp) of contraction step kk for warp wi of warpgroup wg: the byte
// offset of this lane's ldmatrix row within a stage's dY tile.
template <int MODE>
__device__ __forceinline__ int a_offset(int wg, int wi, int lane, int kk) {
  if (MODE == kDx) {  // the tile is [128 rows][64 contraction], K-major
    const int r = wg * 64 + wi * 16 + (lane & 15);
    const int c = 2 * kk + (lane >> 4);
    return r * 128 + ((c ^ (r & 7)) << 4);
  }
  // kDw: two boxes [64 contraction][64 rows], box wg for warpgroup wg;
  // ldmatrix.trans turns its rows into the fragment's columns
  const int m = kk * 16 + (lane & 7) + (lane >> 4) * 8;
  const int c = wi * 2 + ((lane >> 3) & 1);
  return wg * BOX + m * 128 + ((c ^ (m & 7)) << 4);
}

// The A fragments of a stage (dZ, rounded to bf16) for warp wi of
// warpgroup wg, read from the stage's dY and residual tiles at `s`; in
// kDw with `sum`, the f32 dZ of rows g and g + 8 summed into bs.  See
// dz_of for EXACT and `out`.
template <int MODE, int ACT, bool EXACT>
__device__ __forceinline__ void form_a(const unsigned char* s, int wg, int wi,
                                       int lane, const float* tab, bool sum,
                                       uint32_t (&a)[BK / 16][4],
                                       float (&bs)[2], bool& out) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int off = a_offset<MODE>(wg, wi, lane, kk);
    uint32_t gv[4], rv[4] = {0u, 0u, 0u, 0u};
    if (MODE == kDx) {
      ldsm_x4(gv, s + off);
      if (ACT != kNone) ldsm_x4(rv, s + A_BYTES + off);
    } else {
      ldsm_x4_t(gv, s + off);
      if (ACT != kNone) ldsm_x4_t(rv, s + A_BYTES + off);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d0, d1;
      a[kk][j] = dz_pair<ACT, EXACT>(gv[j], rv[j], tab, d0, d1, out);
      if (sum) bs[j & 1] += d0 + d1;  // a[1], a[3]: rows g + 8
    }
  }
}

// The A fragments of a stage, and kDw's dbias sums: the table's path,
// and for a warp with a residual outside the table (rare: |z| < 2^-16
// or >= 16) the exact one, a branch uniform over the warp.
template <int MODE, int ACT>
__device__ __forceinline__ void stage_a(const unsigned char* s, int wg, int wi,
                                        int lane, const float* tab, bool sum,
                                        uint32_t (&a)[BK / 16][4],
                                        float (&bsum)[2]) {
  float bs[2] = {0.f, 0.f};
  bool out = false;
  form_a<MODE, ACT, false>(s, wg, wi, lane, tab, sum, a, bs, out);
  if (has_table<ACT>() && __any_sync(0xffffffffu, out)) {
    bs[0] = bs[1] = 0.f;
    form_a<MODE, ACT, true>(s, wg, wi, lane, tab, sum, a, bs, out);
  }
  bsum[0] += bs[0];
  bsum[1] += bs[1];
}

__device__ __forceinline__ void fence_frags(float (&acc)[BN / 2],
                                            uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_reg(a[kk][j]);
}

template <int MODE, int ACT>
__device__ __forceinline__ void bwd_tc(const CUtensorMap& tg,
                                       const CUtensorMap& tr,
                                       const CUtensorMap& tb,
                                       const BwdArgs& p) {
  using SM = Smem<ACT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* tab = reinterpret_cast<float*>(sm + SM::TAB_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + SM::BAR_OFF);
  uint64_t* empty = full + ST;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_beg = MODE == kDw ? blockIdx.z * p.chunk : 0;
  const int k_end = MODE == kDw ? min(p.depth, k_beg + p.chunk) : p.depth;
  const int nk = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  if (has_table<ACT>()) build_table<ACT>(tab);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // the producer: stage it holds contraction rows k_beg + 64 it ..
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int st = it % ST;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], SM::STAGE);
        unsigned char* s = sm + st * SM::STAGE;
        const int k0 = k_beg + it * BK;
        if (MODE == kDx) {  // dY, residual: one [128][64] box each
          tma_load_2d(s, &tg, &full[st], k0, row0);
          if (SM::RES) tma_load_2d(s + A_BYTES, &tr, &full[st], k0, row0);
        } else {  // two [64][64] boxes each, one per warpgroup
          for (int h = 0; h < 2; ++h) {
            tma_load_2d(s + h * BOX, &tg, &full[st], row0 + h * 64, k0);
            if (SM::RES)
              tma_load_2d(s + A_BYTES + h * BOX, &tr, &full[st],
                          row0 + h * 64, k0);
          }
        }
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(s + SM::B_OFF + c * BOX, &tb, &full[st], col0 + c * 64,
                      k0);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp / 4, wi = warp % 4;
  const bool sum = MODE == kDw && p.dbias != nullptr && blockIdx.x == 0;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.f;
    fence_reg(acc[i]);
  }
  float bsum[2] = {0.f, 0.f};  // kDw: rows g and g + 8 of the warp

  // Stage it's products run while stage it + 1's A fragments are formed:
  // two fragment sets, `cur` read by the wgmmas in flight and `nxt`
  // written, kept apart by fence_frags until the wgmmas are done.
  auto consume = [&](int it, uint32_t(&cur)[BK / 16][4],
                     uint32_t(&nxt)[BK / 16][4]) {
    const int st = it % ST;
    wgmma_fence();
    const uint32_t b = smem_u32(sm + st * SM::STAGE + SM::B_OFF);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<BN>(acc, cur[kk], desc_sw128(b + kk * 16 * 128, BOX, 1024));
    wgmma_commit();
    if (it + 1 < nk) {
      const int st1 = (it + 1) % ST;
      mbar_wait(&full[st1], ((it + 1) / ST) & 1);
      stage_a<MODE, ACT>(sm + st1 * SM::STAGE, wg, wi, lane, tab, sum, nxt,
                         bsum);
    }
    wgmma_wait<0>();
    fence_frags(acc, cur);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage is read
  };
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  if (nk > 0) {
    mbar_wait(&full[0], 0);
    stage_a<MODE, ACT>(sm, wg, wi, lane, tab, sum, a0, bsum);
  }
  for (int it = 0; it < nk; it += 2) {
    consume(it, a0, a1);
    if (it + 1 < nk) consume(it + 1, a1, a0);
  }

  // acc[4 t + e]: row wg 64 + wi 16 + g + 8 (e / 2), column 8 t + 2 q + e % 2
  const int g = lane / 4, q = lane % 4;
  const int rbase = row0 + wg * 64 + wi * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    if (r >= p.rows) continue;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int c = col0 + 8 * t + 2 * q;
      if (c >= p.cols) continue;
      const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
      if (p.split) {
        const long long o =
            (static_cast<long long>(blockIdx.z) * p.rows + r) * p.cols + c;
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
            make_float2(v0, v1);
      } else {
        store2(static_cast<__nv_bfloat16*>(p.out) +
                   static_cast<long long>(r) * p.cols + c,
               v0, v1);
      }
    }
  }
  if (sum) {  // uniform over the CTA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = bsum[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int r = rbase + 8 * h;
      if (q == 0 && r < p.rows) {
        if (p.split)
          static_cast<float*>(p.dbias)[static_cast<long long>(blockIdx.z) *
                                           p.rows + r] = v;
        else
          store_vec(p.dbias, p.bias_dtype, r, v);
      }
    }
  }
}

// One kernel name per mode, so a profile bills each on its own
// (chip_smoke.py's KERNEL_CATEGORIES).
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    matmul_dx_tc(const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap tb, const BwdArgs p) {
  bwd_tc<kDx, ACT>(tg, tr, tb, p);
}
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    matmul_dw_tc(const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap tb, const BwdArgs p) {
  bwd_tc<kDw, ACT>(tg, tr, tb, p);
}

// dW and dbias from the partials of `splits` chunks of M: each sum in
// split order, rounded once.  Thread i takes dW elements 4i .. 4i + 3
// (K is a multiple of 8) and, for i < N, dbias[i].
constexpr int MERGE_NT = 256;

__global__ void __launch_bounds__(MERGE_NT)
    matmul_dw_merge(const float* part, int splits, long long elems,
                    __nv_bfloat16* dw, const float* bpart, int rows,
                    void* dbias, int bias_dtype) {
  const long long i = static_cast<long long>(blockIdx.x) * MERGE_NT +
                      threadIdx.x;
  if (4 * i < elems) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = reinterpret_cast<const float4*>(part + k * elems)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store2(dw + 4 * i, s.x, s.y);
    store2(dw + 4 * i + 2, s.z, s.w);
  }
  if (dbias != nullptr && i < rows) {
    float s = bpart[i];
    for (int k = 1; k < splits; ++k)
      s += bpart[static_cast<long long>(k) * rows + i];
    store_vec(dbias, bias_dtype, static_cast<int>(i), s);
  }
}

template <int MODE, int ACT>
cudaError_t launch_act(const CUtensorMap& tg, const CUtensorMap& tr,
                       const CUtensorMap& tb, const BwdArgs& p, dim3 grid,
                       cudaStream_t stream) {
  auto kern = MODE == kDx ? matmul_dx_tc<ACT> : matmul_dw_tc<ACT>;
  constexpr int bytes = Smem<ACT>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, bytes, stream>>>(tg, tr, tb, p);
  return cudaGetLastError();
}

// The backward GEMM of MODE with `splits` chunks of the contraction (kDw
// only; 1 otherwise), over maps made by the caller.
template <int MODE>
cudaError_t launch(const CUtensorMap& tg, const CUtensorMap& tr,
                   const CUtensorMap& tb, const BwdArgs& p, int act,
                   int splits, cudaStream_t stream) {
  dim3 grid((p.cols + BN - 1) / BN, (p.rows + BM - 1) / BM, splits);
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


// ---------------------------------------------------------------------------
// the forward body: kernel 5, and the 1x1 conv + BN kernels 10 and 11
// ---------------------------------------------------------------------------

constexpr int OUT_BOX = 64 * 128;  // bytes of a [64 rows][64 cols] bf16 box
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a CTA may take

// The forward's shared memory at output width TN: the ring (x [128][64]
// and w [TN][64] a stage), the two warpgroups' staging tiles, kStats's
// scratch (two [8 warps][TN] f32 sums, one a pass, and the tile's means
// [TN]), the barriers.
template <int EPI, int TN>
struct FwdSmem {
  static constexpr int B_OFF = A_BYTES;             // within a stage
  static constexpr int STAGE = A_BYTES + TN * 128;
  static constexpr int OUT_OFF = ST * STAGE;
  static constexpr int OUT_WG = (TN / 64) * OUT_BOX;  // a warpgroup's [64][TN]
  static constexpr int RED_OFF = OUT_OFF + 2 * OUT_WG;
  static constexpr int RED_BYTES =
      EPI == kStats ? (2 * CONSUMER_WARPS + 1) * TN * 4 : 0;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * ST * 8;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
  static_assert(ALLOC <= SMEM_MAX, "the forward's shared memory");
};

struct FwdArgs {
  int rows, cols, depth;  // M, N, K
  const void* bias;       // kernel 5: [N] in bias_dtype, or null
  int bias_dtype;
  int emit_z;             // kernel 5: non-zero: write z through its map
  const float* scale;     // kBnRelu: [N] f32
  const float* shift;     // kBnRelu: [N] f32
  float* stats;           // kStats: [2][row tiles][N] f32 partials, the
                          // tiles' means, then their M2s
};

// The output tiles of the forward at width TN: BM rows x TN columns.
template <int TN>
__host__ __device__ inline int fwd_tiles(int rows, int cols) {
  return ((cols + TN - 1) / TN) * ((rows + BM - 1) / BM);
}

// The staging byte offset of accumulator pair t (columns 8t + 2q, +1) of
// row r (0..63) in a warpgroup's [64][TN] tile: TN / 64 swizzled boxes
// of 64 columns.
__device__ __forceinline__ int stage_offset(int r, int t, int q) {
  return (t / 8) * OUT_BOX + r * 128 + (((t % 8) ^ (r % 8)) << 4) + 4 * q;
}

// One output of a warpgroup's 64 x TN tile: the f32 accumulator rounded
// to bf16 into the staging tile, then stored by one thread with TMA.
// The staging tile is free: its previous stores have read it
// (`stage_free` ran).
template <int TN>
__device__ __forceinline__ void store_tile(const float (&acc)[TN / 2],
                                           unsigned char* stg,
                                           const CUtensorMap* map, int row0,
                                           int col0, int rows, int cols,
                                           int wg, int wi, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wi * 16 + g + 8 * h;
#pragma unroll
    for (int t = 0; t < TN / 8; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(stg + stage_offset(r, t, q)) =
          __floats2bfloat162_rn(acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
    }
  }
  fence_async_shared();
  named_bar_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    const int r = row0 + wg * 64;
    if (r < rows)
      for (int b = 0; b < TN / 64 && col0 + 64 * b < cols; ++b)
        tma_store_2d(map, stg + b * OUT_BOX, col0 + 64 * b, r);
    bulk_commit();
  }
}

// Waits until the warpgroup's staging tile may be written again.
__device__ __forceinline__ void stage_free(int wg) {
  if (threadIdx.x % 128 == 0) bulk_wait_read();
  named_bar_sync(1 + wg, 128);
}

// v[j] <- the sum over the lane pair (lane, lane ^ mask) of v[j + H * b]
// where b is this lane's bit `bit`: each lane of the pair keeps one half
// of v[0 .. 2H) and sends the other.  a + b == b + a bit for bit, so
// both lanes of a pair round alike.
template <int H>
__device__ __forceinline__ void halve(float (&v)[16], bool bit, int mask) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = bit ? v[j] : v[j + H];
    const float keep = bit ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// kStats: the per-column (mean, M2) of the tile's valid rows (rows past
// M, which TMA filled with zeros, are left out of both passes) from the
// f32 accumulator, the tile's mean first and then the squares about it:
// no sum of squares cancels.  Written to row tile `rt` of the partials.
// A thread holds rows 16 wi + g and + 8 of its warpgroup's 64, columns
// 8t + 2q and + 1 (g = lane / 4, q = lane % 4).  Each pass, a 64-column
// box at a time: a thread adds its two rows, the eight lanes of a q
// reduce-and-scatter in three halvings (lane bits 2, 3, 4: 14 shuffles
// for 16 column sums), leaving columns 8s + 2q, + 1 of the box's 64 with
// lane g, s = g's three bits reversed; then thread c < TN adds the eight
// warps' sums of column c in warp order.  Every sum runs in an order
// fixed by the tile alone: the partials do not depend on the grid.
// Only the 256 consumer threads run this (the producer warpgroup has
// returned): they meet on named barrier 3, not __syncthreads.
template <int TN>
__device__ __forceinline__ void tile_stats(const float (&acc)[TN / 2],
                                           float* red, const FwdArgs& p,
                                           int row0, int col0, int rt,
                                           int wg, int wi, int lane) {
  const int g = lane / 4, q = lane % 4, warp = wg * 4 + wi;
  const int s = (g & 1) << 2 | (g & 2) | g >> 2;
  const int r = row0 + wg * 64 + wi * 16 + g;
  const bool ok0 = r < p.rows, ok1 = r + 8 < p.rows;
  const int nrows = min(BM, p.rows - row0);
  float* mean = red + 2 * CONSUMER_WARPS * TN;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // the sums, then the squares
    float* buf = red + pass * CONSUMER_WARPS * TN;
#pragma unroll
    for (int b = 0; b < TN / 64; ++b) {
      float v[16];  // v[2u + e]: column 64b + 8u + 2q + e
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = 8 * b + u;
        const float2 m = pass ? *reinterpret_cast<const float2*>(
                                    mean + 64 * b + 8 * u + 2 * q)
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float me = e ? m.y : m.x;
          const float d0 = ok0 ? acc[4 * t + e] - me : 0.f;
          const float d1 = ok1 ? acc[4 * t + 2 + e] - me : 0.f;
          v[2 * u + e] = pass ? d0 * d0 + d1 * d1 : d0 + d1;
        }
      }
      halve<8>(v, g & 1, 4);
      halve<4>(v, g & 2, 8);
      halve<2>(v, g & 4, 16);
      *reinterpret_cast<float2*>(buf + warp * TN + 64 * b + 8 * s + 2 * q) =
          make_float2(v[0], v[1]);
    }
    named_bar_sync(3, 256);
    const int c = threadIdx.x;  // 0 .. 255: the consumers
    if (c < TN) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMER_WARPS; ++w) sum += buf[w * TN + c];
      if (pass == 0) {
        mean[c] = sum / nrows;
      } else if (col0 + c < p.cols) {
        const long long o = static_cast<long long>(rt) * p.cols + col0 + c;
        const int rtiles = (p.rows + BM - 1) / BM;
        p.stats[o] = mean[c];
        p.stats[static_cast<long long>(rtiles) * p.cols + o] = sum;
      }
    }
    // pass 0: the means are written before pass 1 reads them.  After
    // pass 1 none is needed: the next tile writes the pass-0 sums, last
    // read before this barrier, and the means and pass-1 sums only
    // after its own first barrier.
    if (pass == 0) named_bar_sync(3, 256);
  }
}

// The forward GEMM acc = x w^T over BM x TN output tiles, then the
// epilogue EPI on the f32 accumulator: an activation code of kernel 5
// (the bias added, z and y = act(z) stored), kBnRelu (y = max(acc
// scale[c] + shift[c], 0) stored) or kStats (y = acc stored, then
// `tile_stats`).
template <int EPI, int TN>
__device__ __forceinline__ void fwd_tc(const CUtensorMap& ta,
                                       const CUtensorMap& tb,
                                       const CUtensorMap& ty,
                                       const CUtensorMap& tz,
                                       const FwdArgs& p) {
  using SM = FwdSmem<EPI, TN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + SM::BAR_OFF);
  uint64_t* empty = full + ST;

  const int tiles_n = (p.cols + TN - 1) / TN;
  const int tiles = fwd_tiles<TN>(p.rows, p.cols);
  const int nk = (p.depth + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // the producer: ring slot it % ST holds the it-th stage of the CTA's
    // tiles in order
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / tiles_n * BM, col0 = tile % tiles_n * TN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % ST;
          mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[st], SM::STAGE);
          unsigned char* s = sm + st * SM::STAGE;
          tma_load_2d(s, &ta, &full[st], kt * BK, row0);
          tma_load_2d(s + SM::B_OFF, &tb, &full[st], kt * BK, col0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp / 4, wi = warp % 4;
  unsigned char* stg = sm + SM::OUT_OFF + wg * SM::OUT_WG;
  const bool lead = lane == 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / tiles_n * BM, col0 = tile % tiles_n * TN;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) {
      acc[i] = 0.f;
      fence_reg(acc[i]);
    }
    // stage kt's products are issued, then stage kt - 1's awaited and
    // its slot handed back
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % ST;
      mbar_wait(&full[st], (it / ST) & 1);
      const uint32_t a = smem_u32(sm + st * SM::STAGE) + wg * 64 * 128;
      const uint32_t b = smem_u32(sm + st * SM::STAGE + SM::B_OFF);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<TN>(acc, desc_sw128(a + kk * 32, 16, 1024),
                     desc_sw128(b + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) fence_reg(acc[i]);
      __syncwarp();
      if (kt > 0 && lead) mbar_arrive(&empty[(it - 1) % ST]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) fence_reg(acc[i]);
    __syncwarp();
    if (nk > 0 && lead) mbar_arrive(&empty[(it - 1) % ST]);

    const int q = lane % 4;
    if constexpr (EPI == kBnRelu) {
      // y = max(acc scale + shift, 0), in place
#pragma unroll
      for (int t = 0; t < TN / 8; ++t) {
        const int c = col0 + 8 * t + 2 * q;
        const bool in = c < p.cols;  // N is a multiple of 8
        const float s0 = in ? p.scale[c] : 0.f, s1 = in ? p.scale[c + 1] : 0.f;
        const float b0 = in ? p.shift[c] : 0.f, b1 = in ? p.shift[c + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * t + 2 * h] = fmaxf(acc[4 * t + 2 * h] * s0 + b0, 0.f);
          acc[4 * t + 2 * h + 1] = fmaxf(acc[4 * t + 2 * h + 1] * s1 + b1, 0.f);
        }
      }
    } else if constexpr (EPI != kStats) {
      // kernel 5: z = acc + bias (in place), then y = act(z)
      if (p.bias) {
#pragma unroll
        for (int t = 0; t < TN / 8; ++t) {
          const int c = col0 + 8 * t + 2 * q;
          const float b0 =
              c < p.cols ? load_vec(p.bias, p.bias_dtype, c) : 0.f;
          const float b1 =
              c + 1 < p.cols ? load_vec(p.bias, p.bias_dtype, c + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[4 * t + 2 * h] += b0;
            acc[4 * t + 2 * h + 1] += b1;
          }
        }
      }
      if (p.emit_z) {
        stage_free(wg);
        store_tile<TN>(acc, stg, &tz, row0, col0, p.rows, p.cols, wg, wi,
                       lane);
      }
      // y = act(z) in place first: with act_fwd inside the staging loop
      // ptxas interleaved enough exact-gelu evaluations to spill
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = act_fwd<EPI>(acc[i]);
    }
    stage_free(wg);
    store_tile<TN>(acc, stg, &ty, row0, col0, p.rows, p.cols, wg, wi, lane);
    if constexpr (EPI == kStats)
      tile_stats<TN>(acc, reinterpret_cast<float*>(sm + SM::RED_OFF), p,
                     row0, col0, tile / tiles_n, wg, wi, lane);
  }
  if (threadIdx.x % 128 == 0) bulk_wait();  // before the CTA's shared
                                            // memory goes
}

// One launch of a forward kernel `kern` (EPI, TN) on `ctas` CTAs (at
// most one a tile; fewer walk several tiles each; 0: one a tile).
template <int EPI, int TN, typename Kern>
cudaError_t launch_fwd_kernel(Kern kern, const CUtensorMap& ta,
                              const CUtensorMap& tb, const CUtensorMap& ty,
                              const CUtensorMap& tz, const FwdArgs& p,
                              int ctas, cudaStream_t stream) {
  constexpr int bytes = FwdSmem<EPI, TN>::ALLOC;
  const int tiles = fwd_tiles<TN>(p.rows, p.cols);
  if (ctas <= 0 || ctas > tiles) ctas = tiles;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<ctas, NT, bytes, stream>>>(ta, tb, ty, tz, p);
  return cudaGetLastError();
}

// A 1x1-conv kernel `kern` (EPI, TN: kernels 10 and 11) on x [M, K], w
// [N, K] and y [M, N] (p.rows, p.depth, p.cols): their maps, then the
// launch.  A map that cuTensorMapEncodeTiled refuses (an unaligned base
// or row stride) fails the launch.
template <int EPI, int TN, typename Kern>
cudaError_t launch_conv(Kern kern, const void* x, const void* w, void* y,
                        const FwdArgs& p, int ctas, cudaStream_t stream) {
  CUtensorMap ta, tb, ty;
  if (!encode_map_2d(&ta, x, p.rows, p.depth, p.depth, BM) ||
      !encode_map_2d(&tb, w, p.cols, p.depth, p.depth, TN) ||
      !encode_map_2d(&ty, y, p.rows, p.cols, p.cols, 64))
    return cudaErrorInvalidValue;
  return launch_fwd_kernel<EPI, TN>(kern, ta, tb, ty, ty, p, ctas, stream);
}

// kernel 5: one name for every activation, 128 x 256 tiles
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
    matmul_fwd_tc(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap ty,
                  const __grid_constant__ CUtensorMap tz, const FwdArgs p) {
  fwd_tc<ACT, BN>(ta, tb, ty, tz, p);
}

template <int ACT>
cudaError_t launch_fwd_act(const CUtensorMap& ta, const CUtensorMap& tb,
                           const CUtensorMap& ty, const CUtensorMap& tz,
                           const FwdArgs& p, int ctas, cudaStream_t stream) {
  return launch_fwd_kernel<ACT, BN>(matmul_fwd_tc<ACT>, ta, tb, ty, tz, p,
                                    ctas, stream);
}

// Kernel 5 over maps made by the caller, on `ctas` CTAs.
inline cudaError_t launch_fwd(const CUtensorMap& ta, const CUtensorMap& tb,
                              const CUtensorMap& ty, const CUtensorMap& tz,
                              const FwdArgs& p, int act, int ctas,
                              cudaStream_t stream) {
  switch (act) {
    case kNone: return launch_fwd_act<kNone>(ta, tb, ty, tz, p, ctas, stream);
    case kRelu: return launch_fwd_act<kRelu>(ta, tb, ty, tz, p, ctas, stream);
    case kTanh: return launch_fwd_act<kTanh>(ta, tb, ty, tz, p, ctas, stream);
    case kGelu: return launch_fwd_act<kGelu>(ta, tb, ty, tz, p, ctas, stream);
    case kGeluTanh:
      return launch_fwd_act<kGeluTanh>(ta, tb, ty, tz, p, ctas, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace gemm
}  // namespace ptt
