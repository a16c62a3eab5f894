// One device template for single-token decode attention over a KV
// cache, shared by the dense kernel (decode_attention.cu) and the paged
// kernel (paged_attention.cu).  The two differ only in the address
// function that maps (slot n, logical position t) to a cache row:
//
//   dense  — an identity table: block n, row t of a [N, T, H, D] cache;
//   paged  — block tables[n][t / bs], row t % bs of a [NB, bs, H, D] pool.
//
// Everything else — the 16-row key tile over logical positions, the
// order of every sum and max — is this one body, so on identical cache
// contents the dense and paged kernels return bitwise-equal outputs
// (the engine's paged == dense check rests on it).
//
// Per (slot, head), with len = lengths[n]:
//   s[t]  = scale * q . k[t]            t < len
//   out   = softmax(s) @ v              (len == 0: zeros)
// in f32, with an online softmax over the tiles.  Only rows t < len are
// read, so a paged slot reads only its first ceil(len / bs) table
// entries; entries past that may be 0 (the garbage block) or stale.
//
// What bounds it on this card: every live K and V byte is read once for
// 4 * D flops per row pair — about 0.5 flop per f32 byte, far below the
// card's ridge, so the kernel is bound by device-memory bytes.  The
// design reads each live row exactly once and skips everything past
// the length.  One CTA per (slot, head): at 8 slots x 12 heads that is
// 96 CTAs on 132 SMs, each walking its rows in sequence, so a CTA's
// time is the chain of memory latencies along its slot's tiles.  The
// body hides what it can of that chain with a two-stage register
// pipeline: while tile i is scored and summed, tile i + 1's K and V
// values are in flight and tile i + 2's cache rows (its table entries,
// for the paged kernel) are being resolved, so a tile costs about one
// memory latency, not the four a paged tile costs unpipelined.  The
// card's bandwidth is still not reached; splitting the key range across
// CTAs (split-K) is later work.
//
// Block: 128 threads = 4 warps.  For each 16-row tile, warp w scores
// keys 4w .. 4w+3 (each lane holds D/32 query values; the dot product
// reduces with a fixed xor-shuffle tree) and writes them to shared
// memory; every thread then reads the 16 scores and updates the same
// (m, l) in the same order; for P.V, thread (g, d) with g = tid / D
// accumulates output column d over the tile's keys j with j % (128/D) == g,
// in increasing j, and the (128/D) partial sums are added in order
// through shared memory at the end.  The pipeline moves loads earlier
// and changes no sum's order.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int DEC_NT = 128;
constexpr int DEC_TILE = 16;

// identity table: slot n's cache is block n, row t
struct DenseAddr {
  long long T;
  __device__ __forceinline__ long long row(int n, int t) const {
    return static_cast<long long>(n) * T + t;
  }
};

// block table: logical block t / bs of slot n is pool block tables[n][..]
struct PagedAddr {
  const int* tables;
  int max_blocks;
  int bs;
  __device__ __forceinline__ long long row(int n, int t) const {
    const int blk = tables[static_cast<long long>(n) * max_blocks + t / bs];
    return static_cast<long long>(blk) * bs + t % bs;
  }
};

// Per-thread view of one 16-row tile: the cache rows this thread reads
// (KPW keys of its warp for Q.K, VPT keys of its group g for P.V) and
// the values read from them.
template <int D>
struct DecTile {
  static constexpr int VPL = D / 32;                  // query values per lane
  static constexpr int KSPLIT = DEC_NT / D;           // P.V key groups
  static constexpr int KPW = DEC_TILE / (DEC_NT / 32);  // keys per warp
  static constexpr int VPT = DEC_TILE / KSPLIT;       // P.V keys per thread
  long long krow[KPW], vrow[VPT];
  float k[KPW][VPL], v[VPT];
};

template <int D, typename Addr>
__device__ __forceinline__ void tile_rows(DecTile<D>& tl, const Addr& addr,
                                          int n, int t0, int len, int warp,
                                          int g) {
#pragma unroll
  for (int kk = 0; kk < DecTile<D>::KPW; ++kk) {
    const int t = t0 + warp * DecTile<D>::KPW + kk;
    tl.krow[kk] = t < len ? addr.row(n, t) : 0;
  }
#pragma unroll
  for (int jj = 0; jj < DecTile<D>::VPT; ++jj) {
    const int t = t0 + jj * DecTile<D>::KSPLIT + g;
    tl.vrow[jj] = t < len ? addr.row(n, t) : 0;
  }
}

template <typename T, int D>
__device__ __forceinline__ void tile_load(DecTile<D>& tl,
                                          const T* __restrict__ kc,
                                          const T* __restrict__ vc,
                                          long long hd, int h, int t0,
                                          int len, int warp, int lane, int g,
                                          int d) {
#pragma unroll
  for (int kk = 0; kk < DecTile<D>::KPW; ++kk) {
    const int t = t0 + warp * DecTile<D>::KPW + kk;
    const T* kr = kc + tl.krow[kk] * hd + h * D;
#pragma unroll
    for (int i = 0; i < DecTile<D>::VPL; ++i)
      tl.k[kk][i] = t < len ? to_f(kr[lane + 32 * i]) : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < DecTile<D>::VPT; ++jj) {
    const int t = t0 + jj * DecTile<D>::KSPLIT + g;
    tl.v[jj] = t < len ? to_f(vc[tl.vrow[jj] * hd + h * D + d]) : 0.f;
  }
}

template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_body(const T* __restrict__ q,
                                            const T* __restrict__ kc,
                                            const T* __restrict__ vc,
                                            T* __restrict__ o, int H, int n,
                                            int h, int len, float scale,
                                            Addr addr) {
  static_assert(D % 32 == 0 && DEC_NT % D == 0, "head dim 32, 64 or 128");
  using Tile = DecTile<D>;
  constexpr int VPL = Tile::VPL;
  constexpr int KSPLIT = Tile::KSPLIT;
  constexpr int KPW = Tile::KPW;
  __shared__ float s_sc[DEC_TILE];
  __shared__ float s_acc[KSPLIT][D];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = tid / D, d = tid % D;
  const long long hd = static_cast<long long>(H) * D;
  const long long qoff = (static_cast<long long>(n) * H + h) * D;

  float qv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) qv[i] = to_f(q[qoff + lane + 32 * i]);

  // cur: the tile being summed; nxt: its successor, rows resolved and
  // values in flight; rows of the tile after that are resolved below
  Tile cur, nxt;
  tile_rows<D>(cur, addr, n, 0, len, warp, g);
  tile_load<T, D>(cur, kc, vc, hd, h, 0, len, warp, lane, g, d);
  tile_rows<D>(nxt, addr, n, DEC_TILE, len, warp, g);

  float m = NEG_INF, l = 0.f, acc = 0.f;
  for (int t0 = 0; t0 < len; t0 += DEC_TILE) {
    tile_load<T, D>(nxt, kc, vc, hd, h, t0 + DEC_TILE, len, warp, lane, g,
                    d);
    Tile after;
    tile_rows<D>(after, addr, n, t0 + 2 * DEC_TILE, len, warp, g);

#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      const int j = warp * KPW + kk;
      const int t = t0 + j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) part = fmaf(qv[i], cur.k[kk][i], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s_sc[j] = t < len ? part * scale : NEG_INF;
    }
    __syncthreads();

    float sc[DEC_TILE];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < DEC_TILE; ++j) {
      sc[j] = s_sc[j];
      mt = fmaxf(mt, sc[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < DEC_TILE; ++j) {
      sc[j] = sc[j] <= NEG_INF / 2 ? 0.f : expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * corr + psum;
    m = m_new;
    acc *= corr;
#pragma unroll
    for (int jj = 0; jj < Tile::VPT; ++jj) {
      const int j = jj * KSPLIT + g;
      if (t0 + j < len) acc = fmaf(sc[j], cur.v[jj], acc);
    }
    __syncthreads();  // s_sc is rewritten by the next tile

    cur = nxt;
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) nxt.krow[kk] = after.krow[kk];
#pragma unroll
    for (int jj = 0; jj < Tile::VPT; ++jj) nxt.vrow[jj] = after.vrow[jj];
  }

  s_acc[g][d] = acc;
  __syncthreads();
  if (tid < D) {
    float tot = 0.f;
#pragma unroll
    for (int gg = 0; gg < KSPLIT; ++gg) tot += s_acc[gg][tid];
    const bool dead = m <= NEG_INF / 2;
    const float out = tot / (l == 0.f ? 1.f : l);
    store(&o[qoff + tid], dead ? 0.f : out);
  }
}

}  // namespace ptt
