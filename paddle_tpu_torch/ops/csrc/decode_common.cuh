// One device template for single-token decode attention over a KV
// cache, shared by the dense kernel (decode_attention.cu) and the paged
// kernel (paged_attention.cu).  The two differ only in the address
// function that maps (slot n, logical position t) to a cache row:
//
//   dense  — an identity table: block n, row t of a [N, T, H, D] cache;
//   paged  — block tables[n][t / bs], row t % bs of a [NB, bs, H, D] pool.
//
// Everything else — the chunks of the key range, the order of every sum
// and max — is this one body, so on identical cache contents and the
// same chunk plan the dense and paged kernels return bitwise-equal
// outputs (the engine's paged == dense check rests on it).
//
// Per (slot, head), with len = lengths[n]:
//   s[t]  = scale * q . k[t]            t < len
//   out   = softmax(s) @ v              (len == 0: zeros)
// in f32.  Only rows t < len are read, so a paged slot reads only its
// first ceil(len / bs) table entries; entries past that may be 0 (the
// garbage block) or stale.
//
// What bounds it on this card: every live K and V byte is read once for
// 4 * D flops per row pair — about 0.5 flop per f32 byte, far below the
// card's ridge, so the kernel is bound by device-memory bytes, and at
// serving sizes (a few MB) by how many loads are in flight.
//
// Design: a split of the key range (flash-decoding).  The host plans
// chunks of `chunk` positions, whole pool blocks, from the cache's
// capacity alone (ops/decode_attention.py `decode_split_plan`; never
// from the lengths, which live on the card).  The grid is (chunk c,
// slot n, head group); a CTA has one warp a head of its group and
// exits at once when its chunk starts at or past len.
// * A warp walks its chunk's rows for its head with 16-byte loads: a
//   row of D values is LPR lanes of VE values (f32, D = 64: 16 lanes of
//   4), so a warp step covers RPW = 32 / LPR rows, one a row group.  A
//   batch of UNROLL steps resolves its rows (table entries) first, then
//   issues every K and V load, then scores and sums, so a warp keeps
//   UNROLL * 2 * 16 bytes a lane in flight.  The warps of a CTA read
//   neighbouring heads of the same rows, one contiguous run of hg * D
//   values a row (ops/decode_attention.py `decode_head_groups`).
// * Each row group keeps an online softmax (m, l, acc) over its rows
//   (one rescale a batch); the row groups merge by a fixed xor-shuffle
//   tree, so every lane of the warp holds the chunk's partial.
// * One live chunk: the warp writes out = acc / l.  Otherwise each CTA
//   writes its partials (m, l) and acc (f32) to a workspace, and the
//   last CTA of its (slot, head group) to finish (an integer counter,
//   reset by that CTA for the next launch) merges them in chunk order:
//   M = max m_c, L = sum l_c e^(m_c - M), out = sum acc_c e^(m_c - M) / L.
//   No float atomics, so launches agree bit for bit.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int DEC_UNROLL = 8;  // warp steps a batch

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

// A cache row as 16-byte lane slices: VE values a lane, LPR lanes a
// row, RPW rows a warp step.
template <typename T, int D>
struct RowGeo {
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));
  static constexpr int LPR = D / VE;
  static constexpr int RPW = 32 / LPR;
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row within a warp");
};

struct DecArgs {
  const void* q;        // [N, H, D]
  const void* k;        // cache or pool, rows of [H, D]
  const void* v;
  void* o;              // [N, H, D]
  const int* lengths;   // [N]
  float* acc;           // [N, H, chunks, D] partials
  float* ml;            // [N, H, chunks, 2] partials (m, l)
  int* counters;        // [N, groups], zero between launches
  int H, hg;            // heads, heads a CTA (its warps)
  int chunk, chunks;    // positions a chunk (whole blocks), chunks a slot
  int cap;              // positions the cache holds for a slot
  float scale;
};

// 16 bytes as VE floats
__device__ __forceinline__ void to_floats(uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void to_floats(uint4 v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
// VE floats to 16 bytes at p
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// (m, l, acc) of another row group merged into this one's; both lanes
// of a pair compute the same bits (IEEE sums and products commute)
template <int VE>
__device__ __forceinline__ void merge_xor(float& m, float& l,
                                          float (&acc)[VE], int off) {
  const float mo = __shfl_xor_sync(0xffffffffu, m, off);
  const float lo = __shfl_xor_sync(0xffffffffu, l, off);
  const float mn = fmaxf(m, mo);
  const float a = expf(m - mn), b = expf(mo - mn);
  l = l * a + lo * b;
#pragma unroll
  for (int i = 0; i < VE; ++i) {
    const float ao = __shfl_xor_sync(0xffffffffu, acc[i], off);
    acc[i] = acc[i] * a + ao * b;
  }
  m = mn;
}

template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_split(const DecArgs& p, Addr addr) {
  using G = RowGeo<T, D>;
  constexpr int VE = G::VE, LPR = G::LPR, RPW = G::RPW;
  const int c = blockIdx.x, n = blockIdx.y, grp = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = grp * p.hg + warp;
  const bool head = h < p.H;
  const int len = max(0, min(p.lengths[n], p.cap));
  const int live = (len + p.chunk - 1) / p.chunk;
  const int rg = lane / LPR, e0 = (lane % LPR) * VE;
  const long long hd = static_cast<long long>(p.H) * D;
  const long long qoff = (static_cast<long long>(n) * p.H + h) * D + e0;
  T* out = static_cast<T*>(p.o);

  if (live == 0) {  // an empty slot emits zeros
    if (c == 0 && head && rg == 0) {
      float z[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) z[i] = 0.f;
      store16(out + qoff, z);
    }
    return;
  }
  if (c >= live) return;

  float m = NEG_INF, l = 0.f, acc[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i) acc[i] = 0.f;
  if (head) {
    const T* kc = static_cast<const T*>(p.k) + h * D + e0;
    const T* vc = static_cast<const T*>(p.v) + h * D + e0;
    float qv[VE];
    to_floats(load16(static_cast<const T*>(p.q) + qoff), qv);
    const int t_end = min(len, (c + 1) * p.chunk);
    for (int t0 = c * p.chunk; t0 < t_end; t0 += DEC_UNROLL * RPW) {
      long long rows[DEC_UNROLL];
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u) {
        const int t = t0 + u * RPW + rg;
        rows[u] = t < t_end ? addr.row(n, t) * hd : -1;
      }
      uint4 kr[DEC_UNROLL], vr[DEC_UNROLL];  // raw: 4 registers each
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u) {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (rows[u] >= 0) {
          kr[u] = load16(kc + rows[u]);
          vr[u] = load16(vc + rows[u]);
        }
      }
      float s[DEC_UNROLL];
      float mb = m;
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u) {
        float kv[VE], part = 0.f;
        to_floats(kr[u], kv);
#pragma unroll
        for (int i = 0; i < VE; ++i) part = fmaf(qv[i], kv[i], part);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = part * p.scale;
        if (rows[u] >= 0) mb = fmaxf(mb, s[u]);
      }
      const float corr = expf(m - mb);
      l *= corr;
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u)
        if (rows[u] >= 0) {
          const float pe = expf(s[u] - mb);
          float vv[VE];
          to_floats(vr[u], vv);
          l += pe;
#pragma unroll
          for (int i = 0; i < VE; ++i) acc[i] = fmaf(pe, vv[i], acc[i]);
        }
      m = mb;
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) merge_xor<VE>(m, l, acc, off);
  }

  const long long pi =  // this (slot, head, chunk)'s partial
      (static_cast<long long>(n) * p.H + h) * p.chunks + c;
  if (live == 1) {
    if (head && rg == 0) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[i] *= inv;
      store16(out + qoff, acc);
    }
    return;
  }
  if (head && rg == 0) {
#pragma unroll
    for (int i = 0; i < VE; i += 4)
      *reinterpret_cast<float4*>(p.acc + pi * D + e0 + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    if (lane == 0)
      *reinterpret_cast<float2*>(p.ml + 2 * pi) = make_float2(m, l);
  }
  __threadfence();
  __syncthreads();
  __shared__ int s_last;
  int* counter = p.counters + n * gridDim.z + grp;
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the merge, in chunk order; lane j holds chunks j, j + 32, ... of
  // the (m, l) partials
  if (head) {
    const long long base = (static_cast<long long>(n) * p.H + h) * p.chunks;
    float mx = NEG_INF;
    for (int j = lane; j < live; j += 32)
      mx = fmaxf(mx, __ldcg(p.ml + 2 * (base + j)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float lt = 0.f, o[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) o[i] = 0.f;
    for (int j0 = 0; j0 < live; j0 += 32) {
      float wj = 0.f, lj = 0.f;
      if (j0 + lane < live) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            p.ml + 2 * (base + j0 + lane)));
        wj = expf(v.x - mx);
        lj = v.y;
      }
      const int nj = min(32, live - j0);
      for (int j = 0; j < nj; ++j) {
        const float w = __shfl_sync(0xffffffffu, wj, j);
        lt = fmaf(__shfl_sync(0xffffffffu, lj, j), w, lt);
        if (rg == 0) {
          const float* a = p.acc + (base + j0 + j) * D + e0;
#pragma unroll
          for (int i = 0; i < VE; i += 4) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(a + i));
            o[i] = fmaf(v.x, w, o[i]);
            o[i + 1] = fmaf(v.y, w, o[i + 1]);
            o[i + 2] = fmaf(v.z, w, o[i + 2]);
            o[i + 3] = fmaf(v.w, w, o[i + 3]);
          }
        }
      }
    }
    if (rg == 0) {
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
#pragma unroll
      for (int i = 0; i < VE; ++i) o[i] *= inv;
      store16(out + qoff, o);
    }
  }
  if (threadIdx.x == 0) *counter = 0;  // for the next launch
}

}  // namespace ptt
