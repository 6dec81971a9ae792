// One-token GQA decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention.py :: decode_attn_kernel (driven by
// _decode_attn): q (B, H, D) against k/v (B, S, KVH, D) with per-row
// lengths, query head h reading KV head h / G (G = H / KVH), logits
// (q . k) * scale, optionally softcap * tanh(logits / softcap), masked to
// s < length (and s >= length - window when window > 0), an fp32 online
// softmax, and the output acc / max(l, 1e-30) in q's dtype.  f32 or bf16;
// D in {16, 64, 112, 128, 256}; G from 1 to 48; any S.
//
// What bounds it on the H100: bytes.  Every kept K and V row is read once
// and feeds 4 * G * D flops, about G flops per byte in bf16, far below the
// ~295 flops per byte at which the tensor cores would be the limit.  At
// gemma-2-9b's widths (B 8, S 8192, KVH 8, D 256, bf16) K and V are 537 MB.
//
// What the design does about it:
// * Work items of at most 8 query heads.  A KV head's G query heads are
//   cut into C = ceil(G / 8) chunks of floor or ceil of G / C heads, and a
//   "pair" below is one (b, kv head, chunk) item: at G <= 8 one item per
//   (b, kv head), at G 48 (MQA, granite-20b) six items of 8 heads.  Each
//   item reads its K/V rows, so K/V are read C times; the (8, D) query tile
//   keeps the per-lane state in registers at every G.
// * Rows of any supported width.  In shared memory a row is padded to DP,
//   the next multiple of 64 elements (16 -> 64, 112 -> 128): the copy
//   zero-fills the pad (it reads no byte of it) and q's pad is zero, so the
//   pad adds nothing to a logit and its output columns are not written.
//   Global rows stay D wide (16 * sizeof(T) divides D * sizeof(T)).
// * One wave of balanced work.  The kept rows [max(len - window, 0),
//   min(len, S)) of every pair are cut into tiles of kRows
//   rows, and the tiles of all pairs, in pair order, form one sequence.  A
//   plan kernel (one block) takes the prefix sum of the tile counts from
//   `lengths` on the device, so there is no host sync, and the attention
//   kernel's CTAs, as many as the SMs hold at once, each take an equal run
//   of whole tiles.  A CTA finds its first pair by binary search in that
//   prefix sum and may cross pair boundaries; a pair may span CTAs.
// * Bytes in flight that do not depend on registers.  K and V tiles go
//   through a ring of kStages stages in shared memory, filled with
//   cp.async (16 bytes a thread, L2 only), so the next tile's loads are in
//   flight while the current one is computed, and the other CTA of the SM
//   computes while this one waits.  Rows past the end of a pair are
//   zero-filled by the copy and masked.
// * Scores without a shuffle tree per row.  The item's q heads (GM x DP,
//   in q's own dtype, so bf16 q reads half the bytes) sit in shared
//   memory.  Eight lanes score one row (three shuffles per head), so a
//   warp scores four rows at once and keeps one online-softmax state for
//   them per head: one max, one rescale and one exp per row and head, and
//   P.V in fp32 FMA from the staged V tile.  The softcap's tanhf stays the
//   accurate one (the f32 limit is 2e-5).
// * A small merge.  At the end of each (CTA, pair) segment the warps merge
//   their states through shared memory, so a CTA writes one partial per
//   (pair, head).  A pair that one CTA covers whole is written straight to
//   the output; otherwise the last CTA to finish the pair (an atomic
//   counter per pair) merges its few partials.  Pairs with no kept row are
//   zeroed by the plan kernel, so a length-0 row gives zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;                      // rows of K (and V) per tile
constexpr int kRowsPerWarp = kRows / kWarps;   // 4: eight lanes per row
// ring of K/V tiles: with two CTAs an SM, two stages measured faster than
// three (and three with one CTA an SM slower still) at gemma-2's widths
constexpr int kStages = 2;
constexpr int kPlanThreads = 1024;
constexpr float kNegInf = -1e30f;              // the reference's masked logit
constexpr int kMaxItemHeads = 8;               // query heads per work item
constexpr int kMaxGroup = 48;                  // query heads per KV head

// The work items: (b, kv head, chunk) triples p = (b * KVH + kvh) * C + c,
// where chunk c of a KV head's G query heads is [c * G / C, (c + 1) * G / C).
struct Items {
  int KVH, C, G;

  __host__ __device__ static int chunks(int G) {
    return (G + kMaxItemHeads - 1) / kMaxItemHeads;
  }
  // the most query heads of one item: ceil(G / C) <= 8
  __host__ __device__ static int max_heads(int G) {
    return (G + chunks(G) - 1) / chunks(G);
  }
  __device__ __forceinline__ int batch(int p) const { return p / (KVH * C); }
  __device__ __forceinline__ int kv_head(int p) const { return (p / C) % KVH; }
  // the item's first query head in the (B, H, D) layout of q, and its count
  __device__ __forceinline__ int head0(int p) const {
    return kv_head(p) * G + (p % C) * G / C;
  }
  __device__ __forceinline__ int heads(int p) const {
    const int c = p % C;
    return (c + 1) * G / C - c * G / C;
  }
};

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      o[i] = t.x;
      o[i + 1] = t.y;
      o[i + 2] = t.z;
      o[i + 3] = t.w;
    }
  } else {
    static_assert(N == 2, "padded rows of 64, 128 or 256 elements");
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  } else {
    static_assert(N == 2, "padded rows of 64, 128 or 256 elements");
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x;
    o[1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The kept rows [lo, hi) of batch row b (empty when hi <= lo).
__device__ __forceinline__ void kept_rows(const int* __restrict__ lengths,
                                          int b, int S, int window, int& lo,
                                          int& hi) {
  const int len = max(lengths[b], 0);
  hi = min(len, S);
  lo = window > 0 ? max(len - window, 0) : 0;
}

// Exclusive prefix sum of v over the block; `total` gets the block's sum.
// `sh` holds one value per warp.
__device__ long long block_scan(long long v, long long* sh, long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    long long s = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) sh[lane] = s;
  }
  __syncthreads();
  const long long pre = (w > 0 ? sh[w - 1] : 0) + x - v;
  total = sh[nw - 1];
  __syncthreads();
  return pre;
}

// The plan (one block): for the NP work items p (pairs, see Items),
// tile_start[p] = tiles of the pairs before p (tile_start[NP] = all tiles),
// tiles per CTA, and seg_start[p] = partial slots of the pairs before p,
// where a pair owns one slot for each CTA that covers part of it.  Zeroes
// the pairs' counters and the output of every pair with no kept row.
template <typename T>
__global__ void __launch_bounds__(kPlanThreads)
decode_attn_plan_kernel(const int* __restrict__ lengths, int NP, int S,
                        Items items, int H, int D, int window, int ctas,
                        long long* __restrict__ tile_start,
                        int* __restrict__ seg_start, int* __restrict__ count,
                        long long* __restrict__ meta, T* __restrict__ out) {
  __shared__ long long sh[32];
  long long carry = 0, total;
  for (int base = 0; base < NP; base += blockDim.x) {
    const int p = base + threadIdx.x;
    long long tiles = 0;
    if (p < NP) {
      int lo, hi;
      kept_rows(lengths, items.batch(p), S, window, lo, hi);
      tiles = hi > lo ? (hi - lo + kRows - 1) / kRows : 0;
      count[p] = 0;
      if (tiles == 0) {
        T* o = out + (static_cast<size_t>(items.batch(p)) * H
                      + items.head0(p)) * D;
        for (int i = 0; i < items.heads(p) * D; ++i) store(o + i, 0.f);
      }
    }
    const long long pre = block_scan(tiles, sh, total);
    if (p < NP) tile_start[p] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) tile_start[NP] = carry;
  const long long n_tiles = carry;
  const long long per_cta = n_tiles > ctas ? (n_tiles + ctas - 1) / ctas : 1;
  __syncthreads();
  carry = 0;
  for (int base = 0; base < NP; base += blockDim.x) {
    const int p = base + threadIdx.x;
    long long slots = 0;
    if (p < NP) {
      const long long s = tile_start[p], e = tile_start[p + 1];
      slots = e > s ? (e - 1) / per_cta - s / per_cta + 1 : 0;
    }
    const long long pre = block_scan(slots, sh, total);
    if (p < NP) seg_start[p] = static_cast<int>(carry + pre);
    carry += total;
  }
  if (threadIdx.x == 0) {
    seg_start[NP] = static_cast<int>(carry);
    meta[0] = n_tiles;
    meta[1] = per_cta;
  }
}

template <typename T, int D>
struct Shape {
  static constexpr int E = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int DP = (D + 63) / 64 * 64;  // a row in shared memory
  static constexpr int CH = DP / E;           // 16-byte chunks per padded row
  static constexpr int CR = D / E;            // ... of them holding the row
  static constexpr int TILE = kRows * DP;     // elements of a K or V tile
  static constexpr int N = DP / 32;           // elements per lane in P.V
  static_assert(D % E == 0, "rows of whole 16-byte chunks");
  static_assert(CH % 8 == 0, "eight lanes score a row");
};

template <typename T, int D, int GM>
constexpr int smem_bytes() {
  using Sh = Shape<T, D>;
  return static_cast<int>(kStages * 2 * Sh::TILE * sizeof(T)
                          + GM * Sh::DP * sizeof(T)
                          + kWarps * (Sh::DP + 2) * sizeof(float) + 16);
}

// Where a CTA stands in its run of tiles: global tile t of pair p, whose
// tiles are [first, end) and whose kept rows are [lo, hi).
struct Cursor {
  long long t, first, end;
  int p, lo, hi, b, kvh;    // b and kv head of pair p, set on entering it
};

struct Plan {
  const int* lengths;
  const long long* tile_start;
  int S, window;
  Items items;

  __device__ __forceinline__ void enter(Cursor& c) const {
    c.first = tile_start[c.p];
    c.end = tile_start[c.p + 1];
    c.b = items.batch(c.p);
    c.kvh = items.kv_head(c.p);
    kept_rows(lengths, c.b, S, window, c.lo, c.hi);
  }
  // the next tile; past t1 the cursor is left as it is
  __device__ __forceinline__ void advance(Cursor& c, long long t1) const {
    if (++c.t < c.end || c.t >= t1) return;
    do {
      ++c.p;
    } while (tile_start[c.p + 1] <= c.t);   // skip pairs with no rows
    enter(c);
  }
};

// The K and V rows of the cursor's tile into one ring stage (K tile, then
// V tile, kRows x DP each); rows past the pair's end and each row's pad
// past D are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* stage, const Cursor& c,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const Plan& plan) {
  using Sh = Shape<T, D>;
  const int row0 = c.lo + static_cast<int>(c.t - c.first) * kRows;
  const size_t stride = static_cast<size_t>(plan.items.KVH) * D;
  const size_t base = (static_cast<size_t>(c.b) * plan.S + row0) * stride
                      + static_cast<size_t>(c.kvh) * D;
  static_assert(2 * kRows * Sh::CH % kThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < 2 * kRows * Sh::CH / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int which = i / (kRows * Sh::CH);          // 0: K, 1: V
    const int j = i - which * kRows * Sh::CH;
    const int r = j / Sh::CH, ch = j - r * Sh::CH;
    const T* src = which ? v : k;
    const bool ok = row0 + r < c.hi && ch < Sh::CR;
    cp_async16(stage + which * Sh::TILE + r * Sh::DP + ch * Sh::E,
               ok ? src + base + r * stride + ch * Sh::E : src, ok);
  }
}

// Grid: as many CTAs as the SMs hold at once; CTA c takes tiles
// [c * per_cta, (c + 1) * per_cta) of the plan's sequence.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, Plan plan, int NP, int H,
                   float scale, float softcap,
                   const int* __restrict__ seg_start, int* __restrict__ count,
                   const long long* __restrict__ meta,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   T* __restrict__ out) {
  using Sh = Shape<T, D>;
  constexpr int N = Sh::N;
  constexpr int E = Sh::E;
  constexpr int DP = Sh::DP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = ring + kStages * 2 * Sh::TILE;    // q of the pair, in its dtype
  float* mb = reinterpret_cast<float*>(qs + GM * DP);  // warps' states
  int* last = reinterpret_cast<int*>(mb + kWarps * (DP + 2));
  const int GI = Items::max_heads(plan.items.G);  // partial slots' heads

  const long long n_tiles = meta[0], per_cta = meta[1];
  const long long t0 = static_cast<long long>(blockIdx.x) * per_cta;
  if (t0 >= n_tiles) return;
  const long long t1 = min(t0 + per_cta, n_tiles);
  const long long n = t1 - t0;

  // the first pair: the last p with tile_start[p] <= t0
  int lo = 0, hi = NP;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (plan.tile_start[mid] <= t0) lo = mid; else hi = mid - 1;
  }
  Cursor ld;
  ld.t = t0;
  ld.p = lo;
  plan.enter(ld);
  Cursor cur = ld;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = warp * kRowsPerWarp + (lane >> 3);  // the row it scores
  const int part = lane & 7;                          // its eighth of it
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  int b = 0, h0 = 0, nh = 0;   // the current pair's batch row and heads
  float m[GM], l[GM], acc[GM][N];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) {
      load_tile<T, D>(ring + s * 2 * Sh::TILE, ld, k, v, plan);
      plan.advance(ld, t1);
    }
    cp_async_commit();
  }
  for (long long i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // tile i has landed; stage i - 1 is free
    if (i + kStages - 1 < n) {
      load_tile<T, D>(ring + ((i + kStages - 1) % kStages) * 2 * Sh::TILE,
                      ld, k, v, plan);
      plan.advance(ld, t1);
    }
    cp_async_commit();
    if (i == 0 || cur.t == cur.first) {       // a new pair: its q heads
      b = cur.b;
      h0 = plan.items.head0(cur.p);
      nh = plan.items.heads(cur.p);
      for (int j = tid; j < GM * DP; j += kThreads) {
        const int g = j / DP, d = j - g * DP;
        store(qs + j, g < nh && d < D
                          ? to_float(q[(static_cast<size_t>(b) * H + h0 + g)
                                       * D + d])
                          : 0.f);
      }
      __syncthreads();
    }
    const T* ks = ring + (i % kStages) * 2 * Sh::TILE;
    const T* vs = ks + Sh::TILE;
    const int valid = cur.hi - cur.lo
                      - static_cast<int>(cur.t - cur.first) * kRows;
    const bool ok = row < valid;

    // this lane's eighth of its row's logits, for every head
    float x[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) x[g] = 0.f;
#pragma unroll
    for (int j = 0; j < Sh::CH / 8; ++j) {
      const int c = part + 8 * j;
      float kf[E];
      load_row<E>(ks + row * DP + c * E, kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float qf[E];
        load_row<E>(qs + g * DP + c * E, qf);
#pragma unroll
        for (int e = 0; e < E; ++e) x[g] = __fmaf_rn(qf[e], kf[e], x[g]);
      }
    }
    // one online-softmax step per head for the warp's four rows
    float alpha[GM], pr[GM][kRowsPerWarp];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        x[g] += __shfl_xor_sync(0xffffffffu, x[g], o);
      }
      float t = x[g] * scale;
      if (softcap > 0.f) t = softcap * tanhf(t * inv_cap);
      t = ok ? t : kNegInf;
      float mx = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(m[g], mx);
      alpha[g] = expf(m[g] - mx);
      const float p = ok ? expf(t - mx) : 0.f;
      float ps = p + __shfl_xor_sync(0xffffffffu, p, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[g] = __fmaf_rn(l[g], alpha[g], ps);
      m[g] = mx;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pr[g][r] = __shfl_sync(0xffffffffu, p, 8 * r);
      }
    }
    // P.V: each lane owns N columns of the warp's four V rows
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] *= alpha[g];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float vf[N];
      load_row<N>(vs + (warp * kRowsPerWarp + r) * DP + lane * N, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          acc[g][e] = __fmaf_rn(pr[g][r], vf[e], acc[g][e]);
        }
      }
    }

    if (cur.t + 1 == cur.end || i + 1 == n) {
      // the end of this CTA's part of the pair: merge the warps, then write
      // the output (the CTA covers the pair whole) or a partial
      const long long cta0 = cur.first / per_cta;
      const int slots = static_cast<int>((cur.end - 1) / per_cta - cta0 + 1);
      const int slot = seg_start[cur.p] + static_cast<int>(blockIdx.x - cta0);
      const size_t bh0 = static_cast<size_t>(b) * H + h0;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= nh) break;
        float* w = mb + warp * (DP + 2);
#pragma unroll
        for (int e = 0; e < N; ++e) w[lane * N + e] = acc[g][e];
        if (lane == 0) {
          w[DP] = m[g];
          w[DP + 1] = l[g];
        }
        __syncthreads();
        if (tid < D) {
          float M = kNegInf;
#pragma unroll
          for (int j = 0; j < kWarps; ++j) M = fmaxf(M, mb[j * (DP + 2) + DP]);
          float L = 0.f, A = 0.f;
#pragma unroll
          for (int j = 0; j < kWarps; ++j) {
            const float s = expf(mb[j * (DP + 2) + DP] - M);
            L = __fmaf_rn(mb[j * (DP + 2) + DP + 1], s, L);
            A = __fmaf_rn(mb[j * (DP + 2) + tid], s, A);
          }
          if (slots == 1) {
            store(out + (bh0 + g) * D + tid, A / fmaxf(L, 1e-30f));
          } else {
            const size_t ps = static_cast<size_t>(slot) * GI + g;
            part_acc[ps * D + tid] = A;
            if (tid == 0) {
              part_ml[ps * 2] = M;
              part_ml[ps * 2 + 1] = L;
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
      }
      if (slots > 1) {
        // the last CTA to finish the pair merges its partials
        __threadfence();
        __syncthreads();
        if (tid == 0) *last = atomicAdd(count + cur.p, 1) == slots - 1;
        __syncthreads();
        if (*last) {
          __threadfence();
          const size_t s0 = static_cast<size_t>(seg_start[cur.p]);
          for (int j = tid; j < nh * D; j += kThreads) {
            const int g = j / D, d = j - g * D;
            float M = kNegInf;
            for (int s = 0; s < slots; ++s) {
              M = fmaxf(M, __ldcg(part_ml + ((s0 + s) * GI + g) * 2));
            }
            float L = 0.f, A = 0.f;
            for (int s = 0; s < slots; ++s) {
              const size_t ps = (s0 + s) * GI + g;
              const float w = expf(__ldcg(part_ml + ps * 2) - M);
              L = __fmaf_rn(__ldcg(part_ml + ps * 2 + 1), w, L);
              A = __fmaf_rn(__ldcg(part_acc + ps * D + d), w, A);
            }
            store(out + (bh0 + g) * D + d, A / fmaxf(L, 1e-30f));
          }
        }
      }
    }
    plan.advance(cur, t1);
  }
}

// Byte offsets of the scratch: the plan's arrays and the partial slots
// (at most one per CTA plus one per pair), each of max_heads(G) heads.
struct Layout {
  long long tile_start, meta, acc, ml, seg_start, count, bytes;
  Layout(long long B, long long H, long long KVH, long long D, long long ctas) {
    const int g = static_cast<int>(H / KVH);
    const long long NP = B * KVH * Items::chunks(g);
    const long long G = Items::max_heads(g), slots = ctas + NP;
    auto up = [](long long x) { return (x + 15) / 16 * 16; };
    tile_start = 0;
    meta = up((NP + 1) * 8);
    acc = meta + 16;
    ml = up(acc + slots * G * D * 4);
    seg_start = up(ml + slots * G * 2 * 4);
    count = up(seg_start + (NP + 1) * 4);
    bytes = up(count + NP * 4);
  }
};

// Dispatch to the instantiation for D and the query heads of a work item
// (GM >= Items::max_heads(G)).
template <typename T, int D, typename F>
int with_group(long long G, const F& f) {
  const int gi = Items::max_heads(static_cast<int>(G));
  if (gi <= 1) return f.template run<T, D, 1>();
  if (gi <= 2) return f.template run<T, D, 2>();
  if (gi <= 4) return f.template run<T, D, 4>();
  return f.template run<T, D, 8>();
}

template <typename T, typename F>
int with_kernel(long long D, long long G, const F& f) {
  if (D == 16) return with_group<T, 16>(G, f);
  if (D == 64) return with_group<T, 64>(G, f);
  if (D == 112) return with_group<T, 112>(G, f);
  if (D == 128) return with_group<T, 128>(G, f);
  return with_group<T, 256>(G, f);
}

// CTAs of one wave: the blocks an SM holds at once, times the SMs.
struct CtasQuery {
  int num_sms;
  template <typename T, int D, int GM>
  int run() const {
    const int bytes = smem_bytes<T, D, GM>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, D, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_attn_kernel<T, D, GM>, kThreads, bytes);
    }
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (per_sm <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
    return per_sm * num_sms;
  }
};

struct SmemQuery {
  template <typename T, int D, int GM>
  int run() const { return smem_bytes<T, D, GM>(); }
};

struct Launch {
  const void *q, *k, *v;
  Plan plan;
  int NP, H, ctas;
  float scale, softcap;
  const int* seg_start;
  int* count;
  const long long* meta;
  float *acc, *ml;
  void* out;
  cudaStream_t st;

  template <typename T, int D, int GM>
  int run() const {
    const int bytes = smem_bytes<T, D, GM>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, D, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return -static_cast<int>(err);
    decode_attn_kernel<T, D, GM><<<ctas, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), plan, NP, H, scale, softcap, seg_start,
        count, meta, acc, ml, static_cast<T*>(out));
    err = cudaGetLastError();
    return err == cudaSuccess ? 0 : -static_cast<int>(err);
  }
};

bool valid_shape(long long B, long long H, long long S, long long KVH,
                 long long D) {
  return B > 0 && H > 0 && S >= 0 && KVH > 0 && H % KVH == 0
         && H / KVH <= kMaxGroup
         && (D == 16 || D == 64 || D == 112 || D == 128 || D == 256)
         && B * KVH * Items::chunks(static_cast<int>(H / KVH)) <= (1LL << 24)
         && S <= (1LL << 30) && B * S <= (1LL << 40);
}

template <typename T>
int launch_decode_attention(const void* q, const void* k, const void* v,
                            const void* lengths, long long B, long long H,
                            long long S, long long KVH, long long D,
                            float scale, float softcap, long long window,
                            int ctas, void* scratch, long long n_scratch,
                            void* out, void* stream) {
  if (!valid_shape(B, H, S, KVH, D) || window < 0 || ctas <= 0
      || n_scratch < Layout(B, H, KVH, D, ctas).bytes) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay(B, H, KVH, D, ctas);
  char* base = static_cast<char*>(scratch);
  long long* tile_start = reinterpret_cast<long long*>(base + lay.tile_start);
  long long* meta = reinterpret_cast<long long*>(base + lay.meta);
  int* seg_start = reinterpret_cast<int*>(base + lay.seg_start);
  int* count = reinterpret_cast<int*>(base + lay.count);
  const int G = static_cast<int>(H / KVH);
  const Items items{static_cast<int>(KVH), Items::chunks(G), G};
  const int NP = static_cast<int>(B * KVH) * items.C;
  const int s = static_cast<int>(S);
  const int w = static_cast<int>(std::min(window, 1LL << 30));
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_attn_plan_kernel<T><<<1, kPlanThreads, 0, st>>>(
      len, NP, s, items, static_cast<int>(H), static_cast<int>(D), w, ctas,
      tile_start, seg_start, count, meta, static_cast<T*>(out));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Launch f{q, k, v, Plan{len, tile_start, s, w, items}, NP,
                 static_cast<int>(H), ctas, scale, softcap, seg_start,
                 count, meta, reinterpret_cast<float*>(base + lay.acc),
                 reinterpret_cast<float*>(base + lay.ml), out, st};
  const int rc = with_kernel<T>(D, G, f);
  return rc < 0 ? rc : 2;
}

}  // namespace

// Plain C interface (loaded with ctypes).  The launcher runs on the given
// stream, does not synchronise, and returns the number of kernels it
// launched (2: the plan and the attention kernel), or minus the CUDA
// error.  The caller takes `ctas` from repro_decode_attention_ctas,
// allocates `scratch` (repro_decode_attention_scratch_bytes of the same
// shape and ctas, 16-byte aligned) and `out` (B, H, D) in the inputs'
// dtype; lengths are int32.
extern "C" {

// CTAs of one wave of the attention kernel for this group size, head
// width and dtype (minus the CUDA error if the query fails).
int repro_decode_attention_ctas(long long H, long long KVH, long long D,
                                int bf16, int num_sms) {
  if (!valid_shape(1, H, 0, KVH, D) || num_sms <= 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const CtasQuery f{num_sms};
  return bf16 ? with_kernel<__nv_bfloat16>(D, H / KVH, f)
              : with_kernel<float>(D, H / KVH, f);
}

// Dynamic shared memory of one CTA of that instantiation, in bytes.
int repro_decode_attention_smem_bytes(long long H, long long KVH, long long D,
                                      int bf16) {
  if (!valid_shape(1, H, 0, KVH, D)) return -1;
  return bf16 ? with_kernel<__nv_bfloat16>(D, H / KVH, SmemQuery{})
              : with_kernel<float>(D, H / KVH, SmemQuery{});
}

long long repro_decode_attention_scratch_bytes(long long B, long long H,
                                               long long KVH, long long D,
                                               int ctas) {
  return Layout(B, H, KVH, D, ctas).bytes;
}

int repro_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* lengths, long long B, long long H,
                               long long S, long long KVH, long long D,
                               float scale, float softcap, long long window,
                               int ctas, void* scratch, long long n_scratch,
                               void* out, void* stream) {
  return launch_decode_attention<float>(q, k, v, lengths, B, H, S, KVH, D,
                                        scale, softcap, window, ctas,
                                        scratch, n_scratch, out, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* lengths, long long B, long long H,
                                long long S, long long KVH, long long D,
                                float scale, float softcap, long long window,
                                int ctas, void* scratch, long long n_scratch,
                                void* out, void* stream) {
  return launch_decode_attention<__nv_bfloat16>(
      q, k, v, lengths, B, H, S, KVH, D, scale, softcap, window, ctas,
      scratch, n_scratch, out, stream);
}

}  // extern "C"
