// Sorted-key range probe and fused probe-and-pick kernels for Hopper (sm_90a).
//
// sorted_probe replaces the two-phase Pallas pipeline of
//   src/repro/kernels/searchsorted.py :: fence_count_kernel + refine_kernel
//   (driven by _searchsorted_i32):
//   lo = #keys < q, hi = #keys <= q per query, against a sorted key column.
// probe_pick replaces
//   src/repro/kernels/walk.py :: hop_refine_pick_kernel (driven by _hop_i32):
//   the same search, then d = hi - lo and the ranged uniform pick
//   pos = lo + min(floor(u * max(d, 1)), max(d - 1, 0)) in float32.
//
// What bounds them on the H100: each query is two binary searches of
// ceil(log2(n + 1)) dependent loads.  At the main path's shapes (UQ1's
// lineitem index, ~3.6 M int32 keys = 14 MB, which stays resident in the
// 50 MB L2; one piece batch of 2.5-8 K queries per launch) that is ~22
// dependent L2 round trips per search and a grid of only 10-32 blocks, so
// the launch is bound by load latency and launch overhead, not by bytes or
// operations.
//
// What the design does about it: one thread per query, no shared memory and
// no synchronisation, so a launch costs one grid of independent searches.
// The TPU's gather-free design (a dense compare sweep over every 128th key,
// then a gathered 128-key refine block) is not carried over: Hopper gathers
// freely, and a branchless search (the loop trip count depends on n only, so
// a warp never diverges) reads ~2 log2(n) keys per query instead of sweeping
// all fences.  The two searches are independent, so their loads interleave.
// Staging the top levels of the search tree in shared memory is left for a
// later change.
//
// The pick multiplies with __fmul_rn and the library is built with
// -fmad=false, so the float32 product is rounded exactly as the reference's
// and the pick equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// #keys[i] < q (Less = true) or #keys[i] <= q (Less = false) over a sorted
// array; the trip count depends on n only (branch-free select per level).
template <typename K, bool Less>
__device__ __forceinline__ int count_below(const K* __restrict__ keys, int n,
                                           K q) {
  if (n <= 0) return 0;
  int base = 0;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
    const K k = __ldg(keys + base + half);
    const bool go = Less ? (k < q) : (k <= q);
    base = go ? base + half : base;
    len -= half;
  }
  const K k = __ldg(keys + base);
  return base + ((Less ? (k < q) : (k <= q)) ? 1 : 0);
}

template <typename K>
__global__ void sorted_probe_kernel(const K* __restrict__ keys, int n,
                                    const K* __restrict__ queries, int nq,
                                    int* __restrict__ lo,
                                    int* __restrict__ hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const K q = queries[i];
  lo[i] = count_below<K, true>(keys, n, q);
  hi[i] = count_below<K, false>(keys, n, q);
}

template <typename K>
__global__ void probe_pick_kernel(const K* __restrict__ keys, int n,
                                  const K* __restrict__ queries,
                                  const float* __restrict__ u, int nq,
                                  int* __restrict__ pos,
                                  int* __restrict__ deg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const K q = queries[i];
  const int l = count_below<K, true>(keys, n, q);
  const int h = count_below<K, false>(keys, n, q);
  const int d = h - l;
  const float scaled = __fmul_rn(u[i], __int2float_rn(max(d, 1)));
  int off = __float2int_rz(floorf(scaled));
  off = min(off, max(d - 1, 0));
  pos[i] = l + off;
  deg[i] = d;
}

constexpr int kThreads = 256;

inline int blocks_for(long long nq) {
  return static_cast<int>((nq + kThreads - 1) / kThreads);
}

// The launchers' return value: the kernels launched, or minus the CUDA error.
inline int launched_or_error(int launched) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launched : -static_cast<int>(err);
}

template <typename K>
int launch_sorted_probe(const void* keys, long long n, const void* queries,
                        long long nq, void* lo, void* hi, void* stream) {
  if (nq <= 0) return launched_or_error(0);
  sorted_probe_kernel<K><<<blocks_for(nq), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(keys), static_cast<int>(n),
      static_cast<const K*>(queries), static_cast<int>(nq),
      static_cast<int*>(lo), static_cast<int*>(hi));
  return launched_or_error(1);
}

template <typename K>
int launch_probe_pick(const void* keys, long long n, const void* queries,
                      const void* u, long long nq, void* pos, void* deg,
                      void* stream) {
  if (nq <= 0) return launched_or_error(0);
  probe_pick_kernel<K><<<blocks_for(nq), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(keys), static_cast<int>(n),
      static_cast<const K*>(queries), static_cast<const float*>(u),
      static_cast<int>(nq), static_cast<int*>(pos), static_cast<int*>(deg));
  return launched_or_error(1);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns the number of kernels it
// launched (1; 0 when there is no query), or minus the CUDA error.
extern "C" {

int repro_sorted_probe_i32(const void* keys, long long n, const void* queries,
                           long long nq, void* lo, void* hi, void* stream) {
  return launch_sorted_probe<int32_t>(keys, n, queries, nq, lo, hi, stream);
}

int repro_sorted_probe_i64(const void* keys, long long n, const void* queries,
                           long long nq, void* lo, void* hi, void* stream) {
  return launch_sorted_probe<int64_t>(keys, n, queries, nq, lo, hi, stream);
}

int repro_probe_pick_i32(const void* keys, long long n, const void* queries,
                         const void* u, long long nq, void* pos, void* deg,
                         void* stream) {
  return launch_probe_pick<int32_t>(keys, n, queries, u, nq, pos, deg, stream);
}

int repro_probe_pick_i64(const void* keys, long long n, const void* queries,
                         const void* u, long long nq, void* pos, void* deg,
                         void* stream) {
  return launch_probe_pick<int64_t>(keys, n, queries, u, nq, pos, deg, stream);
}

}  // extern "C"
