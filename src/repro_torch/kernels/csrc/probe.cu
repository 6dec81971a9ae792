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
// What bounds them on the H100: at the main path's shapes (UQ1's orders
// and lineitem indexes, 0.9-3.6 M keys, which stay resident in the 50 MB
// L2; one piece batch of 2.5-8 K queries per launch) a search reads a few
// dozen keys per query, so bytes are far below the card's rate.  What costs
// time is the chain of dependent loads (each an L2 round trip, unless L1
// holds the key), the instructions spent per level on all lanes, and the
// launch.
//
// What the design does about it.  Both kernels run one search routine,
// group_search, which gives each query a group of G lanes (several queries
// share a warp).  Each level cuts the range still unknown into G + 1 parts:
// lane j loads the j-th splitter, all loads issued together, and
// __ballot_sync + __popc count the splitters below q, for < and for <=,
// which narrows each range to one part.  So a search takes
// ceil(log_{G+1}(n + 1)) dependent loads where a binary search takes
// ceil(log2(n + 1)): at UQ1's lineitem index (3.6 M keys) 7 with G = 8 and
// 6 with G = 16 instead of 22.  lo and hi share their loads while their
// ranges coincide (until a splitter equals q); after that each lane loads
// once for each.  The last level, with at most G keys left, reads them all
// and is exact.  The top levels read the same keys for every query and hit
// L1 (__ldg).  A level costs one 32-bit division by a constant and a
// multiply per lane: splitters placed with a 64-bit division each made the
// search bound by instructions, not loads.  The TPU's gather-free design (a
// dense compare sweep over every 128th key, then a gathered 128-key refine
// block) is not carried over: Hopper gathers freely.
//
// G is a template parameter with one constant per kernel, each chosen by
// timing 8, 16 and 32 on the indexes that the kernel probes on the main
// path (scripts/kernel_variants.py): sorted_probe probes the weighted nodes
// (UQ1's orders index is the largest), probe_pick the uniform leaves and
// the residual nodes (UQ1's lineitem index, UQ4's pref).  G = 32 moves
// twice the L2 sectors per level of G = 16.
//
// probe_pick makes its pick in lane 0 of each group, after the search.
// That lane loads u before the search, so the load's latency hides behind
// the search's.  The pick multiplies with __fmul_rn and the library is
// built with -fmad=false, so the float32 product is rounded exactly as the
// reference's and the pick equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// lanes per query of each kernel: 8, 16 or 32
constexpr int kSortedProbeGroup = 16;
constexpr int kProbePickGroup = 8;
constexpr unsigned kFull = 0xffffffffu;

// The answer a of one search lies in [base, base + len]; the keys at
// [base, base + len) are not read yet.  A level cuts them into parts of
// step - 1 keys with step = ceil((len + 1) / (G + 1)): lane j reads the
// splitter base + (j + 1) * step - 1 where it lies in the range, and if c
// splitters are below q the answer lies in the part after the c-th, which
// holds at most floor(len / (G + 1)) keys.  Once len <= G, step is 1: the
// lanes read every key left and the answer is exact.  A range of len 0
// reads nothing and stays.
template <int G>
struct Range {
  unsigned base, len;

  __device__ __forceinline__ unsigned step() const {
    return (len + G + 1) / (G + 1);
  }
  __device__ __forceinline__ void narrow(unsigned step, int c) {
    base += c * step;
    len = min(len - c * step, step - 1);
  }
};

// The query of the calling lane's group: G consecutive lanes per query.
template <int G>
__device__ __forceinline__ long long group_query() {
  return (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
}

// (#keys < q, #keys <= q) over n sorted keys for the query of the calling
// lane's group of G lanes.  Every lane of the warp must call it, since each
// level's ballots span the whole warp; a lane without a query passes n = 0,
// reads nothing and gets (0, 0).
template <typename K, int G>
__device__ __forceinline__ uint2 group_search(const K* __restrict__ keys,
                                              unsigned n, K q) {
  static_assert(32 % G == 0, "a group is a whole part of a warp");
  const unsigned lane = threadIdx.x & 31;
  const unsigned j = lane % G;
  const unsigned group = (G == 32 ? kFull : (1u << G) - 1) << (lane - j);
  Range<G> below{0u, n};   // lo = #keys < q
  Range<G> upto = below;   // hi = #keys <= q
  while (__any_sync(kFull, below.len > 0 || upto.len > 0)) {
    const bool shared = below.base == upto.base && below.len == upto.len;
    const unsigned sl = below.step(), sh = upto.step();
    const unsigned el = (j + 1) * sl, eh = (j + 1) * sh;
    const bool rl = el <= below.len, rh = eh <= upto.len;
    const K kl = rl ? __ldg(keys + below.base + el - 1) : K(0);
    K kh = kl;
    if (!shared && rh) kh = __ldg(keys + upto.base + eh - 1);
    below.narrow(sl, __popc(__ballot_sync(kFull, rl && kl < q) & group));
    upto.narrow(sh, __popc(__ballot_sync(kFull, rh && kh <= q) & group));
  }
  return make_uint2(below.base, upto.base);
}

template <typename K, int G>
__global__ void __launch_bounds__(kThreads)
sorted_probe_kernel(const K* __restrict__ keys, int n,
                    const K* __restrict__ queries, int nq,
                    int* __restrict__ lo, int* __restrict__ hi) {
  const long long i = group_query<G>();
  const bool live = i < nq;
  const uint2 r = group_search<K, G>(keys, live ? n : 0,
                                     live ? queries[i] : K(0));
  if (live && threadIdx.x % G == 0) {
    lo[i] = static_cast<int>(r.x);
    hi[i] = static_cast<int>(r.y);
  }
}

template <typename K, int G>
__global__ void __launch_bounds__(kThreads)
probe_pick_kernel(const K* __restrict__ keys, int n,
                  const K* __restrict__ queries,
                  const float* __restrict__ u, int nq,
                  int* __restrict__ pos, int* __restrict__ deg) {
  const long long i = group_query<G>();
  const bool live = i < nq;
  const bool picker = live && threadIdx.x % G == 0;
  const float ui = picker ? u[i] : 0.0f;
  const uint2 r = group_search<K, G>(keys, live ? n : 0,
                                     live ? queries[i] : K(0));
  if (picker) {
    const int l = static_cast<int>(r.x);
    const int d = static_cast<int>(r.y) - l;
    const float scaled = __fmul_rn(ui, __int2float_rn(max(d, 1)));
    const int off = min(__float2int_rz(floorf(scaled)), max(d - 1, 0));
    pos[i] = l + off;
    deg[i] = d;
  }
}

inline int blocks_for(long long lanes) {
  return static_cast<int>((lanes + kThreads - 1) / kThreads);
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
  sorted_probe_kernel<K, kSortedProbeGroup>
      <<<blocks_for(nq * kSortedProbeGroup), kThreads, 0,
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
  probe_pick_kernel<K, kProbePickGroup>
      <<<blocks_for(nq * kProbePickGroup), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const K*>(keys), static_cast<int>(n),
          static_cast<const K*>(queries), static_cast<const float*>(u),
          static_cast<int>(nq), static_cast<int*>(pos),
          static_cast<int*>(deg));
  return launched_or_error(1);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns the number of kernels it
// launched (1; 0 when there is no query), or minus the CUDA error.
extern "C" {

// lanes per query of each kernel
int repro_sorted_probe_group() { return kSortedProbeGroup; }
int repro_probe_pick_group() { return kProbePickGroup; }

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
