// Segment-degree statistics of a sorted key column for Hopper (sm_90a).
//
// Replaces src/repro/kernels/segdegree.py :: segdegree_kernel (driven by
// _segdegree_i32): (distinct_count, max_degree) of a sorted int32 or int64
// key column, i.e. the number of runs of equal keys and the longest run.
//
// What bounds it on the H100: each key is read once and compared with its
// neighbour, so the work is bytes over HBM (60 M int64 keys = 480 MB, about
// 0.14 ms at 3.35 TB/s); the comparisons are far below the ALU rate.
//
// What the design does about it: the TPU version walks 128-key blocks in
// order and carries the run state from block b-1 to block b in SMEM.  Hopper
// runs blocks concurrently and in no order, so that carry does not exist
// here.  Instead every segment of keys is described by a RunSummary (first
// and last key, length, leading and trailing run, longest run, number of
// runs) and summaries are merged with an associative operator that stitches
// the run crossing their boundary.  Pass 1 loads a tile of keys with
// coalesced loads into shared memory, each thread summarises a few
// consecutive keys, and the block merges its threads' summaries in order;
// pass 2 merges the tile summaries the same way, one level per launch,
// until one remains.  No key is padded, so a real key equal to INT64_MAX is
// counted like any other (the ragged edge is masked by index).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // keys (or summaries) a thread folds
constexpr int kTile = kThreads * kItems;        // keys (or summaries) a block folds

struct RunSummary {
  long long first;    // first key (widened to 64 bits)
  long long last;     // last key
  long long len;      // keys in the segment; 0 = empty (the identity)
  long long lead;     // length of the run that starts the segment
  long long trail;    // length of the run that ends it
  long long maxrun;   // longest run inside the segment
  long long runs;     // runs in the segment
};

__device__ __forceinline__ RunSummary merge(const RunSummary& a,
                                            const RunSummary& b) {
  if (a.len == 0) return b;
  if (b.len == 0) return a;
  const bool join = a.last == b.first;
  RunSummary r;
  r.first = a.first;
  r.last = b.last;
  r.len = a.len + b.len;
  r.lead = (join && a.lead == a.len) ? a.len + b.lead : a.lead;
  r.trail = (join && b.trail == b.len) ? b.len + a.trail : b.trail;
  r.maxrun = max(a.maxrun, b.maxrun);
  if (join) r.maxrun = max(r.maxrun, a.trail + b.lead);
  r.runs = a.runs + b.runs - (join ? 1 : 0);
  return r;
}

__device__ __forceinline__ RunSummary one_key(long long k) {
  return RunSummary{k, k, 1, 1, 1, 1, 1};
}

// Merge s[0..kThreads) in order into s[0].
__device__ __forceinline__ void block_merge(RunSummary* s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int stride = 1; stride < kThreads; stride <<= 1) {
    __syncthreads();
    if ((t & (2 * stride - 1)) == 0) s[t] = merge(s[t], s[t + stride]);
  }
  __syncthreads();
}

__device__ __forceinline__ void finish(const RunSummary& r, long long* out) {
  out[0] = r.runs;
  out[1] = r.maxrun;
}

// Pass 1: one block per tile of kTile keys -> tiles[blockIdx.x].  A launch
// of one block writes the result to out.
template <typename K>
__global__ void __launch_bounds__(kThreads)
segdegree_tiles_kernel(const K* __restrict__ keys, long long n,
                       RunSummary* __restrict__ tiles,
                       long long* __restrict__ out) {
  __shared__ K tile[kTile];
  __shared__ RunSummary s[kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int m = static_cast<int>(min(static_cast<long long>(kTile), n - base));
  for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = keys[base + i];
  __syncthreads();
  RunSummary r{0, 0, 0, 0, 0, 0, 0};
  const int lo = threadIdx.x * kItems;
  const int hi = min(lo + kItems, m);
  for (int i = lo; i < hi; ++i) {
    const long long k = static_cast<long long>(tile[i]);
    if (r.len == 0) {
      r = one_key(k);
      continue;
    }
    const bool same = k == r.last;
    const bool whole = r.lead == r.len;
    r.len += 1;
    r.trail = same ? r.trail + 1 : 1;
    r.lead = (same && whole) ? r.lead + 1 : r.lead;
    r.maxrun = max(r.maxrun, r.trail);
    r.runs += same ? 0 : 1;
    r.last = k;
  }
  s[threadIdx.x] = r;
  block_merge(s);
  if (threadIdx.x == 0) {
    tiles[blockIdx.x] = s[0];
    if (gridDim.x == 1) finish(s[0], out);
  }
}

// Pass 2: one block per kTile consecutive summaries -> dst[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
segdegree_merge_kernel(const RunSummary* __restrict__ src, long long m,
                       RunSummary* __restrict__ dst,
                       long long* __restrict__ out) {
  __shared__ RunSummary s[kThreads];
  const long long lo = static_cast<long long>(blockIdx.x) * kTile
                       + static_cast<long long>(threadIdx.x) * kItems;
  const long long hi = min(lo + kItems, m);
  RunSummary r{0, 0, 0, 0, 0, 0, 0};
  for (long long i = lo; i < hi; ++i) r = merge(r, src[i]);
  s[threadIdx.x] = r;
  block_merge(s);
  if (threadIdx.x == 0) {
    dst[blockIdx.x] = s[0];
    if (gridDim.x == 1) finish(s[0], out);
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The launcher's return value: the kernels launched, or minus the CUDA error.
inline int launched_or_error(cudaError_t err, int launched) {
  return err == cudaSuccess ? launched : -static_cast<int>(err);
}

template <typename K>
int launch_segdegree(const void* keys, long long n, void* scratch,
                     long long scratch_bytes, void* out, void* stream) {
  if (n <= 0) return launched_or_error(cudaErrorInvalidValue, 0);
  const long long n_tiles = ceil_div(n, kTile);
  if (scratch_bytes < static_cast<long long>(sizeof(RunSummary))
                          * (n_tiles + ceil_div(n_tiles, kTile))) {
    return launched_or_error(cudaErrorInvalidValue, 0);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RunSummary* a = static_cast<RunSummary*>(scratch);
  RunSummary* b = a + n_tiles;
  long long* o = static_cast<long long*>(out);
  segdegree_tiles_kernel<K><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                              st>>>(static_cast<const K*>(keys), n, a, o);
  cudaError_t err = cudaGetLastError();
  int launched = 1;
  // each level folds kTile summaries into one; ping-pong between a and b
  for (long long m = n_tiles; m > 1 && err == cudaSuccess;) {
    const long long next = ceil_div(m, kTile);
    segdegree_merge_kernel<<<static_cast<unsigned>(next), kThreads, 0, st>>>(
        a, m, b, o);
    err = cudaGetLastError();
    ++launched;
    RunSummary* t = a;
    a = b;
    b = t;
    m = next;
  }
  return launched_or_error(err, launched);
}

}  // namespace

// Plain C interface (loaded with ctypes).  The launcher runs on the given
// stream, does not synchronise, and returns the number of kernels it
// launched (the tile pass and one per merge level), or minus the CUDA
// error; out receives (distinct_count, max_degree) as two int64.
extern "C" {

long long repro_segdegree_scratch_bytes(long long n) {
  const long long n_tiles = ceil_div(n, kTile);
  return static_cast<long long>(sizeof(RunSummary))
         * (n_tiles + ceil_div(n_tiles, kTile));
}

int repro_segdegree_i32(const void* keys, long long n, void* scratch,
                        long long scratch_bytes, void* out, void* stream) {
  return launch_segdegree<int32_t>(keys, n, scratch, scratch_bytes, out,
                                   stream);
}

int repro_segdegree_i64(const void* keys, long long n, void* scratch,
                        long long scratch_bytes, void* out, void* stream) {
  return launch_segdegree<int64_t>(keys, n, scratch, scratch_bytes, out,
                                   stream);
}

}  // extern "C"
