// Segment-degree statistics of a sorted key column for Hopper (sm_90a).
//
// Replaces src/repro/kernels/segdegree.py :: segdegree_kernel (driven by
// _segdegree_i32): (distinct_count, max_degree) of a sorted int32 or int64
// key column, i.e. the number of runs of equal keys and the longest run.
//
// What bounds it on the H100: each key is read once and compared with its
// neighbour, so the work is bytes over HBM (60 M int64 keys = 480 MB, about
// 0.14 ms at 3.35 TB/s); the comparisons are far below the ALU rate.  At
// small columns (UQ1's 3.6 M-key index, 14 MB) the fixed cost of a launch
// and of the result's fetch weighs as much as the bytes.
//
// What the design does about it: the TPU version walks 128-key blocks in
// order and carries the run state from block b-1 to block b in SMEM.
// Hopper runs blocks concurrently and in no order, so that carry does not
// exist here.  Instead the kernel works from run starts: position i starts
// a run when i == 0 or keys[i] != keys[i-1], the distinct count is the
// number of starts and a run's length is the next start minus its own.
// - One launch of one wave of CTAs (occupancy query); the column is cut
//   into equal contiguous ranges, one per warp, CTA by CTA.
// - Each warp streams its range with 16-byte loads (read-only, no L1
//   allocation), four per lane in flight; the head up to the first 16-byte
//   boundary and the ragged tail go through the same step as single keys,
//   so a view such as col[1:] needs no alignment.
// - Each lane compares its keys with the key before them (a shuffle from
//   the lane before, the warp's last key for lane 0, one extra load at the
//   warp's first key): the count is a popcount with no carry.  An exclusive
//   max-scan over the warp of "last run start seen", joined with the warp's
//   running carry, gives every start its predecessor and so every run
//   inside the warp its length.
// - A warp's summary (starts, first start, last start, longest inner run)
//   is merged in order with its CTA's other warps; the CTA writes it, and
//   the last CTA to finish (an atomic ticket that the launcher zeroes with
//   a memset) merges every CTA's summary in order in the same launch, so a
//   run across many CTAs (the all-equal column is one run) is stitched.
// No key is padded, so a real key equal to INT64_MAX counts like any other;
// counts stay int64 until the one fetch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // 16-byte loads per lane in flight
constexpr long long kMinCtaKeys = 2048;     // fewer keys a CTA is not worth
constexpr unsigned kFull = 0xffffffffu;
// the last CTA merges the CTAs' summaries, each of its threads at most
// kMaxMergePer of them in order, so a call launches at most kMaxCtas CTAs
constexpr int kMaxMergePer = 4;
constexpr int kMaxCtas = kThreads * kMaxMergePer;

// One CTA's (or one warp's) part of the column; positions absolute, -1 =
// no run starts in it.
struct Summary {
  long long starts;   // run starts (distinct keys) in the part
  long long first;    // first run start
  long long last;     // last run start
  long long inner;    // longest run that starts and ends inside the part
};

__device__ __forceinline__ void append(Summary& a, const Summary& b) {
  if (b.first >= 0) {
    if (a.last >= 0) a.inner = max(a.inner, b.first - a.last);
    else a.first = b.first;
    a.last = b.last;
  }
  a.inner = max(a.inner, b.inner);
  a.starts += b.starts;
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// A warp's running state; every lane holds the same values (positions are
// relative to the warp's first key).
template <typename K>
struct WarpState {
  K key;            // the last key seen
  bool has_key;     // false only before global position 0
  int last;         // last run start seen, -1 if none
  int first;        // this lane's record of the warp's first start, or -1
  int inner;        // this lane's longest run between two starts seen
  int starts;       // run starts this lane saw
};

// One step over consecutive keys: lane l holds m keys (m == V, or 1 for
// the head and tail, or 0 past the end; the lanes that hold keys are a
// prefix of the warp) starting at relative position pos.
template <typename K, int V>
__device__ __forceinline__ void step(const K (&k)[V], int m, int pos,
                                     WarpState<K>& s, int lane) {
  K mine_last = k[0];
#pragma unroll
  for (int j = 1; j < V; ++j) mine_last = j < m ? k[j] : mine_last;
  K prev = __shfl_up_sync(kFull, mine_last, 1);
  bool prev_ok = true;
  if (lane == 0) {
    prev = s.key;
    prev_ok = s.has_key;
  }
  int f = -1, l = -1;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < m) {
      const bool start = !prev_ok || k[j] != prev;
      if (start) {
        if (l >= 0) s.inner = max(s.inner, pos + j - l);
        else f = pos + j;
        l = pos + j;
        ++s.starts;
      }
      prev = k[j];
      prev_ok = true;
    }
  }
  const unsigned held = __ballot_sync(kFull, m > 0);
  const int top = 31 - __clz(held);
  if (__ballot_sync(kFull, f >= 0)) {
    // exclusive max-scan of the lanes' last starts
    int x = l;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    int before = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) before = -1;
    before = max(before, s.last);
    if (f >= 0) {
      if (before >= 0) s.inner = max(s.inner, f - before);
      else s.first = f;
    }
    s.last = max(s.last, __shfl_sync(kFull, x, 31));
  }
  s.key = __shfl_sync(kFull, mine_last, top);
  s.has_key = true;
}

// Keys per warp: the column cut into kWarps * ctas equal ranges, rounded up
// to 32 keys so that every range of an aligned column starts aligned.
__host__ __device__ __forceinline__ long long warp_keys(long long n, int ctas) {
  const long long w = static_cast<long long>(ctas) * kWarps;
  return ((n + w - 1) / w + 31) / 32 * 32;
}

// The summary of keys[b, e) by one warp (all 32 lanes, warp-uniform b, e).
template <typename K>
__device__ Summary warp_pass(const K* __restrict__ keys, long long b,
                             long long e, int lane) {
  constexpr int V = 16 / sizeof(K);
  WarpState<K> s;
  s.key = b > 0 ? keys[b - 1] : K(0);
  s.has_key = b > 0;
  s.last = s.first = -1;
  s.inner = s.starts = 0;
  const int len = static_cast<int>(max(e - b, 0LL));
  const K* p = keys + b;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min(len, mis ? (16 - mis) / static_cast<int>(sizeof(K)) : 0);
  const int nvec = (len - head) / V;
  const int tail = len - head - nvec * V;
  K one[V] = {};
  if (head > 0) {
    one[0] = lane < head ? p[lane] : K(0);
    step<K, V>(one, lane < head ? 1 : 0, lane, s, lane);
  }
  const uint4* vp = reinterpret_cast<const uint4*>(p + head);
  for (int s0 = 0; s0 < nvec; s0 += 32 * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s0 + u * 32 + lane;
      raw[u] = i < nvec ? load_stream(vp + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s0 + u * 32 + lane;
      if (s0 + u * 32 < nvec) {
        K kv[V];
        memcpy(kv, &raw[u], 16);
        step<K, V>(kv, i < nvec ? V : 0, head + i * V, s, lane);
      }
    }
  }
  if (tail > 0) {
    const int at = head + nvec * V;
    one[0] = lane < tail ? p[at + lane] : K(0);
    step<K, V>(one, lane < tail ? 1 : 0, at + lane, s, lane);
  }
  Summary r;
  r.starts = __reduce_add_sync(kFull, static_cast<unsigned>(s.starts));
  r.inner = __reduce_max_sync(kFull, s.inner);
  const int f = __reduce_max_sync(kFull, s.first);
  r.first = f >= 0 ? b + f : -1;
  r.last = s.last >= 0 ? b + s.last : -1;
  return r;
}

// Inclusive max-scan over a warp.
__device__ __forceinline__ long long warp_incl_max(long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

// The last CTA: merge the ctas summaries in order into out.
__device__ void merge_all(const Summary* __restrict__ parts, int ctas,
                          long long n, long long* __restrict__ out) {
  __shared__ long long s_last[kWarps], s_inner[kWarps], s_starts[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (ctas + kThreads - 1) / kThreads;
  // every load first (L2, past L1), then the merge in order
  Summary got[kMaxMergePer];
#pragma unroll
  for (int u = 0; u < kMaxMergePer; ++u) {
    const int i = t * per + u;
    if (u < per && i < ctas) {
      got[u].starts = __ldcg(&parts[i].starts);
      got[u].first = __ldcg(&parts[i].first);
      got[u].last = __ldcg(&parts[i].last);
      got[u].inner = __ldcg(&parts[i].inner);
    }
  }
  Summary a{0, -1, -1, 0};
#pragma unroll
  for (int u = 0; u < kMaxMergePer; ++u) {
    if (u < per && t * per + u < ctas) append(a, got[u]);
  }
  // the last start before this thread's part: an exclusive max-scan
  const long long incl = warp_incl_max(a.last, lane);
  if (lane == 31) s_last[w] = incl;
  __syncthreads();
  long long before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = -1;
  for (int j = 0; j < w; ++j) before = max(before, s_last[j]);
  long long inner = a.inner;
  if (a.first >= 0 && before >= 0) inner = max(inner, a.first - before);
  long long starts = a.starts;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    inner = max(inner, __shfl_xor_sync(kFull, inner, d));
    starts += __shfl_xor_sync(kFull, starts, d);
  }
  if (lane == 0) {
    s_inner[w] = inner;
    s_starts[w] = starts;
  }
  __syncthreads();
  if (t == 0) {
    long long last = -1, longest = 0, total = 0;
    for (int j = 0; j < kWarps; ++j) {
      last = max(last, s_last[j]);
      longest = max(longest, s_inner[j]);
      total += s_starts[j];
    }
    // position 0 always starts a run, so last >= 0; the last run ends at n
    out[0] = total;
    out[1] = max(longest, n - last);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
segdegree_kernel(const K* __restrict__ keys, long long n,
                 Summary* __restrict__ parts, unsigned* __restrict__ ticket,
                 long long* __restrict__ out) {
  __shared__ Summary s_warp[kWarps];
  __shared__ bool s_last_cta;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long wk = warp_keys(n, gridDim.x);
  const long long b =
      min(n, (static_cast<long long>(blockIdx.x) * kWarps + w) * wk);
  const long long e = min(n, b + wk);
  const Summary r = warp_pass<K>(keys, b, e, lane);
  if (lane == 0) s_warp[w] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    Summary c = s_warp[0];
    for (int j = 1; j < kWarps; ++j) append(c, s_warp[j]);
    parts[blockIdx.x] = c;
    __threadfence();
    s_last_cta = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last_cta) return;
  __threadfence();
  merge_all(parts, gridDim.x, n, out);
}

// One wave: the CTAs of this kernel that the card's SMs hold at once.
template <typename K>
int wave_ctas(int sms) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segdegree_kernel<K>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return max(per_sm, 1) * sms;
}

// CTAs a call launches: one wave (at most kMaxCtas), or fewer for a short
// column.
inline int ctas_for(long long n, int wave) {
  return static_cast<int>(
      max(1LL, min(static_cast<long long>(min(wave, kMaxCtas)),
                   (n + kMinCtaKeys - 1) / kMinCtaKeys)));
}

inline long long scratch_bytes(int wave) {
  return static_cast<long long>(sizeof(Summary)) * wave + 16;
}

template <typename K>
int launch_segdegree(const void* keys, long long n, int wave, void* scratch,
                     long long n_scratch, void* out, void* stream) {
  if (n <= 0 || wave <= 0 || n_scratch < scratch_bytes(wave)
      || reinterpret_cast<uintptr_t>(keys) % sizeof(K) != 0
      || warp_keys(n, ctas_for(n, wave)) >= (1LL << 31)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Summary* parts = static_cast<Summary*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(parts + wave);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return -static_cast<int>(err);
  segdegree_kernel<K><<<ctas_for(n, wave), kThreads, 0, st>>>(
      static_cast<const K*>(keys), n, parts, ticket,
      static_cast<long long*>(out));
  err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  The caller takes `wave` from
// repro_segdegree_wave (one per key width and card) and a scratch of
// repro_segdegree_scratch_bytes(wave) bytes.  The launcher zeroes the
// ticket (a memset), launches the kernel on the given stream, does not
// synchronise, and returns the number of kernels it launched (1), or minus
// the CUDA error; out receives (distinct_count, max_degree) as two int64.
extern "C" {

int repro_segdegree_wave(int key_bytes, int sms) {
  return key_bytes == 4 ? wave_ctas<int32_t>(sms) : wave_ctas<int64_t>(sms);
}

long long repro_segdegree_scratch_bytes(int wave) { return scratch_bytes(wave); }

// Keys of CTA c's range [c * k, (c + 1) * k) for a call of n keys.
long long repro_segdegree_cta_keys(long long n, int wave) {
  return warp_keys(n, ctas_for(n, wave)) * kWarps;
}

int repro_segdegree_i32(const void* keys, long long n, int wave,
                        void* scratch, long long n_scratch, void* out,
                        void* stream) {
  return launch_segdegree<int32_t>(keys, n, wave, scratch, n_scratch, out,
                                   stream);
}

int repro_segdegree_i64(const void* keys, long long n, int wave,
                        void* scratch, long long n_scratch, void* out,
                        void* stream) {
  return launch_segdegree<int64_t>(keys, n, wave, scratch, n_scratch, out,
                                   stream);
}

}  // extern "C"
