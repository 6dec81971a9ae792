// Earlier-piece membership lookup of the union engine's round (sm_90a).
//
// Step 4 of an Algorithm-1 round keeps a candidate of cover piece j only if
// no earlier piece q < j contains it.  A tuple lies in q's join iff every
// base relation of q holds its projection onto that relation's attributes
// (and q's rejection predicates hold).  Each relation's membership index is
// its rows' 32-bit fingerprints fp32(salt 1), sorted, with fp32(salt 2) in
// the same order and kmax, the longest run of equal salt-1 fingerprints.
// In plain PyTorch (kernels/member.py, the CPU path) that costs ~17 int64
// kernels per attribute and salt for the fingerprints, then a
// torch.searchsorted and a kmax loop per relation: thousands of launches a
// round, each over a few thousand values, so launch- and latency-bound.
// member_lookup does all of one probing join's lookups in one launch.
//
// Work split.  One group of G lanes per candidate (G = npairs rounded up to
// a power of two, at most 32; several candidates share a warp); lane k of
// the group takes the (earlier piece, base relation) pair k, and with more
// than 32 pairs a lane takes k, k + 32.  A lane folds its relation's columns
// into both fingerprints in uint32 registers (the exact mix32/FNV
// arithmetic, salts salt * 1000 + i), runs a branch-free lower bound of the
// salt-1 fingerprint over the sorted column, and scans at most kmax entries
// comparing both fingerprints.  __ballot_sync gathers the group's hits, and
// lane 0 tests each piece's pair mask (all relations hit) and predicate
// mask, then writes acc & ~contained.  A candidate whose acc is false is
// written false and never looked up: its lanes load one byte and idle.
//
// What bounds it.  A live candidate reads its relations' columns (4 B per
// attribute per pair), ceil(log2 n) + 1 salt-1 fingerprints per pair (8 B
// each, one 32-B sector) and at most kmax entries of each column; bytes are
// far below the card's rate (UQ1's largest join: ~20 pairs x ~23 sectors,
// ~15 KB a candidate, all of it L2-resident).  Time is the chain of
// dependent loads in the longest search, ceil(log2 n) + kmax + 1 (23 at
// UQ1's and Q5's lineitem indexes, 3.6 M rows), each an L2 round trip
// after the top levels, which every lane reads and L1 holds, plus one
// launch.  The parameters (column, index and predicate pointers, the
// relations' column lists) travel by value, so a CUDA-graph capture records
// them with no host-to-device copy; each CTA copies them to shared memory,
// where lanes that index different pairs read without serialising on the
// constant cache.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFnv = 16777619u;

// Capacities of one launch's parameters (kernels/member.py mirrors them and
// splits a plan beyond them into runs of pieces, one launch each).
constexpr int kMaxCols = 96;      // candidate columns the relations read
constexpr int kMaxPairs = 64;     // (earlier piece, base relation) pairs
constexpr int kMaxPieces = 16;    // earlier pieces
constexpr int kMaxRefs = 256;     // column slots of the distinct attribute lists

struct MemberParams {
  const int32_t* cols[kMaxCols];            // candidate columns, B each
  const unsigned long long* s1[kMaxPairs];  // sorted salt-1 fingerprints
  const unsigned long long* s2[kMaxPairs];  // salt-2, in s1's order
  const uint8_t* pred[kMaxPieces];          // piece predicate mask or null
  unsigned long long qmask[kMaxPieces];     // the piece's pairs, one bit each
  int n[kMaxPairs];                         // rows of the pair's relation
  int kmax[kMaxPairs];                      // its duplicate window
  int ref_off[kMaxPairs];                   // its column list in refs
  int ref_len[kMaxPairs];
  uint8_t refs[kMaxRefs];                   // column slots, in salt order
  const uint8_t* acc;                       // live mask, null: all live
  uint8_t* out;                             // acc & ~contained
  unsigned long long* lookups;              // live candidates x pieces
  int B;                                    // candidates
  int npairs;
  int npieces;
  int group_log2;                           // lanes per candidate, log2
};

static_assert(sizeof(MemberParams) % 8 == 0, "copied in 8-byte words");
static_assert(sizeof(MemberParams) <= 4096, "fits a kernel's parameters");

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t salt) {
  uint32_t z = x + 0x9E3779B9u * (salt + 1u);
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// Whether candidate i's projection onto pair k's relation is one of its rows.
__device__ __forceinline__ bool pair_holds(const MemberParams& p, int k,
                                           int i) {
  const int n = p.n[k];
  if (n == 0) return false;
  uint32_t f1 = 0u, f2 = 0u;
  const uint8_t* ref = p.refs + p.ref_off[k];
  const int len = p.ref_len[k];
  for (int a = 0; a < len; ++a) {
    const uint32_t x = static_cast<uint32_t>(__ldg(p.cols[ref[a]] + i));
    f1 = (f1 * kFnv) ^ mix32(x, 1000u + a);
    f2 = (f2 * kFnv) ^ mix32(x, 2000u + a);
  }
  const unsigned long long* s1 = p.s1[k];
  const unsigned long long q1 = f1;
  // lower bound: the answer lies in [base, base + width]
  int base = 0, width = n;
  while (width > 1) {
    const int half = width >> 1;
    base = __ldg(s1 + base + half) < q1 ? base + half : base;
    width -= half;
  }
  int w = base + (__ldg(s1 + base) < q1 ? 1 : 0);
  const int end = min(n, w + p.kmax[k]);
  const unsigned long long* s2 = p.s2[k];
  for (; w < end; ++w) {
    if (__ldg(s1 + w) != q1) break;
    if (__ldg(s2 + w) == static_cast<unsigned long long>(f2)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
member_lookup_kernel(const __grid_constant__ MemberParams params) {
  __shared__ MemberParams p;
  {
    const unsigned long long* src =
        reinterpret_cast<const unsigned long long*>(&params);
    unsigned long long* dst = reinterpret_cast<unsigned long long*>(&p);
    for (int w = threadIdx.x; w < static_cast<int>(sizeof(MemberParams) / 8);
         w += kThreads)
      dst[w] = src[w];
  }
  __syncthreads();
  const int G = 1 << p.group_log2;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long ic = t >> p.group_log2;
  const int i = static_cast<int>(ic);
  const int g = static_cast<int>(t & (G - 1));
  const unsigned lane = threadIdx.x & 31;
  const bool real = ic < p.B;
  const bool live = real && (p.acc == nullptr || p.acc[i] != 0);
  // every lane of the warp reaches each ballot: the trip count is uniform
  unsigned long long hits = 0ull;
  for (int first = 0; first < p.npairs; first += G) {
    const int k = first + g;
    const bool hit = live && k < p.npairs && pair_holds(p, k, i);
    const unsigned bits = __ballot_sync(kFull, hit);
    const unsigned mine =
        G == 32 ? bits : (bits >> (lane & ~(G - 1))) & ((1u << G) - 1u);
    hits |= static_cast<unsigned long long>(mine) << first;
  }
  const unsigned leaders = __ballot_sync(kFull, live && g == 0);
  if (lane == 0 && leaders != 0u)
    atomicAdd(p.lookups, static_cast<unsigned long long>(__popc(leaders)) *
                             static_cast<unsigned long long>(p.npieces));
  if (real && g == 0) {
    bool keep = live;
    for (int q = 0; keep && q < p.npieces; ++q) {
      const unsigned long long m = p.qmask[q];
      if ((hits & m) == m && (p.pred[q] == nullptr || p.pred[q][i] != 0))
        keep = false;
    }
    p.out[i] = keep ? 1 : 0;
  }
}

// The launchers' return value: the kernels launched, or minus the CUDA error.
inline int launched_or_error(int launched) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launched : -static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  repro_member_lookup takes the
// host copy of the parameters, zeroes the lookup counter (a memset, not a
// kernel), launches on the given stream without synchronising, and returns
// the number of kernels it launched (1; 0 without candidates), or minus the
// CUDA error.
extern "C" {

int repro_member_lookup_params_bytes() {
  return static_cast<int>(sizeof(MemberParams));
}

int repro_member_lookup(const void* host_params, void* stream) {
  MemberParams p;
  memcpy(&p, host_params, sizeof(MemberParams));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaMemsetAsync(p.lookups, 0, sizeof(unsigned long long), s) !=
      cudaSuccess)
    return launched_or_error(0);
  if (p.B <= 0) return launched_or_error(0);
  const long long lanes = static_cast<long long>(p.B) << p.group_log2;
  const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
  member_lookup_kernel<<<blocks, kThreads, 0, s>>>(p);
  return launched_or_error(1);
}

}  // extern "C"
