// One-token GQA decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention.py :: decode_attn_kernel (driven by
// _decode_attn): q (B, H, D) against k/v (B, S, KVH, D) with per-row
// lengths, query head h reading KV head h / G (G = H / KVH), logits
// (q . k) * scale, optionally softcap * tanh(logits / softcap), masked to
// s < length (and s >= length - window when window > 0), an fp32 online
// softmax, and the output acc / max(l, 1e-30) in q's dtype.  f32 or bf16;
// D in {64, 128, 256}; G <= 8; any S.
//
// What bounds it on the H100: bytes.  Every kept K and V row is read once
// and feeds 4 * G * D flops, about G flops per byte in bf16, far below the
// ~295 flops per byte at which the tensor cores would be the limit.  At
// gemma-2-9b's widths (B 8, S 8192, KVH 8, D 256, bf16) K and V are 537 MB.
//
// What the design does about it:
// * One warp per key row: each lane holds D / 32 contiguous elements, so a
//   row is one coalesced 16-byte load per lane (bf16, D = 256), and the row
//   stays in registers for all G query heads of its KV head: K and V are
//   read from device memory once, never once per query head.
// * Each warp keeps a few rows in flight per step and its own online-softmax
//   state (m, l, acc) in registers; no shared memory and no block barrier.
// * Only rows inside [max(length - window, 0), min(length, S)) are read:
//   masked rows contribute p = 0 to the reference, so skipping them leaves
//   the result unchanged, and a local (windowed) layer reads a window's worth.
// * Flash-decoding: B * KVH CTAs alone (64 at gemma-2's shape) would leave
//   half of the 132 SMs idle, so each (b, kv_head) splits its kept range over
//   several CTAs; every warp writes a partial (m, l, acc) and a second kernel
//   merges the partials of each (b, h) with the usual rescaling.
// No S padding is needed: the ragged end of the range is masked by index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;   // the reference's masked logit

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
    static_assert(N == 2, "rows of 64, 128 or 256 elements");
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
    static_assert(N == 2, "rows of 64, 128 or 256 elements");
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x;
    o[1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Grid (splits, KVH, B); each of the kWarps warps of a CTA writes one
// partial (m, l, acc) per query head of the group.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attn_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ lengths, int H, int S,
                           int KVH, int G, float scale, float softcap,
                           int window, float* __restrict__ part_acc,
                           float* __restrict__ part_ml) {
  constexpr int N = D / 32;
  constexpr int U = GM >= 4 ? 2 : 4;   // rows in flight per warp and step
  const int splits = gridDim.x;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = splits * kWarps;
  const int p = split * kWarps + warp;

  // the kept rows [lo, hi) of this batch row, cut into `splits` chunks
  const int len = max(lengths[b], 0);
  const int hi = min(len, S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int total = max(hi - lo, 0);
  const int chunk = (total + splits - 1) / splits;
  const int c0 = lo + split * chunk;
  const int c1 = min(c0 + chunk, hi);

  float qr[GM][N];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      load_row(q + (static_cast<size_t>(b) * H + kvh * G + g) * D + lane * N,
               qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) qr[g][i] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][N];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  const size_t row = static_cast<size_t>(KVH) * D;   // stride between s
  const size_t off = static_cast<size_t>(b) * S * row
                     + static_cast<size_t>(kvh) * D + lane * N;
  for (int s0 = c0 + warp * U; s0 < c1; s0 += kWarps * U) {
    float kr[U][N], vr[U][N];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = s0 + u < c1;
      if (ok[u]) {
        load_row(k + off + static_cast<size_t>(s0 + u) * row, kr[u]);
        load_row(v + off + static_cast<size_t>(s0 + u) * row, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float x[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) d = __fmaf_rn(qr[g][i], kr[u][i], d);
        x[u][g] = d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          x[u][g] += __shfl_xor_sync(0xffffffffu, x[u][g], o);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float t = x[u][g] * scale;
        if (softcap > 0.f) t = softcap * tanhf(t / softcap);
        x[u][g] = ok[u] ? t : kNegInf;
        mx = fmaxf(mx, x[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float pu[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = ok[u] ? expf(x[u][g] - mx) : 0.f;
        psum += pu[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = __fmaf_rn(pu[u], vr[u][i], a);
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    const size_t idx = (static_cast<size_t>(b) * H + kvh * G + g) * P + p;
#pragma unroll
    for (int i = 0; i < N; ++i) part_acc[idx * D + lane * N + i] = acc[g][i];
    if (lane == 0) {
      part_ml[idx * 2] = m[g];
      part_ml[idx * 2 + 1] = l[g];
    }
  }
}

// Grid (B * H), block D: merge the P partials of each (b, h).
template <typename T>
__global__ void decode_attn_combine_kernel(const float* __restrict__ part_acc,
                                           const float* __restrict__ part_ml,
                                           int P, T* __restrict__ out) {
  const size_t bh = blockIdx.x;
  const int D = blockDim.x, d = threadIdx.x;
  const float* ml = part_ml + bh * P * 2;
  float mx = kNegInf;
  for (int p = 0; p < P; ++p) mx = fmaxf(mx, ml[2 * p]);
  float den = 0.f, num = 0.f;
  for (int p = 0; p < P; ++p) {
    const float w = expf(ml[2 * p] - mx);
    den = __fmaf_rn(ml[2 * p + 1], w, den);
    num = __fmaf_rn(part_acc[(bh * P + p) * D + d], w, num);
  }
  store(out + bh * D + d, num / fmaxf(den, 1e-30f));
}

// Splits per (b, kv_head): enough CTAs for two per SM, but at least 128
// rows per CTA.
inline int splits_for(long long B, long long S, long long KVH, int num_sms) {
  const long long ctas = B * KVH;
  const long long want = (2LL * num_sms + ctas - 1) / ctas;
  const long long most = S / (kWarps * 16);
  return static_cast<int>(std::max(1LL, std::min(want, most)));
}

inline long long scratch_floats(long long B, long long H, long long S,
                                long long KVH, long long D, int num_sms) {
  return B * H * splits_for(B, S, KVH, num_sms) * kWarps * (D + 2);
}

template <typename T, int D, int GM>
void launch_partial(dim3 grid, cudaStream_t st, const T* q, const T* k,
                    const T* v, const int* lengths, int H, int S, int KVH,
                    int G, float scale, float softcap, int window, float* acc,
                    float* ml) {
  decode_attn_partial_kernel<T, D, GM><<<grid, kThreads, 0, st>>>(
      q, k, v, lengths, H, S, KVH, G, scale, softcap, window, acc, ml);
}

template <typename T, int D>
void launch_group(int G, dim3 grid, cudaStream_t st, const T* q, const T* k,
                  const T* v, const int* lengths, int H, int S, int KVH,
                  float scale, float softcap, int window, float* acc,
                  float* ml) {
  if (G <= 1) {
    launch_partial<T, D, 1>(grid, st, q, k, v, lengths, H, S, KVH, G, scale,
                            softcap, window, acc, ml);
  } else if (G <= 2) {
    launch_partial<T, D, 2>(grid, st, q, k, v, lengths, H, S, KVH, G, scale,
                            softcap, window, acc, ml);
  } else if (G <= 4) {
    launch_partial<T, D, 4>(grid, st, q, k, v, lengths, H, S, KVH, G, scale,
                            softcap, window, acc, ml);
  } else {
    launch_partial<T, D, 8>(grid, st, q, k, v, lengths, H, S, KVH, G, scale,
                            softcap, window, acc, ml);
  }
}

template <typename T>
int launch_decode_attention(const void* q, const void* k, const void* v,
                            const void* lengths, long long B, long long H,
                            long long S, long long KVH, long long D,
                            float scale, float softcap, long long window,
                            int num_sms, void* scratch, long long n_scratch,
                            void* out, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || KVH <= 0 || H % KVH != 0
      || H / KVH > 8 || (D != 64 && D != 128 && D != 256) || window < 0
      || B > 65535 || KVH > 65535 || S > (1LL << 30) || num_sms <= 0
      || n_scratch < scratch_floats(B, H, S, KVH, D, num_sms)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = static_cast<int>(H / KVH);
  const int splits = splits_for(B, S, KVH, num_sms);
  const long long P = static_cast<long long>(splits) * kWarps;
  float* acc = static_cast<float*>(scratch);
  float* ml = acc + B * H * P * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const int* len = static_cast<const int*>(lengths);
  const int h = static_cast<int>(H), s = static_cast<int>(S);
  const int kv = static_cast<int>(KVH);
  const int w = static_cast<int>(std::min(window, 1LL << 30));
  if (D == 64) {
    launch_group<T, 64>(G, grid, st, tq, tk, tv, len, h, s, kv, scale, softcap,
                        w, acc, ml);
  } else if (D == 128) {
    launch_group<T, 128>(G, grid, st, tq, tk, tv, len, h, s, kv, scale,
                         softcap, w, acc, ml);
  } else {
    launch_group<T, 256>(G, grid, st, tq, tk, tv, len, h, s, kv, scale,
                         softcap, w, acc, ml);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  decode_attn_combine_kernel<T><<<static_cast<unsigned>(B * H),
                                  static_cast<unsigned>(D), 0, st>>>(
      acc, ml, static_cast<int>(P), static_cast<T*>(out));
  err = cudaGetLastError();
  return err == cudaSuccess ? 2 : -static_cast<int>(err);
}

}  // namespace

// Plain C interface (loaded with ctypes).  The launcher runs on the given
// stream, does not synchronise, and returns the number of kernels it
// launched (2: the partial pass and the merge), or minus the CUDA error.
// The caller allocates `scratch` (float32, repro_decode_attention_scratch_floats of the
// same shape) and `out` (B, H, D) in the inputs' dtype; lengths are int32.
extern "C" {

long long repro_decode_attention_scratch_floats(long long B, long long H,
                                                long long S, long long KVH,
                                                long long D, int num_sms) {
  return scratch_floats(B, H, S, KVH, D, num_sms);
}

// CTAs per (b, kv_head) that the partial pass splits the kept range over.
int repro_decode_attention_splits(long long B, long long S, long long KVH,
                                  int num_sms) {
  return splits_for(B, S, KVH, num_sms);
}

int repro_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* lengths, long long B, long long H,
                               long long S, long long KVH, long long D,
                               float scale, float softcap, long long window,
                               int num_sms, void* scratch, long long n_scratch,
                               void* out, void* stream) {
  return launch_decode_attention<float>(q, k, v, lengths, B, H, S, KVH, D,
                                        scale, softcap, window, num_sms,
                                        scratch, n_scratch, out, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* lengths, long long B, long long H,
                                long long S, long long KVH, long long D,
                                float scale, float softcap, long long window,
                                int num_sms, void* scratch,
                                long long n_scratch, void* out, void* stream) {
  return launch_decode_attention<__nv_bfloat16>(
      q, k, v, lengths, B, H, S, KVH, D, scale, softcap, window, num_sms,
      scratch, n_scratch, out, stream);
}

}  // extern "C"
