// Split-K flash decoding for Hopper: one query token per (batch row, query
// head) against a deep KV cache.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention. The Pallas grid (B, KV, splits) walks the cache splits
// serially with an (m, l, acc) carry in VMEM; here the splits run in
// parallel and a second kernel merges them:
//
//   decode_split_kernel    grid (B*KV, splits), 4 warps. A block owns the G
//                          query rows of one (batch row, kv head), held in
//                          f32 registers, and one chunk of cache slots,
//                          walked up to kv_len[b] (a chunk wholly past it
//                          loads no K/V). Each key row is read by d/VEC
//                          lanes with one 16-byte load each; q.k is a
//                          warp-shuffle sum over those lanes. Every lane
//                          group keeps an online softmax (m, l, acc); the
//                          groups and warps merge in registers and shared
//                          memory, and the block writes its split's f32
//                          (m, l, acc) to a workspace.
//   decode_combine_kernel  grid (B*KV): rescales each split by exp(m_i - m)
//                          and writes acc / l in the output dtype.
//
// Masked and empty slots get an explicit zero weight and m starts at a
// finite -1e30, so a split with no live slot contributes l = 0 and never
// NaN, and a row with kv_len = 0 returns 0. Scores, softmax and P.V stay
// f32 (p is not rounded to the cache dtype). At qwen's G = 1 each block is
// a GEMV over its chunk: the kernel is bound by the bytes of the live
// cache slots, and its design aim is enough 16-byte loads in flight (U
// key rows per lane group per iteration, several blocks per SM).
// Head dims 32, 64 and 128 in both dtypes (a key row is D / 8 lanes in bf16,
// D / 4 in f32; at 128 the block's merge buffer sm_acc is at most 16 KB).
// At granite-3-8b's G = 4 each key row is read once and used by the 4 query
// heads of its group, from registers, on CUDA-core FMAs.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T as N f32 values
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // little-endian: low half first
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, long long qs_b,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int S, int KV, int G,
    int splits, int chunk, float scale, float softcap) {
  constexpr int VEC = Pack<T>::N;
  constexpr int LPK = D / VEC;             // lanes per key row
  constexpr int KPW = 32 / LPK;            // key rows per warp per pass
  constexpr int NG = kWarps * KPW;         // key rows per block per pass
  constexpr int U = GP >= 8 ? 1 : (GP >= 4 ? 2 : 4);   // passes in flight
  static_assert(D % VEC == 0 && 32 % LPK == 0, "head_dim");

  const int bk = blockIdx.x;               // b * KV + kv head
  const int b = bk / KV, h = bk % KV;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPK;              // dims [sub*VEC, sub*VEC + VEC)
  const int key_off = warp * KPW + lane / LPK;
  const int c0 = split * chunk;
  const int end = min(min(c0 + chunk, S), max(kv_len[b], 0));

  float m[GP], l[GP], acc[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  if (c0 < end) {                          // block-uniform
    float qf[GP][VEC];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const T* qp = q + b * qs_b + (long long)(h * G + g) * qs_h + sub * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qf[g][i] = g < G ? to_f32(qp[i]) * scale : 0.f;
    }
    const T* kb = k + b * ks_b + h * ks_h + sub * VEC;
    const T* vb = v + b * vs_b + h * vs_h + sub * VEC;
    // the loop bound is block-uniform, so every lane reaches the shuffles
    for (int base = c0; base < end; base += NG * U) {
      uint4 kr[U], vr[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * NG + key_off;
        live[u] = idx < end;
        if (live[u]) {
          kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + idx * ks_s));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + idx * vs_s));
        } else {
          kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float s[U][GP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        Pack<T>::unpack(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) t = fmaf(qf[g][i], kf[i], t);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            t += __shfl_xor_sync(kFull, t, o);
          if (softcap != 0.f) t = softcap * tanhf(t / softcap);
          s[u][g] = t;
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) mx = fmaxf(mx, s[u][g]);
        const float corr = expf(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VEC];
        Pack<T>::unpack(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float p = live[u] ? expf(s[u][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
  }

  // merge the lane groups of a warp (lanes sub, sub + LPK, ... hold the
  // same dims)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx), c = expf(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], o);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mx;
    }
  }

  // merge the warps and write this split's (m, l, acc)
  __shared__ float sm_acc[kWarps][GP][D];
  __shared__ float sm_m[kWarps][GP], sm_l[kWarps][GP];
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][sub * VEC + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  const long long row = (long long)bk * splits + split;
  float* wa = ws_acc + row * G * D;
  float* wml = ws_ml + row * G * 2;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, dim = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w][g] - mx);
      ls = fmaf(sm_l[w][g], e, ls);
      as = fmaf(sm_acc[w][g][dim], e, as);
    }
    wa[idx] = as;
    if (dim == 0) {
      wml[2 * g] = mx;
      wml[2 * g + 1] = ls;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    T* __restrict__ out, int KV, int G, int D, int splits) {
  const int bk = blockIdx.x;
  const int b = bk / KV, h = bk % KV;
  const float* ml = ws_ml + (long long)bk * splits * G * 2;
  const float* acc = ws_acc + (long long)bk * splits * G * D;
  T* o = out + ((long long)b * KV * G + (long long)h * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[(s * G + g) * 2]);
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float e = expf(ml[(s * G + g) * 2] - mx);
      ls = fmaf(ml[(s * G + g) * 2 + 1], e, ls);
      as = fmaf(acc[(long long)s * G * D + idx], e, as);
    }
    o[idx] = from_f32<T>(ls > 0.f ? as / ls : 0.f);
  }
}

template <typename T, int D, int GP>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, float* ws, const long long* st, int B, int S, int KV,
           int G, int splits, int chunk, float scale, float softcap,
           cudaStream_t s) {
  float* ws_acc = ws;
  float* ws_ml = ws + (long long)B * KV * splits * G * D;
  decode_split_kernel<T, D, GP><<<dim3(B * KV, splits), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), ws_acc,
      ws_ml, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], S, KV,
      G, splits, chunk, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * KV, kThreads, 0, s>>>(
      ws_acc, ws_ml, static_cast<T*>(out), KV, G, D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, float* ws, const long long* st, int B, int S, int KV,
             int G, int splits, int chunk, float scale, float softcap,
             cudaStream_t s) {
#define REPRO_DECODE_G(GP)                                                  \
  if (G <= GP)                                                              \
    return launch<T, D, GP>(q, k, v, kv_len, out, ws, st, B, S, KV, G,      \
                            splits, chunk, scale, softcap, s);
  REPRO_DECODE_G(1)
  REPRO_DECODE_G(2)
  REPRO_DECODE_G(4)
  REPRO_DECODE_G(8)
#undef REPRO_DECODE_G
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, float* ws, const long long* st, int B, int S, int KV,
             int G, int D, int splits, int chunk, float scale, float softcap,
             cudaStream_t s) {
  if (D == 32)
    return launch_g<T, 32>(q, k, v, kv_len, out, ws, st, B, S, KV, G, splits,
                           chunk, scale, softcap, s);
  if (D == 64)
    return launch_g<T, 64>(q, k, v, kv_len, out, ws, st, B, S, KV, G, splits,
                           chunk, scale, softcap, s);
  if (D == 128)
    return launch_g<T, 128>(q, k, v, kv_len, out, ws, st, B, S, KV, G,
                            splits, chunk, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q: (B, 1, H, D) with strides (qs_b, qs_h); k, v: (B, S, KV, D) with
// strides (s_b, s_s, s_kv), unit dim stride, rows 16-byte aligned; kv_len:
// (B,) int32 on the device; out: contiguous (B, 1, H, D); ws: f32 workspace
// of B*KV*splits*G*(D+2) floats. strides = {qs_b, qs_h, ks_b, ks_s, ks_kv,
// vs_b, vs_s, vs_kv} in elements. Slots [split*chunk, (split+1)*chunk) go to
// split `split`. Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* out, void* ws,
                                    const long long* strides, int B, int S,
                                    int H, int KV, int D, int splits,
                                    int chunk, float scale, float softcap,
                                    int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || H / KV > 8 || splits <= 0 || chunk <= 0 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kFloat32)
    return launch_d<float>(q, k, v, kv_len, out, w, strides, B, S, KV, G, D,
                           splits, chunk, scale, softcap, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(q, k, v, kv_len, out, w, strides, B, S,
                                   KV, G, D, splits, chunk, scale, softcap,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
