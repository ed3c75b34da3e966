// Blocked causal flash attention for Hopper (dense mode + query offset).
//
// Replaces the dense mode of the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (neither segmented nor
// positioned), extended with q_offset: query row i sits at absolute position
// q_offset + i (bottom-right causal alignment of Sq suffix queries over
// Sk = q_offset + Sq keys, the prefix-cache-hit forward).
//
// Semantics (same as the plain version in kernels/flash_attention.py):
//   s = (q * scale) . k, softcap * tanh(s / softcap) when softcap > 0;
//   key j is live for query i iff j < min(Sk, kv_valid), and, when causal,
//   q_offset + i >= j, and, when window > 0, q_offset + i - j < window;
//   online softmax over live keys only, out = acc / max(l, 1e-30) (a row
//   with no live key gives 0). GQA: query head h reads kv head h / (H / KV).
//
// Design: the Pallas grid's sequential kv axis becomes a loop inside the
// block. A block owns BQ = 32 query rows of one (batch, head), one thread
// per row, with the f32 query row and (BQ, d) accumulator in registers and
// the running max / sum per thread. K/V tiles of BK = 32 rows are staged in
// shared memory as f32 and read as broadcasts. The loop visits only the
// block's live key range (causal end, window start, kv_valid), so wholly
// masked tiles are never loaded. Masked scores use a finite NEG_INF and
// contribute p = 0 explicitly, so fully masked rows never produce NaN.
//
// What bounds it on the H100: at the main path's shapes (d = 64, S <= 2K)
// the bound is bytes (q, k, v read once, out written once), but this first
// kernel computes with f32 FMAs on the CUDA cores, not on the tensor cores,
// so it is far from that bound; mma/wgmma tiles are the next step.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides: batch, token, head (the head dim is contiguous)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int Sq, Sk, H, KV;
  int causal, window, q_offset, kv_valid;
  float scale, softcap;
};

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(const Params p) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / (p.H / p.KV);
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + threadIdx.x;
  const bool row_ok = row < p.Sq;
  const int qpos = p.q_offset + row;

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);

  float q[D];
  float acc[D];
  {
    const T* qr = Q + b * p.q_sb + (long long)(row_ok ? row : 0) * p.q_ss +
                  h * p.q_sh;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[c] = row_ok ? to_f32(qr[c]) * p.scale : 0.f;
      acc[c] = 0.f;
    }
  }
  float m = NEG_INF;
  float l = 0.f;

  // live key range of the whole block (whole-tile skip)
  const int n_valid = min(p.Sk, p.kv_valid);
  const int last_row = min(row0 + BQ, p.Sq) - 1;
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, p.q_offset + last_row + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, p.q_offset + row0 - p.window + 1);

  const long long k_base = b * p.k_sb + kh * p.k_sh;
  const long long v_base = b * p.v_sb + kh * p.v_sh;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * D; e += BQ) {
      const int r = e / D;
      const int c = e - r * D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < kv_end) {
        kv = to_f32(K[k_base + (long long)kr * p.k_ss + c]);
        vv = to_f32(V[v_base + (long long)kr * p.v_ss + c]);
      }
      Ks[r][c] = kv;
      Vs[r][c] = vv;
    }
    __syncthreads();

    float s[BK];
    unsigned live = 0u;
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kpos = k0 + j;
      float dot = 0.f;
      const float4* kr4 = reinterpret_cast<const float4*>(Ks[j]);
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 kk = kr4[c4];
        dot = fmaf(q[4 * c4 + 0], kk.x, dot);
        dot = fmaf(q[4 * c4 + 1], kk.y, dot);
        dot = fmaf(q[4 * c4 + 2], kk.z, dot);
        dot = fmaf(q[4 * c4 + 3], kk.w, dot);
      }
      if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
      bool ok = row_ok && kpos < kv_end;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
      s[j] = ok ? dot : NEG_INF;
      if (ok) {
        live |= (1u << j);
        tile_max = fmaxf(tile_max, dot);
      }
    }
    if (live == 0u) continue;
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (live & (1u << j)) {
        const float pj = expf(s[j] - m_new);
        l += pj;
        const float4* vr4 = reinterpret_cast<const float4*>(Vs[j]);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr4[c4];
          acc[4 * c4 + 0] = fmaf(pj, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(pj, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(pj, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(pj, vv.w, acc[4 * c4 + 3]);
        }
      }
    }
    m = m_new;
  }

  if (row_ok) {
    T* O = static_cast<T*>(p.o) + b * p.o_sb + (long long)row * p.o_ss +
           h * p.o_sh;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c) O[c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T>
int launch(const Params& p, int B, int D, cudaStream_t s) {
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  switch (D) {
    case 32:
      flash_fwd_kernel<T, 32><<<grid, BQ, 0, s>>>(p);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, BQ, 0, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, D), k/v: (B, Sk, KV, D), out: (B, Sq, H, D), each with a
// contiguous head dim; strides[12] are the element strides (batch, token,
// head) of q, k, v, out in that order. Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides, int B,
                                   int Sq, int Sk, int H, int KV, int D,
                                   int causal, int window, int q_offset,
                                   int kv_valid, float scale, float softcap,
                                   int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.kv_valid = kv_valid;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, B, D, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(p, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
