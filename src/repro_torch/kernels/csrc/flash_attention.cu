// Blocked causal flash attention for Hopper: dense, segmented and
// positioned modes, with a query offset in the dense mode.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention in its three modes:
//   dense       neither seg_* nor pos_*; extended with q_offset: query row i
//               sits at absolute position q_offset + i (bottom-right causal
//               alignment of Sq suffix queries over Sk = q_offset + Sq keys,
//               the prefix-cache-hit forward);
//   segmented   seg_q/seg_k (B, Sq)/(B, Sk) int32 segment ids (the packed
//               miss): attention only where seg_q == seg_k and seg_k >= 0;
//               the causal and window masks keep the structural packed
//               indices (valid because segments are contiguous);
//   positioned  seg_* plus pos_q/pos_k per-token absolute positions (the
//               packed hit, keys = concat(gathered prefix KV, fresh KV)):
//               the causal and window masks use the positions.
//
// Semantics (same as the plain version in kernels/flash_attention.py):
//   s = (q * scale) . k, softcap * tanh(s / softcap) when softcap > 0;
//   key j is live for query i iff j < min(Sk, kv_valid), and, when causal,
//   qpos(i) >= kpos(j), and, when window > 0, qpos(i) - kpos(j) < window,
//   and, when segmented, seg_q(i) == seg_k(j) >= 0; online softmax over live
//   keys only, out = acc / max(l, 1e-30) (a row with no live key gives 0).
//   GQA: query head h reads kv head h / (H / KV).
//
// Design: the Pallas grid's sequential kv axis becomes a loop inside the
// block. A block owns BQ = 32 query rows of one (batch, head), one thread
// per row (one warp), with the f32 query row and (BQ, d) accumulator in
// registers and the running max / sum per thread. K/V tiles of BK = 32
// rows are staged in shared memory as f32 and read as broadcasts.
// Whole-tile skip, as the Pallas kernel's pl.when range tests:
//   - dense/segmented: the loop covers only the block's structural live
//     key range (causal end, window start, kv_valid);
//   - every tile first loads its BK segment ids / positions (one per lane)
//     and reduces their min / max with warp intrinsics; a tile runs only if
//     its segment-id range meets the query block's, it holds a seg_k >= 0,
//     and (positioned) min(pos_k) <= max(pos_q) under causal and
//     max(pos_k) >= min(pos_q) - window + 1 under a window.
//   Ranges are taken over real tokens only (seg >= 0): a padding query
//   attends nothing, so it does not widen its block's range. (The Pallas
//   kernel counts padding rows, so the query block that holds the end of
//   the last segment and the padding tail runs every tile of the causal
//   range; here it runs only its own segments' tiles.)
// A skipped tile loads no K/V. Tiles are BK-aligned, so an optional
// (B, nq, nk) int map records the executed tiles (head 0 writes it), the
// counterpart of the Pallas debug_tile_map. Masked scores use a finite
// NEG_INF and contribute p = 0 explicitly, so fully masked rows (padding
// queries) return 0 and never NaN.
//
// What bounds it on the H100: at the main path's shapes (d = 64, S <= 2K,
// Sk <= ~5K) the bound is bytes (q, k, v read once, out written once), but
// this first kernel computes with f32 FMAs on the CUDA cores, not on the
// tensor cores, so it is far from that bound; mma/wgmma tiles are the next
// step.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // per-token int32 arrays, contiguous (B, Sq) / (B, Sk), or null
  const int* seg_q;
  const int* seg_k;
  const int* pos_q;
  const int* pos_k;
  int* tile_map;  // (B, nq, nk) int32, zeroed by the caller, or null
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
  static_assert(BQ == 32 && BK == 32, "one warp per block, one key per lane");
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];
  __shared__ int seg_ks[BK];
  __shared__ int pos_ks[BK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / (p.H / p.KV);
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + lane;
  const bool row_ok = row < p.Sq;
  const bool segmented = p.seg_q != nullptr;
  const bool positioned = p.pos_q != nullptr;

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

  // this row's segment id and absolute position, and the block's ranges
  // over its real rows (the tile tests)
  int seg_self = -1;
  int qpos = p.q_offset + row;
  if (segmented && row_ok) seg_self = p.seg_q[(long long)b * p.Sq + row];
  if (positioned && row_ok) qpos = p.pos_q[(long long)b * p.Sq + row];
  const bool q_real = row_ok && (!segmented || seg_self >= 0);
  const int q_smin = __reduce_min_sync(FULL, q_real ? seg_self : INT_MAX);
  const int q_smax = __reduce_max_sync(FULL, q_real ? seg_self : INT_MIN);
  const int q_pmin = __reduce_min_sync(FULL, q_real ? qpos : INT_MAX);
  const int q_pmax = __reduce_max_sync(FULL, q_real ? qpos : INT_MIN);

  // structural live key range of the whole block (the positioned mode has
  // no structural order: its causal/window skips are the position tests)
  const int n_valid = min(p.Sk, p.kv_valid);
  const int last_row = min(row0 + BQ, p.Sq) - 1;
  int kv_end = n_valid;
  int kv_begin = 0;
  if (!positioned) {
    if (p.causal) kv_end = min(kv_end, p.q_offset + last_row + 1);
    if (p.window > 0) kv_begin = max(0, p.q_offset + row0 - p.window + 1);
  }
  kv_begin = (kv_begin / BK) * BK;  // BK-aligned tiles
  const int nk = (p.Sk + BK - 1) / BK;
  int* tmap = (p.tile_map != nullptr && h == 0 && lane == 0)
                  ? p.tile_map + ((long long)b * gridDim.x + blockIdx.x) * nk
                  : nullptr;

  const long long k_base = b * p.k_sb + kh * p.k_sh;
  const long long v_base = b * p.v_sb + kh * p.v_sh;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    const int key = k0 + lane;
    const bool key_ok = key < n_valid;  // the tile's real keys
    int seg_k = -1;
    int kpos = key;
    if (segmented && key_ok) seg_k = p.seg_k[(long long)b * p.Sk + key];
    if (positioned && key_ok) kpos = p.pos_k[(long long)b * p.Sk + key];
    const bool k_real = key_ok && (!segmented || seg_k >= 0);
    bool run = true;
    if (segmented) {
      const int k_smin = __reduce_min_sync(FULL, k_real ? seg_k : INT_MAX);
      const int k_smax = __reduce_max_sync(FULL, k_real ? seg_k : INT_MIN);
      run = q_smin <= k_smax && q_smax >= k_smin && k_smax >= 0;
    }
    if (positioned) {
      const int k_pmin = __reduce_min_sync(FULL, k_real ? kpos : INT_MAX);
      const int k_pmax = __reduce_max_sync(FULL, k_real ? kpos : INT_MIN);
      if (p.causal) run = run && k_pmin <= q_pmax;
      if (p.window > 0)
        run = run && (long long)k_pmax >= (long long)q_pmin - p.window + 1;
    }
    if (tmap != nullptr) tmap[k0 / BK] = run ? 1 : 0;
    if (!run) continue;  // warp-uniform: no K/V load, no compute
    seg_ks[lane] = seg_k;
    pos_ks[lane] = kpos;
    for (int e = lane; e < BK * D; e += BQ) {
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
      const int kp = pos_ks[j];
      bool ok = row_ok && k0 + j < kv_end;
      if (p.causal) ok = ok && qpos >= kp;
      if (p.window > 0) ok = ok && (long long)qpos - kp < p.window;
      if (segmented) ok = ok && seg_ks[j] == seg_self && seg_ks[j] >= 0;
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
// head) of q, k, v, out in that order. seg_q/pos_q (B, Sq), seg_k/pos_k
// (B, Sk) contiguous int32 or null (pos_* only with seg_*); tile_map a
// zeroed (B, ceil(Sq/32), ceil(Sk/32)) int32 buffer or null. Returns a
// cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides,
                                   const int* seg_q, const int* seg_k,
                                   const int* pos_q, const int* pos_k,
                                   int* tile_map, int B, int Sq, int Sk, int H,
                                   int KV, int D, int causal, int window,
                                   int q_offset, int kv_valid, float scale,
                                   float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((seg_q == nullptr) != (seg_k == nullptr) ||
      (pos_q == nullptr) != (pos_k == nullptr) ||
      (pos_q != nullptr && seg_q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.seg_q = seg_q;
  p.seg_k = seg_k;
  p.pos_q = pos_q;
  p.pos_k = pos_k;
  p.tile_map = tile_map;
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
