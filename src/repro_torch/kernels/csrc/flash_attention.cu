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
// Two kernels, chosen by dtype (a rule, not a fallback):
//
// bf16 (the model path): FlashAttention-2-style tiles on the tensor cores.
// A block of 4 warps owns TQ = 64 query rows of one (batch, head), 16 per
// warp, and walks key tiles of TK = 64 rows: Q fragments are loaded once
// with ldmatrix and kept in registers; K and V tiles (and the tile's
// segment ids / positions) come through a 2-stage cp.async ring in padded
// shared rows; S = Q.K^T and O += P.V run on mma.sync.m16n8k16 (bf16 in,
// f32 accumulate); scale, softcap and the masks are applied in f32 on the
// accumulator fragments, the online softmax keeps each row's max and sum in
// the 4 threads of a quad (shuffles), and P is rounded to bf16 in registers
// as the A operand of P.V (as FlashAttention-2 does; the Pallas kernel and
// the plain version keep p in f32, ROADMAP C4). V fragments come through
// ldmatrix.trans. Where ceil(Sq / 64) * H * B blocks are fewer than the SMs,
// the wrapper splits the key tiles into chunks (kernels/flash_attention.py
// split_rule, a rule of shapes): each chunk writes f32 (m, l, acc) partials
// and flash_combine_kernel merges them in order, as flash decoding does.
//
// f32: the tensor cores take f32 only as TF32, which would break the f32
// checks, so f32 keeps the CUDA-core kernel: a block owns BQ = 32 query rows
// of one (batch, head), one thread per row (one warp), with the f32 query
// row and (BQ, d) accumulator in registers and the running max / sum per
// thread; K/V tiles of BK = 32 rows are staged in shared memory as f32.
//
// Whole-tile skip, in both kernels, as the Pallas kernel's pl.when range
// tests, at the kernel's own tile size:
//   - dense/segmented: the loop covers only the block's structural live
//     key range (causal end, window start, kv_valid);
//   - with segment ids a tile runs only if its segment-id range meets the
//     query block's, it holds a seg_k >= 0, and (positioned) min(pos_k) <=
//     max(pos_q) under causal and max(pos_k) >= min(pos_q) - window + 1
//     under a window; the ranges are warp reductions (__reduce_min_sync /
//     __reduce_max_sync) over the tile's ids, and the decision is
//     block-uniform.
//   Ranges are taken over real tokens only (seg >= 0): a padding query
//   attends nothing, so it does not widen its block's range. (The Pallas
//   kernel counts padding rows, so the query block that holds the end of
//   the last segment and the padding tail runs every tile of the causal
//   range; here it runs only its own segments' tiles.)
// A skipped tile loads no K/V. Tiles are tile-aligned, so an optional
// (B, nq, nk) int map records the executed tiles (head 0 writes it), the
// counterpart of the Pallas debug_tile_map. Masked scores never reach the
// sums (p = 0 explicitly, or exp2(-inf) = 0 from a finite running max), so
// fully masked rows (padding queries) return 0 and never NaN.
//
// What bounds it on the H100: at the main path's shapes (d = 64, S <= 2K,
// Sk <= ~5K) the live pairs' operations or the bytes of q, k, v and out,
// whichever is larger (kernels/flash_attention.py and chip_smoke.py reckon
// both from the live layout).
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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
  // bf16 key split: `splits` chunks of `chunk` key tiles; with splits > 1
  // f32 partials (splits, B, H, Sq, D) and (m, l) pairs (splits, B, H, Sq)
  int splits, chunk;
  float* part_acc;
  float* part_ml;
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

// f32 only (the tensor-core kernel below takes bf16)
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


// ---- bf16: tensor-core kernel ------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int TQ = 64;            // query rows per block, 16 per warp
constexpr int TK = 64;            // keys per tile
constexpr int TC_THREADS = 128;   // 4 warps
constexpr int WIN = 128;          // key tiles whose skip decisions a block holds
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx, flushing subnormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
// 3 blocks (12 warps) per SM: at most 168 registers a thread (4 blocks
// would cap it at 128 and spill)
__global__ void __launch_bounds__(TC_THREADS, 3)
    flash_fwd_tc_kernel(const Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DS = D + 8;       // padded smem row: ldmatrix conflict-free
  __shared__ __align__(16) bf16 Qs[TQ * DS];
  __shared__ __align__(16) bf16 Ks[2][TK * DS];
  __shared__ __align__(16) bf16 Vs[2][TK * DS];
  __shared__ int seg_s[2][TK];
  __shared__ int pos_s[2][TK];
  __shared__ unsigned char run_s[WIN];

  const int nqb = (p.Sq + TQ - 1) / TQ;
  const int qb = nqb - 1 - blockIdx.x % nqb;   // the longest causal rows first
  const int split = blockIdx.x / nqb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = qb * TQ;
  const bool segmented = p.seg_q != nullptr;
  const bool positioned = p.pos_q != nullptr;
  const bf16* Q = static_cast<const bf16*>(p.q);
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);

  // the query tile: the first cp.async group
  for (int c = tid; c < TQ * (D / 8); c += TC_THREADS) {
    const int r = c / (D / 8);
    const int dc = (c % (D / 8)) * 8;
    const bool ok = row0 + r < p.Sq;
    const bf16* src =
        ok ? Q + b * p.q_sb + (long long)(row0 + r) * p.q_ss + h * p.q_sh + dc
           : Q;
    cp_async16(smem_u32(Qs + r * DS + dc), src, ok);
  }
  cp_async_commit();

  // this thread's two rows (g and g + 8 of its warp's 16)
  int qpos[2], qseg[2];
  bool qok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + g + 8 * i;
    qok[i] = row < p.Sq;
    const long long at = (long long)b * p.Sq + row;
    qseg[i] = (segmented && qok[i]) ? p.seg_q[at] : -1;
    qpos[i] = (positioned && qok[i]) ? p.pos_q[at] : p.q_offset + row;
  }
  // the block's id and position ranges over its real rows (every warp
  // reduces all 64, so no shared memory is needed)
  int q_smin = INT_MAX, q_smax = INT_MIN, q_pmin = INT_MAX, q_pmax = INT_MIN;
  if (segmented) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + hf * 32 + lane;
      const long long at = (long long)b * p.Sq + row;
      const int sg = row < p.Sq ? p.seg_q[at] : -1;
      if (sg >= 0) {
        const int pp = positioned ? p.pos_q[at] : 0;
        q_smin = min(q_smin, sg);
        q_smax = max(q_smax, sg);
        q_pmin = min(q_pmin, pp);
        q_pmax = max(q_pmax, pp);
      }
    }
    q_smin = __reduce_min_sync(FULL, q_smin);
    q_smax = __reduce_max_sync(FULL, q_smax);
    q_pmin = __reduce_min_sync(FULL, q_pmin);
    q_pmax = __reduce_max_sync(FULL, q_pmax);
  }

  // structural live key range (the positioned mode has no structural order:
  // its causal/window skips are the position tests), then this split's share
  const int n_valid = min(p.Sk, p.kv_valid);
  const int last_row = min(row0 + TQ, p.Sq) - 1;
  int kv_end = n_valid;
  int kv_begin = 0;
  if (!positioned) {
    if (p.causal) kv_end = min(kv_end, p.q_offset + last_row + 1);
    if (p.window > 0) kv_begin = max(0, p.q_offset + row0 - p.window + 1);
  }
  const int t_lo = max(kv_begin / TK, split * p.chunk);
  const int t_hi = min(kv_end > 0 ? (kv_end + TK - 1) / TK : 0,
                       (split + 1) * p.chunk);
  const int nk = (p.Sk + TK - 1) / TK;
  int* tmap = (p.tile_map != nullptr && h == 0)
                  ? p.tile_map + ((long long)b * nqb + qb) * nk
                  : nullptr;

  // copy key tile t (K, V, and its ids / positions) into stage st; keys
  // past kv_valid are zero-filled. A thread's chunks keep their column and
  // step by whole rows, so their addresses are set up once.
  constexpr int KV_CHUNKS = TK * (D / 8) / TC_THREADS;
  constexpr int KV_RSTEP = TC_THREADS / (D / 8);
  static_assert(KV_CHUNKS * TC_THREADS == TK * (D / 8), "whole chunks");
  const int kv_r0 = tid / (D / 8);
  const int kv_dc = (tid % (D / 8)) * 8;
  const bf16* k_src = K + b * p.k_sb + kh * p.k_sh + kv_dc;
  const bf16* v_src = V + b * p.v_sb + kh * p.v_sh + kv_dc;
  auto load_tile = [&](int t, int st) {
    const int k0 = t * TK;
#pragma unroll
    for (int i = 0; i < KV_CHUNKS; ++i) {
      const int r = kv_r0 + i * KV_RSTEP;
      const bool ok = k0 + r < n_valid;
      const long long kr = k0 + r;
      cp_async16(smem_u32(&Ks[st][r * DS + kv_dc]), ok ? k_src + kr * p.k_ss : K,
                 ok);
      cp_async16(smem_u32(&Vs[st][r * DS + kv_dc]), ok ? v_src + kr * p.v_ss : V,
                 ok);
    }
    if (segmented && tid < TK) {
      const bool ok = k0 + tid < p.Sk;
      const long long at = (long long)b * p.Sk + (ok ? k0 + tid : 0);
      cp_async4(smem_u32(&seg_s[st][tid]), p.seg_k + at, ok);
      if (positioned) cp_async4(smem_u32(&pos_s[st][tid]), p.pos_k + at, ok);
    }
  };

  // the skip decisions of key tiles [w0, w1) into run_s: each warp takes U
  // tiles at a time (their ids in flight together) and reduces each tile's
  // real keys' id and position ranges over its lanes
  auto decide = [&](int w0, int w1) {
    constexpr int U = 4;
    for (int t0 = w0 + warp * U; t0 < w1; t0 += 4 * U) {
      int sv[U][2], pv[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = (t0 + u) * TK + hf * 32 + lane;
          const bool ok = t0 + u < w1 && key < n_valid;
          const long long at = (long long)b * p.Sk + key;
          sv[u][hf] = ok ? p.seg_k[at] : -1;
          pv[u][hf] = (ok && positioned) ? p.pos_k[at] : 0;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int smin = INT_MAX, smax = INT_MIN, pmin = INT_MAX, pmax = INT_MIN;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (sv[u][hf] >= 0) {
            smin = min(smin, sv[u][hf]);
            smax = max(smax, sv[u][hf]);
            pmin = min(pmin, pv[u][hf]);
            pmax = max(pmax, pv[u][hf]);
          }
        }
        smin = __reduce_min_sync(FULL, smin);
        smax = __reduce_max_sync(FULL, smax);
        bool run = q_smin <= smax && q_smax >= smin && smax >= 0;
        if (positioned) {
          pmin = __reduce_min_sync(FULL, pmin);
          pmax = __reduce_max_sync(FULL, pmax);
          if (p.causal) run = run && pmin <= q_pmax;
          if (p.window > 0)
            run = run && (long long)pmax >= (long long)q_pmin - p.window + 1;
        }
        if (lane == 0 && t0 + u < w1) run_s[t0 + u - w0] = run ? 1 : 0;
      }
    }
  };

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // running max, log2 domain
  float l_r[2] = {0.f, 0.f};           // this thread's share of the sum
  uint32_t qf[D / 16][4];
  bool q_ready = false;

  // S = Q.K^T on tile t, masks, online softmax, O += P.V
  auto compute = [&](int t, int st) {
    const bf16* Kt = Ks[st];
    const bf16* Vt = Vs[st];
    const int k0 = t * TK;
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int jj = 0; jj < TK / 16; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(Kt + (jj * 16 + (lane & 7) + (lane >> 4) * 8)
                                          * DS + kd * 16
                                      + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jj], qf[kd], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kd], kf[2], kf[3]);
      }
    // scores to the log2 domain, s * scale * log2(e) (softcap: cap *
    // tanh(s * scale / cap) * log2(e)); each step is its own loop over the
    // fragment, so the common path stays one compact run of code
    if (p.softcap > 0.f) {
      const float inv_cap = 1.f / p.softcap;
      const float cap_log2 = p.softcap * LOG2E;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = cap_log2 * tanhf(s[j][e] * p.scale * inv_cap);
    } else {
      const float scale_log2 = p.scale * LOG2E;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
    // a dense tile that every row of the block sees whole needs no mask
    const bool whole =
        !segmented && k0 + TK <= n_valid &&
        (!p.causal || k0 + TK - 1 <= p.q_offset + row0) &&
        (p.window <= 0 || p.q_offset + last_row - k0 < p.window);
    if (!whole) {
      const bool causal = p.causal != 0;
      const bool windowed = p.window > 0;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = j * 8 + t4 * 2 + (e & 1);
          // selects, not branches: ids not loaded in this mode are unused
          const int kp = positioned ? pos_s[st][c] : k0 + c;
          const int ks = seg_s[st][c];
          bool ok = qok[i] & (k0 + c < n_valid);
          ok &= !causal | (qpos[i] >= kp);
          ok &= !windowed | ((long long)qpos[i] - kp < p.window);
          ok &= !segmented | ((ks == qseg[i]) & (ks >= 0));
          s[j][e] = ok ? s[j][e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);   // finite: m_r starts finite
      corr[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(s[j][e] - m_r[e >> 1]);   // masked: 0
        s[j][e] = pe;
        l_r[e >> 1] += pe;
      }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * DS + dd * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dd], a, vf[0], vf[1]);
        mma_bf16(o[2 * dd + 1], a, vf[2], vf[3]);
      }
    }
  };

  int st = 0;
  for (int w0 = t_lo; w0 < t_hi; w0 += WIN) {
    const int w1 = min(w0 + WIN, t_hi);
    if (segmented) {
      __syncthreads();          // the previous window's decisions are read
      decide(w0, w1);
      __syncthreads();
    }
    auto runs = [&](int t) { return !segmented || run_s[t - w0] != 0; };
    if (tmap != nullptr)
      for (int t = w0 + tid; t < w1; t += TC_THREADS) tmap[t] = runs(t);
    // a 2-stage ring over the window's running tiles
    int t = w0;
    while (t < w1 && !runs(t)) ++t;
    if (t < w1) load_tile(t, st);
    cp_async_commit();
    while (t < w1) {
      int tn = t + 1;
      while (tn < w1 && !runs(tn)) ++tn;
      if (tn < w1) load_tile(tn, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();       // tile t (and the query tile) has landed
      __syncthreads();
      if (!q_ready) {
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          ldmatrix_x4(qf[kd], smem_u32(Qs + (warp * 16 + (lane & 15)) * DS +
                                       kd * 16 + (lane >> 4) * 8));
        q_ready = true;
      }
      compute(t, st);
      __syncthreads();          // stage st is free for the load after next
      t = tn;
      st ^= 1;
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + g + 8 * i;
    if (row >= p.Sq) continue;
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
      bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + (long long)row * p.o_ss +
                h * p.o_sh + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(O + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    } else {
      const long long r =
          (((long long)split * gridDim.z + b) * p.H + h) * p.Sq + row;
      float* acc = p.part_acc + r * D + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(acc + dt * 8) =
            make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      if (t4 == 0) {
        p.part_ml[2 * r] = m_r[i];
        p.part_ml[2 * r + 1] = l_r[i];
      }
    }
  }
}

// Merge the key chunks' partials of every (b, h, row) in chunk order:
// out = sum_s 2^(m_s - m) acc_s / max(sum_s 2^(m_s - m) l_s, 1e-30), m the
// largest m_s; an empty chunk has (m, l) = (-1e30, 0) and adds nothing.
template <int D>
__global__ void __launch_bounds__(256) flash_combine_kernel(const Params p,
                                                            int B) {
  const long long rows = (long long)B * p.H * p.Sq;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= rows * (D / 2)) return;
  const long long r = i / (D / 2);
  const int c = static_cast<int>(i % (D / 2)) * 2;
  float m = NEG_INF;
  for (int s = 0; s < p.splits; ++s)
    m = fmaxf(m, p.part_ml[2 * (s * rows + r)]);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const long long rs = s * rows + r;
    const float w = exp2f(p.part_ml[2 * rs] - m);
    l += w * p.part_ml[2 * rs + 1];
    const float2 v = *reinterpret_cast<const float2*>(p.part_acc + rs * D + c);
    a0 += w * v.x;
    a1 += w * v.y;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int row = static_cast<int>(r % p.Sq);
  const int h = static_cast<int>((r / p.Sq) % p.H);
  const int b = static_cast<int>(r / ((long long)p.Sq * p.H));
  bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + (long long)row * p.o_ss +
            h * p.o_sh + c;
  *reinterpret_cast<__nv_bfloat162*>(O) = __floats2bfloat162_rn(a0 * inv, a1 * inv);
}

template <int D>
int launch_tc_d(const Params& p, int B, cudaStream_t s) {
  const int nqb = (p.Sq + TQ - 1) / TQ;
  const dim3 grid(nqb * p.splits, p.H, B);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long n = (long long)B * p.H * p.Sq * (D / 2);
  flash_combine_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, B);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const Params& p, int B, int D, cudaStream_t s) {
  if (p.splits < 1 || p.chunk < 1 ||
      (long long)p.splits * p.chunk < (p.Sk + TK - 1) / TK ||
      (p.splits > 1 && (p.part_acc == nullptr || p.part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch_tc_d<32>(p, B, s);
    case 64:
      return launch_tc_d<64>(p, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, Sq, H, D), k/v: (B, Sk, KV, D), out: (B, Sq, H, D), each with a
// contiguous head dim; strides[12] are the element strides (batch, token,
// head) of q, k, v, out in that order. seg_q/pos_q (B, Sq), seg_k/pos_k
// (B, Sk) contiguous int32 or null (pos_* only with seg_*); tile_map a
// zeroed (B, ceil(Sq/bq), ceil(Sk/bk)) int32 buffer or null, with (bq, bk)
// = (32, 32) for f32 and (64, 64) for bf16. bf16 only: the key split into
// `splits` chunks of `chunk` 64-key tiles, with f32 workspaces part_acc
// (splits, B, H, Sq, D) and part_ml (splits, B, H, Sq, 2) when splits > 1
// (bf16 also needs 16-byte aligned rows: element strides multiples of 8).
// Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides,
                                   const int* seg_q, const int* seg_k,
                                   const int* pos_q, const int* pos_k,
                                   int* tile_map, int B, int Sq, int Sk, int H,
                                   int KV, int D, int causal, int window,
                                   int q_offset, int kv_valid, float scale,
                                   float softcap, int splits, int chunk,
                                   void* part_acc, void* part_ml, int dtype,
                                   void* stream) {
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
  p.splits = splits;
  p.chunk = chunk;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, B, D, s);
  if (dtype == kBFloat16) return launch_tc(p, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
