// Split-K flash decoding for Hopper: one query token per (batch row, query
// head) against a deep KV cache.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention. The Pallas grid (B, KV, splits) walks the cache splits
// serially with an (m, l, acc) carry in VMEM; here the splits run in
// parallel and a second kernel merges them. The kernel is bound by bytes:
// every live K and V slot is read once, and the arithmetic is about 2 FMAs
// a byte at granite-3-8b's group of 4 (G*d for q.k and again for p.v, over
// 4d bytes a slot).
//
//   decode_split_tc_kernel  bf16, G >= 2 (GQA). Grid (B*KV, splits), 4
//                           warps; a block owns the G query heads of one
//                           (batch row, kv head) and one chunk of whole
//                           64-slot key tiles, walked up to kv_len[b].
//   decode_split_kernel     f32, and bf16 at G = 1 (a GEMV over the live
//                           slots, at 87-91% of its byte bound on qwen1.5-
//                           0.5b's shape): 16-byte loads into registers,
//                           q.k a warp-shuffle sum, an online softmax per
//                           lane group, merged in registers and shared
//                           memory.
//   decode_combine_kernel   grid (B*KV, G): rescales each split by
//                           exp(m_i - m) and writes acc / l in the output
//                           dtype.
//
// What held a GEMV design back at GQA, and what the tensor-core kernel
// does about each:
//   1. Wave quantisation: a split count aimed at a fixed 4 blocks a SM ran
//      granite's grid in 1.09 waves (576 blocks on 528 slots). The
//      wrapper's split rule now reads the instantiation's own residency
//      (decode_attention_occupancy) and, where the rows fit one wave, takes
//      the most splits of whole tiles whose blocks the card holds at once.
//   2. No loads in flight during the math: K and V tiles now stream through
//      a 3-stage cp.async ring in dynamic shared memory (rows padded to
//      D + 8 bf16, so ldmatrix and the 16-byte row reads are free of bank
//      conflicts); two tiles are in flight while the block computes on one,
//      their copies with a 128-byte L2 prefetch.
//      Slots at or past the chunk's end or kv_len[b] are zero-filled, not
//      read, and get an explicit zero weight; a chunk wholly past kv_len
//      loads nothing.
//   3. Repeated work per key row: each tile's scores are computed once, on
//      the tensor cores, with the keys on the M side: S^T (16 keys x 8
//      heads) = K (16 x d) . Q^T (d x 8) with mma.m16n8k16 (G <= 8 fits N =
//      8; q stays as it is, in bf16 fragments held for the whole chunk; the
//      scale is applied to the f32 products afterwards, so q * scale is
//      never rounded). The softmax state (m, l) is one block-wide value a
//      head, updated once a tile from the warps' tile maxima.
//   4. P.V stays f32 (p is not rounded to bf16, as in the Pallas kernel):
//      the tile's f32 p goes to shared memory and each thread sums 8 dims
//      of the G heads over its share of the tile's keys, reading each V
//      element from the ring once a block and using it for every head.
// Masked and empty slots get an explicit zero weight and m starts at a
// finite -1e30, so a split with no live slot contributes l = 0 and never
// NaN, and a row with kv_len = 0 returns 0.
//
// Head dims 32, 64, 96, 128 and 256. The GEMV kernel gives each key row LPK
// lanes of NP 16-byte packs each (NP = 1 but at D = 96, where a row's 12
// bf16 or 24 f32 packs take 4 or 8 lanes of 3 packs, and at f32 D = 256, 32
// lanes of 2), so LPK divides the warp. The tensor-core kernel needs D / 8
// to divide its 128 threads: 32, 64, 128 and 256 (198 KB of shared memory
// at 256, one block a SM); D = 96 takes only G = 1, in both dtypes
// (kernels/decode_attention.py width_rule). The combine kernel's blocks are
// min(D, 128) threads.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the tensor-core kernel: key slots a tile (chunks are whole tiles; each
// of the first kTile / 16 warps takes 16 keys' scores), K/V tiles in the
// ring, threads a block
constexpr int kTile = 64;
constexpr int kStages = 3;
constexpr int kTcThreads = 128;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kScoreWarps = kTile / 16;

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
struct Pack<bf16> {
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
  constexpr int PACKS = D / VEC;           // 16-byte packs a key row
  constexpr int NP = PACKS % 3 == 0 ? 3 : (PACKS > 32 ? PACKS / 32 : 1);
  constexpr int LPK = PACKS / NP;          // lanes per key row
  constexpr int EL = NP * VEC;             // a lane's elements of a row
  constexpr int KPW = 32 / LPK;            // key rows per warp per pass
  constexpr int NG = kWarps * KPW;         // key rows per block per pass
  constexpr int U0 = GP >= 8 ? 1 : (GP >= 4 ? 2 : 4);
  constexpr int U = (U0 + NP - 1) / NP;    // passes in flight
  static_assert(D % VEC == 0 && PACKS % NP == 0 && 32 % LPK == 0,
                "head_dim");

  const int bk = blockIdx.x;               // b * KV + kv head
  const int b = bk / KV, h = bk % KV;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's packs of a row: sub, sub + LPK, ..., so that each load
  // instruction of the LPK lanes reads LPK neighbouring packs
  const int sub = lane % LPK;
  const int key_off = warp * KPW + lane / LPK;
  const int c0 = split * chunk;
  const int end = min(min(c0 + chunk, S), max(kv_len[b], 0));

  float m[GP], l[GP], acc[GP][EL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EL; ++i) acc[g][i] = 0.f;
  }

  if (c0 < end) {                          // block-uniform
    float qf[GP][EL];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const T* qp = q + b * qs_b + (long long)(h * G + g) * qs_h + sub * VEC;
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          qf[g][j * VEC + i] =
              g < G ? to_f32(qp[j * LPK * VEC + i]) * scale : 0.f;
    }
    const T* kb = k + b * ks_b + h * ks_h + sub * VEC;
    const T* vb = v + b * vs_b + h * vs_h + sub * VEC;
    // the loop bound is block-uniform, so every lane reaches the shuffles
    for (int base = c0; base < end; base += NG * U) {
      uint4 kr[U][NP], vr[U][NP];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * NG + key_off;
        live[u] = idx < end;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (live[u]) {
            kr[u][j] = __ldg(reinterpret_cast<const uint4*>(
                kb + idx * ks_s + j * LPK * VEC));
            vr[u][j] = __ldg(reinterpret_cast<const uint4*>(
                vb + idx * vs_s + j * LPK * VEC));
          } else {
            kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      float s[U][GP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EL];
#pragma unroll
        for (int j = 0; j < NP; ++j) Pack<T>::unpack(kr[u][j], kf + j * VEC);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < EL; ++i) t = fmaf(qf[g][i], kf[i], t);
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
        for (int i = 0; i < EL; ++i) acc[g][i] *= corr;
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[EL];
#pragma unroll
        for (int j = 0; j < NP; ++j) Pack<T>::unpack(vr[u][j], vf + j * VEC);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float p = live[u] ? expf(s[u][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int i = 0; i < EL; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
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
      for (int i = 0; i < EL; ++i) {
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
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          sm_acc[warp][g][(sub + j * LPK) * VEC + i] = acc[g][j * VEC + i];
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

// cp_async16 (mma.cuh) with a 128-byte L2 prefetch: every key row of a
// tile is read whole (2 to 8 such lines at d 32 to 128), so the hint only
// widens each DRAM request to lines the block reads anyway
__device__ __forceinline__ void cp_async16_l2(uint32_t dst, const void* src,
                                              bool pred) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(pred ? 16 : 0));
}

// Dynamic shared memory of the tensor-core kernel: the K/V ring (kStages
// stages of a K tile then a V tile, rows padded to DS = D + 8 bf16), the
// tile's f32 p [kTile][GP] and the warps' tile maxima [kScoreWarps][GP],
// the block's m [GP]. After
// the loop the ring holds the warps' partial sums for the block's merge.
// 106 KB at D = 128 (2 blocks a SM), 57 KB at D = 64, 33 KB at D = 32, 198
// KB at D = 256 (1 block a SM: two 64-slot tiles of K and V in flight, 128
// KB, while the block computes on the third).
template <int D, int GP>
struct TcSmem {
  static constexpr int DS = D + 8;
  static constexpr int TILE = kTile * DS;               // bf16 elements
  static constexpr int RING_BYTES = kStages * 2 * TILE * 2;
  static constexpr int P_FLOATS = kTile * GP;
  static constexpr int BYTES =
      RING_BYTES + (P_FLOATS + kScoreWarps * GP + GP) * 4;
  static_assert((kTcWarps * GP * D + kTcWarps * GP) * 4 <= RING_BYTES,
                "the merge fits the ring");
};

// The tensor-core kernel. Its bound asks for one block a SM (a register cap
// of 255) and leaves the residency to the ring's shared memory: at D = 256 under the plain bound
// ptxas held the group-2 instantiation to 128 registers and spilt 12 bytes
// (164 registers and no spill with this one).
template <int D, int GP>
__global__ void __launch_bounds__(kTcThreads, 1) decode_split_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ kv_len,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, long long qs_b,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int S, int KV, int G,
    int splits, int chunk, float scale, float softcap) {
  using Sm = TcSmem<D, GP>;
  constexpr int DS = Sm::DS;
  constexpr int CPR = D / 8;                  // 16-byte pieces a row
  constexpr int CP_N = kTile * CPR / kTcThreads;   // copies a thread, K or V
  constexpr int CP_STEP = kTcThreads / CPR;   // rows between them
  constexpr int KG = kTcThreads / CPR;        // P.V: key groups of CPR lanes
  constexpr int KPT = kTile / KG;             // keys a thread a tile
  static_assert(GP == 2 || GP == 4 || GP == 8, "group padded to 2, 4, 8");
  static_assert(CP_N * kTcThreads == kTile * CPR && KPT * KG == kTile &&
                    kScoreWarps * 16 == kTile && kScoreWarps <= kTcWarps,
                "whole tiles");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dec_smem);
  float* p_s = reinterpret_cast<float*>(dec_smem + Sm::RING_BYTES);
  float* max_s = p_s + Sm::P_FLOATS;          // [kScoreWarps][GP]
  float* m_s = max_s + kScoreWarps * GP;      // [GP], the block's m

  const int bk = blockIdx.x;                  // b * KV + kv head
  const int b = bk / KV, h = bk % KV;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;    // mma fragment row, column pair
  const int c0 = split * chunk;
  const int end = min(min(c0 + chunk, S), max(kv_len[b], 0));
  const int ntiles = c0 < end ? (end - c0 + kTile - 1) / kTile : 0;

  // a thread's 16-byte copies keep their column and step by whole rows
  const int cp_r0 = tid / CPR, cp_c = (tid % CPR) * 8;
  const bf16* k_src = k + b * ks_b + h * ks_h + cp_c;
  const bf16* v_src = v + b * vs_b + h * vs_h + cp_c;
  auto load_tile = [&](int t) {
    bf16* Ks = ring + (t % kStages) * 2 * Sm::TILE;
    bf16* Vs = Ks + Sm::TILE;
    const int s0 = c0 + t * kTile;
#pragma unroll
    for (int i = 0; i < CP_N; ++i) {
      const int r = cp_r0 + i * CP_STEP;
      const long long slot = s0 + r;
      const bool ok = slot < end;             // dead slots: zero-filled
      cp_async16_l2(smem_u32(Ks + r * DS + cp_c),
                    ok ? k_src + slot * ks_s : k, ok);
      cp_async16_l2(smem_u32(Vs + r * DS + cp_c),
                    ok ? v_src + slot * vs_s : v, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // Q^T as the mma's B operand: lane (gq, tq) holds head gq's dims
  // 16kd + 2tq, +1 and 16kd + 2tq + 8, +9 (heads >= G are zero)
  uint32_t qb[D / 16][2];
  {
    const unsigned short* qh = reinterpret_cast<const unsigned short*>(
        q + b * qs_b + (long long)(h * G + gq) * qs_h);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = kd * 16 + 2 * tq + 8 * j;
        qb[kd][j] = gq < G ? (uint32_t)qh[c] | ((uint32_t)qh[c + 1] << 16)
                           : 0u;
      }
  }

  // P.V: this thread sums dims [pv_c, pv_c + 8) over keys pv_k0 + j * KG
  const int pv_k0 = tid / CPR, pv_c = (tid % CPR) * 8;
  float m[GP], l[GP], acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {          // block-uniform bound
    cp_async_wait<kStages - 2>();
    __syncthreads();          // tile t has landed; tile t - 1 is done with
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const bf16* Ks = ring + (t % kStages) * 2 * Sm::TILE;
    const bf16* Vs = Ks + Sm::TILE;
    const int s0 = c0 + t * kTile;

    // scores of this warp's 16 keys for the 8 head columns:
    // c[e] = (key 16 warp + gq + 8 (e >> 1), head 2 tq + (e & 1))
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bool scores = warp < kScoreWarps;   // warp-uniform
    if (scores) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(Ks + (warp * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * DS +
                                kd * 16 + (lane >> 4) * 8));
        mma_bf16(c, a, qb[kd][0], qb[kd][1]);
      }
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = c[e] * scale;
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        const bool live = s0 + warp * 16 + gq + 8 * (e >> 1) < end;
        c[e] = live ? sc : kNegInf;
        tmax[e & 1] = fmaxf(tmax[e & 1], c[e]);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(kFull, tmax[j], o));
      if (gq == 0 && 2 * tq < GP) {
        max_s[warp * GP + 2 * tq] = tmax[0];
        max_s[warp * GP + 2 * tq + 1] = tmax[1];
      }
    }
    __syncthreads();
    // the block's new max a head (the same in every thread: the tile's
    // first slot is live, so it is finite) and the rescale of the old sums
    float corr[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int w = 0; w < kScoreWarps; ++w) mx = fmaxf(mx, max_s[w * GP + g]);
      corr[g] = expf(m[g] - mx);
      m[g] = mx;
    }
    if (scores && 2 * tq < GP) {
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int g = 0; g < GP; g += 2)
        if (g == 2 * tq) {
          m0 = m[g];
          m1 = m[g + 1];
        }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int key = warp * 16 + gq + 8 * (e >> 1);
        const bool live = s0 + key < end;
        *reinterpret_cast<float2*>(p_s + key * GP + 2 * tq) =
            make_float2(live ? expf(c[e] - m0) : 0.f,
                        live ? expf(c[e + 1] - m1) : 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] *= corr[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr[g];
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = pv_k0 + j * KG;
      float vf[8], p[GP];
      Pack<bf16>::unpack(
          *reinterpret_cast<const uint4*>(Vs + key * DS + pv_c), vf);
#pragma unroll
      for (int g = 0; g < GP; g += 2) {
        const float2 pp = *reinterpret_cast<const float2*>(p_s + key * GP + g);
        p[g] = pp.x;
        p[g + 1] = pp.y;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        l[g] += p[g];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p[g], vf[i], acc[g][i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free for the merge

  // every thread holds the block's m: sum the key groups' (l, acc) in the
  // warp, then across warps through the ring
#pragma unroll
  for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] += __shfl_xor_sync(kFull, acc[g][i], o);
    }
  float* red = reinterpret_cast<float*>(dec_smem);   // [kTcWarps][GP][D]
  float* red_l = red + kTcWarps * GP * D;             // [kTcWarps][GP]
  if (lane < CPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(warp * GP + g) * D + pv_c + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) red_l[warp * GP + g] = l[g];
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) m_s[g] = m[g];
  }
  __syncthreads();
  const long long row = (long long)bk * splits + split;
  float* wa = ws_acc + row * G * D;
  float* wml = ws_ml + row * G * 2;
  for (int idx = tid; idx < G * D; idx += kTcThreads) {
    const int g = idx / D, dim = idx % D;
    float as = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) as += red[(w * GP + g) * D + dim];
    wa[idx] = as;
    if (dim == 0) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) ls += red_l[w * GP + g];
      wml[2 * g] = m_s[g];
      wml[2 * g + 1] = ls;
    }
  }
}

// Grid (B*KV, G), D threads: output (row, kv head, head g) dim threadIdx.x,
// the splits' partials rescaled to their common max.
template <typename T>
__global__ void __launch_bounds__(128) decode_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    T* __restrict__ out, int KV, int G, int D, int splits) {
  const int bk = blockIdx.x, g = blockIdx.y;
  const int b = bk / KV, h = bk % KV;
  const float* ml = ws_ml + (long long)bk * splits * G * 2 + 2 * g;
  const float* acc = ws_acc + (long long)bk * splits * G * D + g * D;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s * G * 2]);
  for (int dim = threadIdx.x; dim < D; dim += blockDim.x) {
    float ls = 0.f, as = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float e = expf(ml[s * G * 2] - mx);
      ls = fmaf(ml[s * G * 2 + 1], e, ls);
      as = fmaf(acc[(long long)s * G * D + dim], e, as);
    }
    out[((long long)b * KV * G + (long long)h * G + g) * D + dim] =
        from_f32<T>(ls > 0.f ? as / ls : 0.f);
  }
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void* out;
  float *ws_acc, *ws_ml;
  const long long* st;
  int B, S, KV, G, D, splits, chunk;
  float scale, softcap;
};

// One instantiation that decode_attention_fwd launches: the split kernel
// for (T, D, group padded to GP, tensor cores or not), its dynamic shared
// memory, and the residency query that the wrapper's split rule reads.
template <typename T, int D, int GP, bool TC>
struct Kernel {
  using Fn = void (*)(const T*, const T*, const T*, const int*, float*,
                      float*, long long, long long, long long, long long,
                      long long, long long, long long, long long, int, int,
                      int, int, int, float, float);
  static Fn fn() {
    if constexpr (TC)
      return decode_split_tc_kernel<D, GP>;
    else
      return decode_split_kernel<T, D, GP>;
  }
  static constexpr int smem() { return TC ? TcSmem<D, GP>::BYTES : 0; }
  static constexpr int threads() { return TC ? kTcThreads : kThreads; }
  // above 48 KB of dynamic shared memory the limit is raised, once
  static cudaError_t prepare() {
    if (smem() <= 48 * 1024) return cudaSuccess;
    static const cudaError_t attr = cudaFuncSetAttribute(
        fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem());
    return attr;
  }
  static int occupancy(int* blocks) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn(), threads(), smem()));
  }
  static int launch(const Args& a, cudaStream_t s) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long* st = a.st;
    const Fn split_kernel = fn();
    split_kernel<<<dim3(a.B * a.KV, a.splits), threads(), smem(), s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const int*>(a.kv_len),
        a.ws_acc, a.ws_ml, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], a.S, a.KV, a.G, a.splits, a.chunk, a.scale, a.softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<T><<<dim3(a.B * a.KV, a.G), a.D < 128 ? a.D : 128,
                               0, s>>>(
        a.ws_acc, a.ws_ml, static_cast<T*>(a.out), a.KV, a.G, a.D,
        a.splits);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Launch {
  const Args& a;
  cudaStream_t s;
  template <class K>
  int run() const { return K::launch(a, s); }
};

struct Occupancy {
  int* blocks;
  template <class K>
  int run() const { return K::occupancy(blocks); }
};

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The instantiations: the GEMV kernel at G = 1 in both dtypes; at D = 96
// nothing else (its 12 column pieces a row do not tile the tensor-core
// kernel's threads); otherwise bf16 takes the tensor-core kernel at G =
// 2..8 (padded to 2, 4, 8) and f32 the GEMV kernel at every G. The
// wrapper's rules (decode_attention.kernel_rule, width_rule) pick `tc` and
// refuse the rest before a launch.
template <typename T, int D, typename F>
int by_group(int G, bool tc, const F& f) {
  if (!tc && G == 1) return f.template run<Kernel<T, D, 1, false>>();
  if constexpr (D == 96) {
    return kInvalid;
  } else if constexpr (std::is_same<T, bf16>::value) {
    if (!tc) return kInvalid;
    if (G == 2) return f.template run<Kernel<T, D, 2, true>>();
    if (G >= 3 && G <= 4) return f.template run<Kernel<T, D, 4, true>>();
    if (G >= 5 && G <= 8) return f.template run<Kernel<T, D, 8, true>>();
    return kInvalid;
  } else {
    if (tc) return kInvalid;
    if (G == 2) return f.template run<Kernel<T, D, 2, false>>();
    if (G >= 3 && G <= 4) return f.template run<Kernel<T, D, 4, false>>();
    if (G >= 5 && G <= 8) return f.template run<Kernel<T, D, 8, false>>();
    return kInvalid;
  }
}

template <typename F>
int dispatch(int dtype, int D, int G, bool tc, const F& f) {
#define REPRO_DECODE_D(T)                                            \
  switch (D) {                                                       \
    case 32: return by_group<T, 32>(G, tc, f);                       \
    case 64: return by_group<T, 64>(G, tc, f);                       \
    case 96: return by_group<T, 96>(G, tc, f);                       \
    case 128: return by_group<T, 128>(G, tc, f);                     \
    case 256: return by_group<T, 256>(G, tc, f);                     \
    default: return kInvalid;                                        \
  }
  if (dtype == kFloat32) REPRO_DECODE_D(float)
  if (dtype == kBFloat16) REPRO_DECODE_D(bf16)
#undef REPRO_DECODE_D
  return kInvalid;
}

}  // namespace
}  // namespace repro_torch

// q: (B, 1, H, D) with strides (qs_b, qs_h); k, v: (B, S, KV, D) with
// strides (s_b, s_s, s_kv), unit dim stride, rows 16-byte aligned; kv_len:
// (B,) int32 on the device; out: contiguous (B, 1, H, D); ws: f32 workspace
// of B*KV*splits*G*(D+2) floats. strides = {qs_b, qs_h, ks_b, ks_s, ks_kv,
// vs_b, vs_s, vs_kv} in elements. Slots [split*chunk, (split+1)*chunk) go to
// split `split` (the split rule makes chunk whole key tiles; the kernels
// mask any other). Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* out, void* ws,
                                    const long long* strides, int B, int S,
                                    int H, int KV, int D, int splits,
                                    int chunk, float scale, float softcap,
                                    int dtype, int tc, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || H / KV > 8 || splits <= 0 || chunk <= 0 ||
      splits > 65535 || (long long)splits * chunk < S)
    return kInvalid;
  const int G = H / KV;
  float* w = static_cast<float*>(ws);
  const Args a{q, k, v, kv_len, out, w, w + (long long)B * KV * splits * G * D,
               strides, B, S, KV, G, D, splits, chunk, scale, softcap};
  return dispatch(dtype, D, G, tc != 0,
                  Launch{a, static_cast<cudaStream_t>(stream)});
}

// Resident blocks a SM of the split kernel that decode_attention_fwd
// launches for (dtype, D, G, tc), into *blocks: a host query, no launch.
extern "C" int decode_attention_occupancy(int dtype, int D, int G, int tc,
                                          int* blocks) {
  using namespace repro_torch;
  return dispatch(dtype, D, G, tc != 0, Occupancy{blocks});
}
