// Fused SwiGLU MLP for Hopper: out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces the Pallas kernel repro/kernels/fused_mlp.py::fused_mlp and keeps
// its rounding order: g = x.Wg and u = x.Wu in f32, a = silu(g) * u rounded
// once to the input dtype, out = sum(a.Wd) in f32 cast once to the input
// dtype. The choice between the two designs below is a rule of dtype.
//
// bf16 (the model path): two tensor-core GEMMs, mma.sync.m16n8k16 with f32
// accumulators, fed by a ring of 16-byte cp.async stages in padded shared
// rows (ldmatrix is free of bank conflicts; Wg, Wu and Wd are row-major
// (K, N), so their fragments come through ldmatrix.trans).
//   1. gate/up: tiles of BM tokens x BN d_ff columns walk D in BK = 64
//      slices; every warp keeps two accumulators, g and u, fed by one x
//      fragment; the epilogue rounds a = silu(g) * u once to bf16 into a
//      (T, F) workspace. D is never split across blocks (the epilogue
//      needs whole sums); at small T a narrow BN fills the card.
//   2. down: out = a.Wd over tiles of BM tokens x BN output columns; where
//      the grid is short of the SMs, d_ff is split across blocks into f32
//      partials, which a second kernel sums in a fixed order and casts (no
//      atomics: results do not change from run to run).
// The launch plan (tiles and splits) is kernels/fused_mlp.py's mlp_plan.
// One departure from the Pallas kernel: a passes through device memory as
// bf16 (at the configs' hybrid chunk of 2048 tokens: 2048 x 2816 x 2 B =
// 11.5 MB at qwen1.5-0.5b, mostly L2-resident; 52 MB at granite-3-8b's d_ff
// of 12,800); the f32 g and u never do. A fused kernel would need a (BM, D)
// f32 accumulator per block, 256 KB at BM = 64 and D = 1024, above an SM's
// 227 KB. The bf16 kernels take any D % 32 == 0 and F % 8 == 0.
// What bounds it on the H100: the weights' bytes below T ~ 300 (17.3 MB at
// qwen1.5-0.5b width: 5.2 us; 315 MB a layer at granite-3-8b: 94 us), the
// 6 T D F operations above.
//
// f32: the tensor cores take f32 only as TF32 (a 10-bit mantissa), so f32
// inputs keep the CUDA-core kernel: a block owns BT = 8 tokens and ALL D
// output columns, and walks d_ff in chunks of BF = 32:
//   1. gate/up: 256 threads = 32 d_ff columns x 8 slices of D; each thread
//      accumulates g and u of its column for the 8 tokens over its slice
//      (x tile staged once in shared memory as f32, read as float4
//      broadcasts; weight rows read coalesced along d_ff);
//   2. a shared-memory reduction over the 8 slices and the silu * mul
//      epilogue, one (token, column) per thread, rounded to the input dtype;
//   3. down: each thread owns D / 256 output columns for the 8 tokens in
//      registers and adds a_chunk . Wd[chunk, cols].
// A ragged last chunk (d_ff not a multiple of 32) is masked. The f32
// accumulators stay in registers for the whole d_ff walk; only the
// (T, D) output is written.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// ---- f32: CUDA-core kernel -----------------------------------------------------
constexpr int BT = 8;             // tokens per block
constexpr int BF = 32;            // d_ff columns per chunk
constexpr int NT = 256;           // threads per block (= BT * BF)
constexpr int NDG = NT / BF;      // slices of D in the gate/up phase
static_assert(NT == BT * BF, "epilogue maps one (token, column) per thread");

template <typename T, int KMAX>
__global__ void __launch_bounds__(NT)
    fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                     const T* __restrict__ wu, const T* __restrict__ wd,
                     T* __restrict__ out, int Tn, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [BT][D]
  float* red = xs + BT * D;               // [NDG][BT][BF][2]
  float* as = red + NDG * BT * BF * 2;    // [BF][BT]

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  for (int e = tid; e < BT * D; e += NT) {
    const int r = e / D;
    const int c = e - r * D;
    xs[e] = (t0 + r < Tn) ? to_f32(x[(long long)(t0 + r) * D + c]) : 0.f;
  }

  float acc[BT][KMAX];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) acc[r][kk] = 0.f;

  const int fl = tid % BF;          // gate/up phase: column in the chunk
  const int dg = tid / BF;          // gate/up phase: slice of D
  const int dlen = D / NDG;         // D % (NDG * 4) == 0 (wrapper checks)
  const int d0 = dg * dlen;
  const int er = tid / BF;          // epilogue: token row
  const int ef = tid % BF;          // epilogue: column in the chunk
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += BF) {
    // 1. gate/up partial dot products over this thread's slice of D
    const int f = f0 + fl;
    float g[BT], u[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) g[r] = u[r] = 0.f;
    if (f < F) {
      for (int d = d0; d < d0 + dlen; d += 4) {
        float wg4[4], wu4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wg4[i] = to_f32(wg[(long long)(d + i) * F + f]);
          wu4[i] = to_f32(wu[(long long)(d + i) * F + f]);
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[r * D + d]);
          g[r] = fmaf(xv.x, wg4[0], g[r]);
          g[r] = fmaf(xv.y, wg4[1], g[r]);
          g[r] = fmaf(xv.z, wg4[2], g[r]);
          g[r] = fmaf(xv.w, wg4[3], g[r]);
          u[r] = fmaf(xv.x, wu4[0], u[r]);
          u[r] = fmaf(xv.y, wu4[1], u[r]);
          u[r] = fmaf(xv.z, wu4[2], u[r]);
          u[r] = fmaf(xv.w, wu4[3], u[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      red[((dg * BT + r) * BF + fl) * 2 + 0] = g[r];
      red[((dg * BT + r) * BF + fl) * 2 + 1] = u[r];
    }
    __syncthreads();

    // 2. reduce the slices; a = silu(g) * u rounded to the input dtype
    {
      float gs = 0.f, us = 0.f;
#pragma unroll
      for (int s = 0; s < NDG; ++s) {
        gs += red[((s * BT + er) * BF + ef) * 2 + 0];
        us += red[((s * BT + er) * BF + ef) * 2 + 1];
      }
      as[ef * BT + er] = (f0 + ef < F) ? round_to<T>(silu(gs) * us) : 0.f;
    }
    __syncthreads();

    // 3. down projection into the register accumulators
    const int nf = min(BF, F - f0);
    for (int fi = 0; fi < nf; ++fi) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[fi * BT]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[fi * BT + 4]);
      const float av[BT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const T* wrow = wd + (long long)(f0 + fi) * D;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        const int col = tid + kk * NT;
        if (col < D) {
          const float w = to_f32(wrow[col]);
#pragma unroll
          for (int r = 0; r < BT; ++r) acc[r][kk] = fmaf(av[r], w, acc[r][kk]);
        }
      }
    }
    // no barrier needed here: `red` is next written after every thread has
    // passed the barrier that precedes step 3, and `as` only after the
    // barrier that follows the next step 1
  }

#pragma unroll
  for (int r = 0; r < BT; ++r) {
    if (t0 + r >= Tn) break;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      const int col = tid + kk * NT;
      if (col < D) out[(long long)(t0 + r) * D + col] = from_f32<T>(acc[r][kk]);
    }
  }
}

template <typename T, int KMAX>
int launch_k(const void* x, const void* wg, const void* wu, const void* wd,
             void* out, int Tn, int D, int F, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)BT * D + (size_t)NDG * BT * BF * 2 + BF * BT);
  auto kernel = fused_mlp_kernel<T, KMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Tn + BT - 1) / BT;
  kernel<<<blocks, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), Tn, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, int Tn, int D, int F, cudaStream_t s) {
  // D <= 1024 (kernels/fused_mlp.py width_rule): the accumulators hold a
  // block's 8 tokens x D columns in registers, KMAX columns a thread
  if (D <= NT) return launch_k<T, 1>(x, wg, wu, wd, out, Tn, D, F, s);
  if (D <= 4 * NT) return launch_k<T, 4>(x, wg, wu, wd, out, Tn, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---- bf16: tensor-core GEMMs ------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int BK = 64;    // K elements per pipeline stage
constexpr int PAD = 8;    // bf16 of row padding: ldmatrix rows hit distinct banks

enum Epilogue : int { kSwiGLU = 0, kStoreBF16 = 1, kStoreF32 = 2 };

struct GemmArgs {
  const bf16* a;    // (M, K) row-major
  const bf16* b0;   // (K, N) row-major
  const bf16* b1;   // second (K, N) operand (kSwiGLU), else null
  void* c;          // (M, N) bf16, or f32 partials [split][M][N]
  int M, N, K;
  int k_chunk;      // K elements per split, a multiple of BK
  int epilogue;     // kSwiGLU (NB = 2), kStoreBF16 or kStoreF32 (NB = 1)
};

// BM x BN output tile; WM x WN warps over it, and WK warps over the four
// k16 steps of a stage (their sums are added in shared memory at the end);
// NB = 2 gives two B operands (gate and up) that share the A fragments.
template <int BM_, int BN_, int WM_, int WN_, int WK_, int NB_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, WK = WK_;
  static constexpr int NB = NB_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int MI = TM / 16, NI = TN / 8;    // mma tiles per warp
  static constexpr int KSTEPS = BK / 16 / WK;        // k16 steps per warp
  static constexpr int AS = BK + PAD, BS = BN + PAD;  // smem row strides
  static constexpr int A_ELEMS = BM * AS, B_ELEMS = BK * BS;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * B_ELEMS;
  static constexpr int ACC = MI * NI * NB * 4;       // f32 per lane
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;
  // 16-byte chunks a thread copies per stage, and the rows between them
  static constexpr int A_CHUNKS = BM * (BK / 8) / THREADS;
  static constexpr int A_RSTEP = THREADS / (BK / 8);
  static constexpr int B_CHUNKS = BK * (BN / 8) / THREADS;
  static constexpr int B_RSTEP = THREADS / (BN / 8);
  static_assert(A_CHUNKS * THREADS == BM * (BK / 8) &&
                    B_CHUNKS * THREADS == BK * (BN / 8),
                "every thread copies whole chunks of A and B");
  static_assert(TM % 16 == 0 && TN % 16 == 0, "whole x4 fragments");
  static_assert((BK / 16) % WK == 0, "k16 steps split evenly");
  static_assert((WK - 1) * WM * WN * 32 * ACC * 4 <= SMEM,
                "the k-warp reduction fits the pipeline's shared memory");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS)
    mlp_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wmn = warp % (C::WM * C::WN);
  const int wk = warp / (C::WM * C::WN);
  const int wm = wmn / C::WN;
  const int wn = wmn % C::WN;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.x * C::BN;
  const int k_begin = blockIdx.z * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const int ktiles = (k_end - k_begin + BK - 1) / BK;

  // Copy K-slice kt of A and B into pipeline stage `stage`; rows past M or
  // k_end and columns past N are zero-filled (K and N are multiples of 8,
  // so a 16-byte chunk is wholly in or out). A thread's chunks keep their
  // column and step by whole rows, so their addresses are set up once.
  const int a_r0 = tid / (BK / 8);
  const int a_kc = (tid % (BK / 8)) * 8;
  const bf16* a_src = p.a + (long long)(m0 + a_r0) * p.K + k_begin + a_kc;
  const int b_r0 = tid / (C::BN / 8);
  const int b_nc = (tid % (C::BN / 8)) * 8;
  const bool b_col_ok = n0 + b_nc < p.N;
  const long long b_at = (long long)(k_begin + b_r0) * p.N + n0 + b_nc;
  const uint32_t smem_base = smem_u32(smem);
  auto load_stage = [&](int kt, int stage) {
    const int kvalid = k_end - k_begin - kt * BK;   // K left in this slice
    const uint32_t st = smem_base + stage * C::STAGE_ELEMS * 2;
#pragma unroll
    for (int i = 0; i < C::A_CHUNKS; ++i) {
      const int r = a_r0 + i * C::A_RSTEP;
      const bool ok = m0 + r < p.M && a_kc < kvalid;
      const bf16* src =
          ok ? a_src + (long long)i * C::A_RSTEP * p.K + kt * BK : p.a;
      cp_async16(st + (r * C::AS + a_kc) * 2, src, ok);
    }
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb) {
      const bf16* B = nb == 0 ? p.b0 : p.b1;
#pragma unroll
      for (int j = 0; j < C::B_CHUNKS; ++j) {
        const int r = b_r0 + j * C::B_RSTEP;
        const bool ok = b_col_ok && r < kvalid;
        const bf16* src =
            ok ? B + b_at + ((long long)j * C::B_RSTEP + kt * BK) * p.N : B;
        cp_async16(st + (C::A_ELEMS + nb * C::B_ELEMS + r * C::BS + b_nc) * 2,
                   src, ok);
      }
    }
  };

  float acc[C::MI][C::NI][C::NB][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][nb][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // slice kt has landed (this thread's)
    __syncthreads();                 // ... everyone's; slice kt-1 is consumed
    {
      const int nt = kt + C::STAGES - 1;
      if (nt < ktiles) load_stage(nt, nt % C::STAGES);
      cp_async_commit();
    }
    const bf16* As = smem + (kt % C::STAGES) * C::STAGE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      const int kk = (ks * C::WK + wk) * 16;
      uint32_t af[C::MI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ldmatrix_x4(af[mi], smem_u32(As + (wm * C::TM + mi * 16 + (lane & 15))
                                              * C::AS + kk + (lane >> 4) * 8));
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb) {
        const bf16* Bs = As + C::A_ELEMS + nb * C::B_ELEMS;
#pragma unroll
        for (int n2 = 0; n2 < C::NI / 2; ++n2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, smem_u32(Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                    * C::BS + wn * C::TN + n2 * 16
                                + (lane >> 4) * 8));
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            mma_bf16(acc[mi][2 * n2][nb], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * n2 + 1][nb], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (C::WK > 1) {
    // add the k-warps' sums in a fixed order (k-warp 0 + 1 + 2 + ...)
    __syncthreads();                      // the pipeline's smem is free
    float* red = reinterpret_cast<float*>(smem_raw);
    float* flat = &acc[0][0][0][0];
    if (wk > 0) {
      float* dst = red + ((wk - 1) * C::WM * C::WN + wmn) * C::ACC * 32;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) dst[i * 32 + lane] = flat[i];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < C::WK; ++w) {
      const float* src = red + ((w - 1) * C::WM * C::WN + wmn) * C::ACC * 32;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) flat[i] += src[i * 32 + lane];
    }
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * C::TM + mi * 16 + g + half * 8;
        const int col = n0 + wn * C::TN + ni * 8 + t4 * 2;
        if (row >= p.M || col >= p.N) continue;
        float v0 = acc[mi][ni][0][2 * half];
        float v1 = acc[mi][ni][0][2 * half + 1];
        if (p.epilogue == kStoreF32) {
          float* out = static_cast<float*>(p.c) +
                       ((long long)blockIdx.z * p.M + row) * p.N + col;
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          continue;
        }
        if constexpr (C::NB == 2) {   // a = silu(g) * u, rounded once
          v0 = silu(v0) * acc[mi][ni][1][2 * half];
          v1 = silu(v1) * acc[mi][ni][1][2 * half + 1];
        }
        bf16* out = static_cast<bf16*>(p.c) + (long long)row * p.N + col;
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
      }
}

// out[i] = bf16(sum over s of part[s][i]), s in order; n % 4 == 0.
__global__ void __launch_bounds__(256)
    split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                     int splits, long long n) {
  const long long i = (blockIdx.x * 256LL + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int k = 1; k < splits; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(part + k * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(s.x, s.y);
  *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
      __floats2bfloat162_rn(s.z, s.w);
}

template <class C>
int launch_gemm(const GemmArgs& args, int splits, cudaStream_t s) {
  auto kernel = mlp_gemm_kernel<C>;
  if (C::SMEM > 48 * 1024) {
    // once per instantiation (thread-safe static initialisation)
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((args.N + C::BN - 1) / C::BN, (args.M + C::BM - 1) / C::BM,
                  splits);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The gate/up tiles of kernels/fused_mlp.py (GATE_UP_TILES), by (BM, BN),
// and its DOWN_TILE.
int launch_gate_up(const GemmArgs& a, int bm, int bn, cudaStream_t s) {
  if (bm == 128 && bn == 64)
    return launch_gemm<Tile<128, 64, 2, 4, 1, 2, 3>>(a, 1, s);
  if (bm == 64 && bn == 32)
    return launch_gemm<Tile<64, 32, 2, 2, 1, 2, 4>>(a, 1, s);
  if (bm == 16 && bn == 16)
    return launch_gemm<Tile<16, 16, 1, 1, 4, 2, 4>>(a, 1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_down(const GemmArgs& a, int splits, cudaStream_t s) {
  return launch_gemm<Tile<64, 128, 2, 4, 1, 1, 3>>(a, splits, s);
}

}  // namespace
}  // namespace repro_torch

// f32 only: x contiguous (T, D); wg, wu contiguous (D, F); wd contiguous
// (F, D); out contiguous (T, D). D % 32 == 0 and D <= 1024. Returns a
// cudaError_t code.
extern "C" int fused_mlp_fwd(const void* x, const void* wg, const void* wu,
                             const void* wd, void* out, int T, int D, int F,
                             int dtype, void* stream) {
  using namespace repro_torch;
  if (T <= 0) return 0;
  if (D <= 0 || F <= 0 || D % (NDG * 4) != 0 || dtype != kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(x, wg, wu, wd, out, T, D, F,
                       static_cast<cudaStream_t>(stream));
}

// bf16: x (T, D), wg/wu (D, F), wd (F, D), out (T, D), all contiguous with
// 16-byte aligned bases; a: a (T, F) bf16 workspace; part: a (splits, T, D)
// f32 workspace when splits > 1. D % 32 == 0, F % 8 == 0. The plan: the
// gate/up tile (gu_bm, gu_bn); the down product's d_ff split into `splits`
// chunks of `chunk` (a multiple of 64) elements. Returns a cudaError_t
// code.
extern "C" int fused_mlp_bf16_fwd(const void* x, const void* wg,
                                  const void* wu, const void* wd, void* a,
                                  void* part, void* out, int T, int D, int F,
                                  int gu_bm, int gu_bn, int splits, int chunk,
                                  void* stream) {
  using namespace repro_torch;
  if (T <= 0) return 0;
  if (D <= 0 || F <= 0 || D % 32 != 0 || F % 8 != 0 || splits < 1 ||
      chunk % BK != 0 || (long long)splits * chunk < F ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs gu{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
              static_cast<const bf16*>(wu), a, T, F, D,
              (D + BK - 1) / BK * BK, kSwiGLU};
  int err = launch_gate_up(gu, gu_bm, gu_bn, s);
  if (err != 0) return err;
  GemmArgs dn{static_cast<const bf16*>(a), static_cast<const bf16*>(wd),
              nullptr, splits > 1 ? part : out, T, D, F, chunk,
              splits > 1 ? kStoreF32 : kStoreBF16};
  err = launch_down(dn, splits, s);
  if (err != 0 || splits == 1) return err;
  const long long n = (long long)T * D;
  split_sum_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), splits, n);
  return static_cast<int>(cudaGetLastError());
}
