// Fused SwiGLU MLP for Hopper: out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces the Pallas kernel repro/kernels/fused_mlp.py::fused_mlp and keeps
// its rounding order: g = x.Wg and u = x.Wu in f32, a = silu(g) * u cast to
// the input dtype, out = sum(a.Wd) in f32 cast to the input dtype. Like the
// Pallas kernel, the (T, d_ff) intermediate never reaches device memory.
//
// The Pallas tiling does not carry over: its (256, D) f32 accumulator is
// 1 MiB at D = 1024, above an SM's 227 KB. Here a block owns BT = 8 tokens
// and ALL D output columns, and walks d_ff in chunks of BF = 32:
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
//
// What bounds it on the H100: 6 T D F flops against one read of the three
// weight matrices, i.e. operations at the main path's T >= 512. This first
// kernel computes with f32 FMAs on the CUDA cores, not on the tensor cores,
// and reads the weights once per 8 tokens, so it is far from that bound;
// tensor-core tiles with larger token tiles are the next step.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BT = 8;             // tokens per block
constexpr int BF = 32;            // d_ff columns per chunk
constexpr int NT = 256;           // threads per block (= BT * BF)
constexpr int NDG = NT / BF;      // slices of D in the gate/up phase
static_assert(NT == BT * BF, "epilogue maps one (token, column) per thread");

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

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
  // the two widths the port's configs run: D = 128 and D = 1024
  if (D <= NT) return launch_k<T, 1>(x, wg, wu, wd, out, Tn, D, F, s);
  if (D <= 4 * NT) return launch_k<T, 4>(x, wg, wu, wd, out, Tn, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// x: contiguous (T, D); wg, wu: contiguous (D, F); wd: contiguous (F, D);
// out: contiguous (T, D). D % 32 == 0 and D <= 1024. Returns a cudaError_t
// code.
extern "C" int fused_mlp_fwd(const void* x, const void* wg, const void* wu,
                             const void* wd, void* out, int T, int D, int F,
                             int dtype, void* stream) {
  using namespace repro_torch;
  if (T <= 0) return 0;
  if (D <= 0 || F <= 0 || D % (NDG * 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, wg, wu, wd, out, T, D, F, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, wg, wu, wd, out, T, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
