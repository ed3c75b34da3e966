// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm. One block
// per row: a strided pass accumulates sum(x^2) in f32, a warp-shuffle plus
// shared-memory reduction gives rsqrt, and a second pass (the row is still
// in L1) writes the scaled row. Bound by bytes: one read of x and one write
// of y; at D = 1024 a row is 2 KB in bf16, so the kernel streams rows and
// does ~4 flops per element.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int D, long long x_row_stride,
                   float eps) {
  const T* xr = x + (long long)blockIdx.x * x_row_stride;
  T* yr = y + (long long)blockIdx.x * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float part[kThreads / 32];
  __shared__ float inv;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += part[i];
    inv = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float r = inv;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float v = to_f32(xr[c]);
    yr[c] = from_f32<T>((v * r) * (1.f + to_f32(w[c])));
  }
}

}  // namespace
}  // namespace repro_torch

// x: T rows of D elements, row stride x_row_stride (elements), unit column
// stride; w: (D,); y: contiguous (T, D). Returns a cudaError_t code.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int T,
                           int D, long long x_row_stride, float eps,
                           int dtype, void* stream) {
  using namespace repro_torch;
  if (T <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rmsnorm_kernel<float><<<T, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), D, x_row_stride, eps);
  } else if (dtype == kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<T, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, x_row_stride, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
