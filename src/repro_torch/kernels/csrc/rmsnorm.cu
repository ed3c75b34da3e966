// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm. Bound by
// bytes: one read of x and one write of y (w, D elements, is read by every
// row from L2), ~4 flops an element. A block a row reading 2-byte scalars
// reads x twice (the sum of squares, then the scaled write) and takes two
// __syncthreads a row; this kernel makes a single pass over device memory
// per row:
//
//   rmsnorm_kernel_vec     each thread loads its share of the row as 16-byte
//                          vectors (8 bf16 or 4 f32, up to kMaxVectors of
//                          them) into registers, the sum of squares is a
//                          warp-shuffle reduction (through shared memory
//                          only when a row spans more than one warp), and
//                          the thread scales the row from its registers and
//                          stores 16-byte vectors; w is read as 16-byte
//                          vectors too, in the same round trip as x. Warps
//                          a row and rows a block come from the wrapper's
//                          launch plan (rmsnorm.launch_plan): one warp a row
//                          up to 32 x kMaxVectors vectors (bf16 D 1024),
//                          more warps a row above; several rows a block
//                          where there are rows enough to give every SM a
//                          block, one row a block where there are not.
//   rmsnorm_kernel_scalar  the rule of width for what the vectors cannot
//                          take: D not a multiple of the vector width, a row
//                          stride or base that is not 16-byte aligned, or a
//                          row longer than 1024 threads' registers hold. One
//                          256-thread block a row, element by element, two
//                          passes (the second from L1).
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxVectors = 4;     // 16-byte vectors a thread holds
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* o) {
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                      __float_as_uint(o[2]), __float_as_uint(o[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // little-endian: low half first
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* o) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Block: rows_per_block rows of warps_per_row warps. Thread t of a row
// holds vectors t, t + 32 warps_per_row, ... of it.
template <typename T>
__global__ void __launch_bounds__(1024)
    rmsnorm_kernel_vec(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ y, int rows, int D,
                       long long x_row_stride, float eps, int warps_per_row) {
  constexpr int N = Vec<T>::N;
  __shared__ float part[32];           // one sum a warp
  const int tpr = warps_per_row * 32;
  const int r_in = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = blockDim.x / tpr;
  const long long row = (long long)blockIdx.x * rows_per_block + r_in;
  const bool active = row < rows;      // whole warps: a warp is in one row
  const int nvec = D / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_row_stride);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  // x and w are loaded together, so a row costs one round trip to memory
  uint4 xv[kMaxVectors], wv[kMaxVectors];
#pragma unroll
  for (int i = 0; i < kMaxVectors; ++i) {
    const int c = t + i * tpr;
    xv[i] = wv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (active && c < nvec) {
      xv[i] = __ldg(xr + c);
      wv[i] = __ldg(wr + c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVectors; ++i) {
    float f[N];
    Vec<T>::unpack(xv[i], f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  if (warps_per_row > 1) {             // block-uniform
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    const int w0 = r_in * warps_per_row;
    ss = 0.f;
    for (int i = 0; i < warps_per_row; ++i) ss += part[w0 + i];
  }
  if (!active) return;
  const float r = rsqrtf(ss / (float)D + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
  for (int i = 0; i < kMaxVectors; ++i) {
    const int c = t + i * tpr;
    if (c < nvec) {
      float f[N], g[N];
      Vec<T>::unpack(xv[i], f);
      Vec<T>::unpack(wv[i], g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = (f[j] * r) * (1.f + g[j]);
      yr[c] = Vec<T>::pack(f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
    rmsnorm_kernel_scalar(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ y, int D, long long x_row_stride,
                          float eps) {
  const T* xr = x + (long long)blockIdx.x * x_row_stride;
  T* yr = y + (long long)blockIdx.x * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += kScalarThreads) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  __shared__ float part[kScalarThreads / 32];
  __shared__ float inv;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kScalarThreads / 32; ++i) t += part[i];
    inv = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float r = inv;
  for (int c = threadIdx.x; c < D; c += kScalarThreads) {
    const float v = to_f32(xr[c]);
    yr[c] = from_f32<T>((v * r) * (1.f + to_f32(w[c])));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int D,
           long long stride, float eps, int warps_per_row,
           int rows_per_block, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (warps_per_row == 0) {          // the scalar rule
    rmsnorm_kernel_scalar<T><<<rows, kScalarThreads, 0, s>>>(xp, wp, yp, D,
                                                             stride, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  const int threads = warps_per_row * 32 * rows_per_block;
  if (D % N || stride % N || misaligned(x) || misaligned(w) ||
      misaligned(y) || rows_per_block < 1 || threads > 1024 ||
      D / N > warps_per_row * 32 * kMaxVectors)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel_vec<T><<<blocks, threads, 0, s>>>(xp, wp, yp, rows, D,
                                                   stride, eps,
                                                   warps_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x: T rows of D elements, row stride x_row_stride (elements), unit column
// stride; w: (D,); y: contiguous (T, D). warps_per_row > 0 launches the
// vector kernel with rows_per_block rows a block (refused unless D and the
// stride are whole 16-byte vectors, x, w and y are 16-byte aligned and the
// row fits the threads' registers); warps_per_row = 0 the scalar kernel.
// Returns a cudaError_t code.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int T,
                           int D, long long x_row_stride, float eps,
                           int warps_per_row, int rows_per_block, int dtype,
                           void* stream) {
  using namespace repro_torch;
  if (T <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, w, y, T, D, x_row_stride, eps, warps_per_row,
                         rows_per_block, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w, y, T, D, x_row_stride, eps,
                                 warps_per_row, rows_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
