// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel), whose model-side twin is repro/models/layers.py:norm_apply.
//
// Bound on the H100: bytes.  Per row it reads d values of x and writes d
// values of y, and does ~4 flops per element, far below the card's 295
// flops-per-byte balance point.  The design therefore only has to move each
// byte once and keep the loads wide:
//   * one warp per row, 8 rows per 256-thread block, so a row's reduction is
//     a warp shuffle with no shared memory and no block barrier;
//   * 16-byte vector loads and stores (8 bf16 or 4 f32 per lane) where the
//     row length allows it (d = 1536 in qwen2-1.5b), scalar otherwise;
//   * the sum of squares and the scaling are in f32, the output is cast back
//     to x's type, as in the reference.
// The second pass over the row reads it again from L1/L2, not from device
// memory: a row is at most a few KB.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a launch the device refuses is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
               int n, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  const bool vec = (d % VEC == 0) && ((uintptr_t)xr % 16 == 0) && ((uintptr_t)yr % 16 == 0);

  float ss = 0.f;
  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float f = to_f32(xr[c]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  if (vec) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(w[c + j]));
      *reinterpret_cast<uint4*>(yr + c) = out;
    }
  } else {
    for (int c = lane; c < d; c += 32) yr[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(w[c]));
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* y, int n, int d, float eps, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), n, d, eps);
}

}  // namespace

// x, y: [n, d] contiguous, float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1);
// w: [d] contiguous, float32 or bfloat16 (w_bf16).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int n, int d, float eps,
                             int x_bf16, int w_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, d, eps, s);
    else launch<__nv_bfloat16, float>(x, w, y, n, d, eps, s);
  } else {
    if (w_bf16) launch<float, __nv_bfloat16>(x, w, y, n, d, eps, s);
    else launch<float, float>(x, w, y, n, d, eps, s);
  }
  return (int)cudaGetLastError();
}
