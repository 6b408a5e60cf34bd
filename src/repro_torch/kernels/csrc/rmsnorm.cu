// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel), whose model-side twin is repro/models/layers.py:norm_apply.
//
// Bound on the H100: bytes.  Per row it reads d values of x and writes d
// values of y, and does ~4 flops per element, far below the card's 295
// flops-per-byte balance point.  At the model's shapes the bytes are few
// (a decode row [4, 1536] is 12 KB, a prefill [1024, 1536] 6 MB), so what
// decides the time is the chain of dependent memory round trips inside a
// launch, not the rate.  The design cuts that chain to one round trip:
//   * The row is held in registers.  A row is cut into 16-byte vectors (8
//     bf16 or 4 f32 values); thread t of the row's TPR threads owns vectors
//     t, t + TPR, ..., at most VPT of them, and issues every load of x and
//     w (f32 w as two float4 per 8 values) before it uses any.  It then
//     reduces, and scales from the same registers: x is read once, with no
//     second pass over the row.  VPT is a template parameter (1..6), so the
//     vectors stay in registers for every width: 1536, 2560 and 5120 (the
//     models' d_model and zamba2's d_inner) and the smoke configs' 128 and
//     256 alike.
//   * Few rows get more threads.  With n <= kWideRows rows (decode: n = 4)
//     a row takes one block of up to 512 threads (TPR = 192 at d = 1536 in
//     bf16, 320 at 2560 and at 5120 with VPT = 2), so each thread holds one
//     or two vectors, and the row's sum takes two barriers (below).  Above
//     kWideRows (prefill, training) a row takes one warp while it fits in
//     VPT <= 6 vectors a lane (d = 1536 bf16: 6), else the fewest warps
//     that do (2560: two warps of 5, 5120: four of 5), with 128-thread
//     blocks.  (With 7 or 8 vectors of bf16 x and f32 w a thread spills at
//     its 128 registers.)
//     kWideRows is set from card readings (chip_smoke.py [kernel] rmsnorm
//     layouts, NVIDIA H100 80GB HBM3 at 700 W): see PERF.md.
//   * The arithmetic is the first version's, to the bit: the sum of squares
//     in f32, each lane of a warp walking vectors l, l + 32, l + 64, ... in
//     one running sum, then a butterfly over the lanes; y = x * r * w in
//     f32, cast back to x's type, as in the reference.  A row of one warp
//     holds its vectors in that order already.  A row of several warps
//     stages x in shared memory (at most 48 KB) and its first warp walks it
//     there: a chain of adds in shared memory, not of device-memory round
//     trips.  So the redesign changes the time and no output (a first
//     redesign that summed per thread and then across warps moved the
//     zamba2 logits check by bf16 rounding alone: PERF.md).  Two calls give
//     the same bits.
// A width that is not a multiple of the vector or over 3,072 vectors
// (24,576 bf16 values), or a view whose rows or w are not 16-byte aligned,
// takes the first version's kernel, unchanged (the generic kernel below).
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, so a launch the device refuses is reported to the caller, or
// cudaErrorInvalidValue for a layout the file does not take.

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

constexpr int kMaxVpt = 6;        // vectors a thread holds (more spill at 128 registers)
constexpr int kWideRows = 132;    // rows up to this take a block each
constexpr int kWideThreads = 512; // the most threads a wide row takes
constexpr int kBlock = 128;       // threads of a block of narrow rows

// the 16-byte vector's worth of w beside x's: VEC values of type W
template <typename W, int VEC>
struct WVec {
  static constexpr int kWords = (VEC * sizeof(W) + 15) / 16;  // 16-byte loads
  static constexpr int kBytes = VEC * sizeof(W);
  uint4 raw[kWords];
  __device__ __forceinline__ void load(const W* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) raw[k] = reinterpret_cast<const uint4*>(p)[k];
    } else {  // 4 bf16 values beside 4 f32 of x: 8 bytes
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      raw[0] = make_uint4(v.x, v.y, 0u, 0u);
    }
  }
  __device__ __forceinline__ float get(int j) const {
    return to_f32(reinterpret_cast<const W*>(raw)[j]);
  }
};

// Rows of TPR threads (a multiple of 32), blockDim.x / TPR rows per block.
template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                   int n, int d, float eps, int tpr) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint4 stage[];   // [rows of the block][nvec] when tpr > 32
  const int nvec = d / VEC;
  const int rows_per_block = blockDim.x / tpr;
  const int t = threadIdx.x % tpr;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / tpr;
  const bool live = row < n;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;

  // every load of this thread's share of the row first
  uint4 xv[VPT];
  WVec<W, VEC> wv[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * tpr;
    if (live && v < nvec) {
      xv[k] = reinterpret_cast<const uint4*>(xr)[v];
      wv[k].load(w + v * VEC);
    }
  }
  // The sum of squares in the first kernel's order: lane l of a warp walks
  // vectors l, l + 32, l + 64, ... of the row in one running sum, then the
  // lanes meet in a butterfly.  A row of one warp holds its vectors in that
  // order already; a row of several warps stages x in shared memory, and the
  // row's first warp walks it there.
  float ss = 0.f;
  const int lane = threadIdx.x % 32;
  uint4* srow = stage + (threadIdx.x / tpr) * nvec;
  if (tpr == 32) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (live && t + k * tpr < nvec) {
        const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f32(e[j]);
          ss += f * f;
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (live && t + k * tpr < nvec) srow[t + k * tpr] = xv[k];
    __syncthreads();
    if (live && t < 32) {
      for (int v = lane; v < nvec; v += 32) {
        const uint4 raw = srow[v];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f32(e[j]);
          ss += f * f;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  float r = rsqrtf(ss / (float)d + eps);
  if (tpr > 32) {  // the first warp's r to the row's other warps, in its staged x
    if (t == 0) *reinterpret_cast<float*>(srow) = r;
    __syncthreads();
    r = *reinterpret_cast<const float*>(srow);
  }

#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * tpr;
    if (live && v < nvec) {
      const T* e = reinterpret_cast<const T*>(&xv[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(to_f32(e[j]) * r * wv[k].get(j));
      reinterpret_cast<uint4*>(yr)[v] = out;
    }
  }
}

// Any width and alignment: the first version's kernel, unchanged.  A warp
// per row, 8 rows per block; 16-byte loads of x where the row allows them,
// scalar otherwise; the row read twice (from L1 the second time).
template <typename T, typename W>
__global__ void __launch_bounds__(256)
rmsnorm_generic_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                       int n, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
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

template <typename T, typename W, int VPT>
void launch_vec(const void* x, const void* w, void* y, int n, int d, float eps, int tpr,
                cudaStream_t stream) {
  const int threads = tpr >= kBlock ? tpr : kBlock / tpr * tpr;
  const int rows = threads / tpr;
  // x staged for the sum when a row spans warps: at most 48 KB (3,072
  // vectors), the most a launch takes without opting in; no static smem
  const size_t smem = tpr > 32 ? (size_t)rows * (d * sizeof(T) / 16) * 16 : 0;
  rmsnorm_vec_kernel<T, W, VPT><<<(n + rows - 1) / rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), n, d, eps, tpr);
}

// layout: 0 the rule above, 1 a block per row (wide), 2 warps per row (narrow)
template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int n, int d, float eps, int layout,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // a row of up to kWideThreads * kMaxVpt aligned vectors stays in registers
  const bool vec = d % VEC == 0 && d / VEC <= kWideThreads * kMaxVpt &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                   (uintptr_t)w % (VEC * sizeof(W) >= 16 ? 16 : 8) == 0;
  if (!vec) {
    rmsnorm_generic_kernel<T, W><<<(n + 7) / 8, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), n, d, eps);
    return cudaGetLastError();
  }
  const int nvec = d / VEC;
  if (layout == 0) layout = n <= kWideRows ? 1 : 2;
  int vpt, tpr;
  if (layout == 1) {
    vpt = (nvec + kWideThreads - 1) / kWideThreads;
    tpr = ((nvec + vpt - 1) / vpt + 31) / 32 * 32;
  } else if (layout == 2) {
    tpr = 32 * ((nvec + 32 * kMaxVpt - 1) / (32 * kMaxVpt));
    vpt = (nvec + tpr - 1) / tpr;
  } else {
    return cudaErrorInvalidValue;
  }
  switch (vpt) {   // vpt <= kMaxVpt and tpr <= kWideThreads for such a row
    case 1: launch_vec<T, W, 1>(x, w, y, n, d, eps, tpr, stream); break;
    case 2: launch_vec<T, W, 2>(x, w, y, n, d, eps, tpr, stream); break;
    case 3: launch_vec<T, W, 3>(x, w, y, n, d, eps, tpr, stream); break;
    case 4: launch_vec<T, W, 4>(x, w, y, n, d, eps, tpr, stream); break;
    case 5: launch_vec<T, W, 5>(x, w, y, n, d, eps, tpr, stream); break;
    default: launch_vec<T, W, 6>(x, w, y, n, d, eps, tpr, stream); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, d] contiguous, float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1);
// w: [d] contiguous, float32 or bfloat16 (w_bf16).  layout 0 picks the
// rows' layout by n; 1 and 2 force a block per row or warps per row (for
// the readings that set kWideRows).
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int n, int d, float eps,
                             int x_bf16, int w_bf16, int layout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16) err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, d, eps, layout, s);
    else err = launch<__nv_bfloat16, float>(x, w, y, n, d, eps, layout, s);
  } else {
    if (w_bf16) err = launch<float, __nv_bfloat16>(x, w, y, n, d, eps, layout, s);
    else err = launch<float, float>(x, w, y, n, d, eps, layout, s);
  }
  return (int)err;
}
