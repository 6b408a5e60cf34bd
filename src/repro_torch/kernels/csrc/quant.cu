// Blockwise symmetric int quantization for Hopper (sm_90a): the three kernels
// of the compressed gradient sync.
//
// Replaces the Pallas TPU kernels of repro/kernels/quant.py:
//   repro_ef_quantize_bucketize  <- ef_quantize_bucketize (_ef_quant_kernel)
//   repro_quantize_blocks        <- quantize_blocks (_quant_kernel)
//   repro_dequant_add            <- dequant_add (_dequant_add_kernel)
//
// Bound on the H100: bytes.  The EF kernel reads g and e (8 B per element)
// and writes q, deq and the residual (9 B), with ~8 operations per element,
// far below the card's ~20 flops-per-byte balance point for f32 CUDA cores.
// The design therefore only has to move each byte once, with wide accesses:
//   * one CUDA block (256 threads) per quantization block of `block`
//     elements, in a grid-stride loop over the blocks, so the largest bucket
//     (228,096 blocks of 1024) runs on a grid sized to the card;
//   * 16-byte loads and stores, and t = g + e stays in registers between the
//     absmax and the quantization (at most 4 float4 per thread): block must
//     be a multiple of 4 up to 4096 and the inputs 16-byte aligned, which the
//     wrapper (kernels/quant.py) checks or arranges;
//   * absmax by warp shuffle, then one shared-memory step across the 8 warps
//     (double-buffered by iteration, so one barrier per block suffices);
//   * the ragged tail is masked (indices >= n read as 0), not padded: the
//     reference pads both inputs first, an extra copy of each.  The outputs
//     keep the reference's n_pad length.
//
// Bit-exactness with the reference's oracles (repro/kernels/ref.py):
//   * rintf rounds half to even, like jnp.round;
//   * t / scale is an IEEE division (no --use_fast_math);
//   * the EF scale multiplies by 1/qmax rounded to f32 by the caller (the
//     reference's weakly typed constant); quantize_blocks divides by qmax;
//   * deq = __fmul_rn(q, scale) and r = __fsub_rn(t, deq) are never
//     contracted into an FMA, so the residual equals the oracle's exactly.
//
// C interface (loaded with ctypes): each function returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 4;   // float4 chunks per thread kept in registers
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float block_absmax(float m, float (*smem)[kWarps], int parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) smem[parity][warp] = m;
  __syncthreads();
  float r = smem[parity][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, smem[parity][w]);
  return r;
}

__device__ __forceinline__ float quantize_one(float t, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(t, scale)), -qmax), qmax);
}

__device__ __forceinline__ float4 load4(const float* p, long long i, long long n) {
  if (i + 3 < n) return *reinterpret_cast<const float4*>(p + i);
  float4 v;
  v.x = i < n ? p[i] : 0.f;
  v.y = i + 1 < n ? p[i + 1] : 0.f;
  v.z = i + 2 < n ? p[i + 2] : 0.f;
  v.w = i + 3 < n ? p[i + 3] : 0.f;
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t pack_q4(float a, float b, float c, float d) {
  return (uint32_t)(uint8_t)(int8_t)a | ((uint32_t)(uint8_t)(int8_t)b << 8) |
         ((uint32_t)(uint8_t)(int8_t)c << 16) | ((uint32_t)(uint8_t)(int8_t)d << 24);
}

// EF quantize: t = g + e (e is null for quantize_blocks: t = g), one scale per block.
// EF: scale = max(absmax, tiny) * inv_qmax; otherwise max(absmax, tiny) / qmax.
// deq and r are written only under EF.
template <bool EF>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ g, const float* __restrict__ e,
             int8_t* __restrict__ q, float* __restrict__ scales,
             float* __restrict__ deq, float* __restrict__ r,
             long long n, int block, long long nblocks, float qmax, float inv_qmax,
             float tiny) {
  __shared__ float smem[2][kWarps];
  int parity = 0;
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x, parity ^= 1) {
    const long long base = b * block;
    float4 t[kMaxVec] = {};
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVec; ++k) {
      const int c = (k * kThreads + threadIdx.x) * 4;
      if (c < block) {
        float4 v = load4(g, base + c, n);
        if (EF) v = add4(v, load4(e, base + c, n));
        t[k] = v;
        m = absmax4(m, v);
      }
    }
    const float amax = fmaxf(block_absmax(m, smem, parity), tiny);
    const float scale = EF ? __fmul_rn(amax, inv_qmax) : __fdiv_rn(amax, qmax);
    if (threadIdx.x == 0) scales[b] = scale;
#pragma unroll
    for (int k = 0; k < kMaxVec; ++k) {
      const int c = (k * kThreads + threadIdx.x) * 4;
      if (c < block) {
        const float4 v = t[k];
        const float4 qv = make_float4(quantize_one(v.x, scale, qmax), quantize_one(v.y, scale, qmax),
                                      quantize_one(v.z, scale, qmax), quantize_one(v.w, scale, qmax));
        *reinterpret_cast<uint32_t*>(q + base + c) = pack_q4(qv.x, qv.y, qv.z, qv.w);
        if (EF) {
          const float4 d = make_float4(__fmul_rn(qv.x, scale), __fmul_rn(qv.y, scale),
                                       __fmul_rn(qv.z, scale), __fmul_rn(qv.w, scale));
          *reinterpret_cast<float4*>(deq + base + c) = d;
          *reinterpret_cast<float4*>(r + base + c) =
              make_float4(__fsub_rn(v.x, d.x), __fsub_rn(v.y, d.y), __fsub_rn(v.z, d.z),
                          __fsub_rn(v.w, d.w));
        }
      }
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out = acc + q * scales[i / block], in acc's type; elementwise, grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_add_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                   const T* __restrict__ acc, T* __restrict__ out, long long n, int block) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float d = __fmul_rn((float)q[i], scales[i / block]);
    out[i] = from_f32<T>(__fadd_rn(to_f32(acc[i]), d));
  }
}

int grid_for(long long work, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cap = (long long)sms * kBlocksPerSM;
  return (int)(work < cap ? (work > 0 ? work : 1) : cap);
}

// The wrapper guarantees these; a caller that does not gets cudaErrorInvalidValue.
bool vec_ok(int block, const void* a, const void* b) {
  return block > 0 && block % 4 == 0 && block <= kMaxVec * kThreads * 4 &&
         (uintptr_t)a % 16 == 0 && (b == nullptr || (uintptr_t)b % 16 == 0);
}

template <bool EF>
int launch_quant(const float* g, const float* e, int8_t* q, float* scales, float* deq, float* r,
                 long long n, int block, float qmax, float inv_qmax, float tiny, int device,
                 void* stream) {
  // outputs come from torch.empty and are 256-byte aligned
  if (!vec_ok(block, g, e)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long nblocks = (n + block - 1) / block;
  const int grid = grid_for(nblocks, device);
  quant_kernel<EF><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, e, q, scales, deq, r, n, block, nblocks, qmax, inv_qmax, tiny);
  return (int)cudaGetLastError();
}

}  // namespace

// grad, residual: [n] f32; q: [n_pad] int8; scales: [n_pad / block] f32;
// deq, new_residual: [n_pad] f32, with n_pad = ceil(n / block) * block.
extern "C" int repro_ef_quantize_bucketize(const void* grad, const void* residual, void* q,
                                           void* scales, void* deq, void* new_residual,
                                           long long n, int block, float qmax, float inv_qmax,
                                           float tiny, int device, void* stream) {
  return launch_quant<true>(static_cast<const float*>(grad), static_cast<const float*>(residual),
                            static_cast<int8_t*>(q), static_cast<float*>(scales),
                            static_cast<float*>(deq), static_cast<float*>(new_residual), n, block,
                            qmax, inv_qmax, tiny, device, stream);
}

// x: [n] f32; q: [n_pad] int8; scales: [n_pad / block] f32.
extern "C" int repro_quantize_blocks(const void* x, void* q, void* scales, long long n, int block,
                                     float qmax, float tiny, int device, void* stream) {
  return launch_quant<false>(static_cast<const float*>(x), nullptr, static_cast<int8_t*>(q),
                             static_cast<float*>(scales), nullptr, nullptr, n, block, qmax, 0.f,
                             tiny, device, stream);
}

// q: [n] int8; scales: [n / block] f32; acc, out: [n] f32 (acc_bf16 = 0) or bf16 (1).
extern "C" int repro_dequant_add(const void* q, const void* scales, const void* acc, void* out,
                                 long long n, int block, int acc_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = grid_for((n + kThreads - 1) / kThreads, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_bf16)
    dequant_add_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<const __nv_bfloat16*>(acc), static_cast<__nv_bfloat16*>(out), n, block);
  else
    dequant_add_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<const float*>(acc), static_cast<float*>(out), n, block);
  return (int)cudaGetLastError();
}
