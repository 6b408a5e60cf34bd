// GQA attention (forward, online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel) together with the GQA fold of repro/kernels/ops.py:flash_attention,
// and serves both model-side twins: repro/models/layers.py:blocked_attention
// (prefill, with q_offset and window) and :decode_attention (one query against
// the KV cache, valid length kv_len).
//
// Layouts are the model's, at rest: q, o [B, Sq, H, D]; k, v [B, Skv, K, D]
// with H = K * g.  Key n is seen by query i (position p = q_offset + i) when
// n < kv_len, n <= p if causal, and p - n < window if window > 0.  Softmax
// state (running max m, sum l, accumulator acc) is f32; a query that sees no
// key gets 0, as in the reference.  The Sq x Skv score matrix never exists:
// a block holds one 64-key tile of scores at a time.
//
// What bounds it on the H100, and what the design does about it:
//   * GQA.  The Pallas wrapper broadcasts K/V across the g query heads of a
//     group in device memory (ops.py:35-39).  Here a block owns one (batch,
//     KV head) and a tile of BR "rows", where a row is a (query position,
//     group member) pair: the g = 6 query heads of qwen2-1.5b that share KV
//     head h / g are rows of one tile.  Each K/V tile is read from device
//     memory once per KV head and reused by all g heads from shared memory.
//   * Decode (Sq = 1) is bound by bytes: the K/V cache rows are read once and
//     there are 4 * g * D flops per 4 * D bytes (bf16) of cache.  It uses
//     BR = 16 rows so the g = 6 real rows waste little arithmetic.
//   * Prefill is bound by operations (4 * D flops per query-key pair).  This
//     first version does them with f32 FMAs from shared memory in 4 x 8 and
//     4 x 16 register tiles (BR = 64), not with tensor cores; mma/wgmma and
//     a TMA pipeline are later work.  Tiles that the causal or window mask
//     hides entirely are skipped, so the work is that of the unmasked pairs.
//   * Shared memory rows are padded (D + 4 floats, 64 + 8 for scores) so the
//     16-byte reads of the register tiles hit distinct banks.
//   * Head dims 32, 64, 128 (qwen2) and 80 (zamba2's shared block, 2560 / 32).
//     A thread owns D / 32 four-column groups of the output; at D = 80 the 20
//     groups do not split evenly over the 8 column threads, so each owns up
//     to 3 and the ones past D are skipped (a compile-time no-op at the other
//     head dims).  The head dimension is not padded in device memory.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a type/head_dim the file does not
// instantiate; the Python wrapper checks those first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int BK = 64;       // keys per tile
constexpr int SP = BK + 8;   // padded score row (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(raw.x));
  memcpy(&raw.y, &hi, sizeof(raw.y));
  *reinterpret_cast<uint2*>(p) = raw;
}

template <int BR, int D>
constexpr size_t smem_bytes() {
  // Qs [BR][D+4], Ks/Vs [BK][D+4], Ss [BR][SP], m/l/corr [BR]
  return sizeof(float) * ((size_t)(BR + 2 * BK) * (D + 4) + (size_t)BR * SP + 3 * BR);
}

// Thread t owns rows rg + 16*ii (ii < BR/16) with rg = t / 8, the score
// columns cg + 8*jj (jj < 8) and the output columns 4*(cg + 8*kk) .. +3
// (kk < ceil(D/32), those below D) with cg = t % 8.
template <typename TQ, typename TKV, int BR, int D>
__global__ void __launch_bounds__(kThreads)
gqa_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, TQ* __restrict__ o,
                     int sq, int h, int kh, int skv, int kv_len, int q_offset,
                     int window, int causal, float sm_scale) {
  static_assert(BR % 16 == 0 && D % 16 == 0, "tile shape");
  constexpr int DP = D + 4;
  constexpr int TR = BR / 16;
  constexpr int D4 = D / 4;
  constexpr int TC = (D4 + 7) / 8;
  constexpr bool kEven = D4 % 8 == 0;   // every thread owns TC column groups

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BR * DP;
  float* Vs = Ks + BK * DP;
  float* Ss = Vs + BK * DP;
  float* m_s = Ss + BR * SP;
  float* l_s = m_s + BR;
  float* c_s = l_s + BR;

  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;
  const int warp = tid / 32, lane = tid % 32;
  const int g = h / kh;
  const int rows = sq * g;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int r0 = blockIdx.x * BR;

  // Q tile: row r is query r_glob / g of head kvh * g + r_glob % g
  for (int idx = tid; idx < BR * D4; idx += kThreads) {
    const int r = idx / D4, c = (idx % D4) * 4;
    const int R = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < rows) {
      const int i = R / g, j = R % g;
      val = load4(q + (((size_t)b * sq + i) * h + (size_t)kvh * g + j) * D + c);
    }
    store4(Qs + r * DP + c, val);
  }
  if (tid < BR) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float4 acc[TR][TC];
#pragma unroll
  for (int ii = 0; ii < TR; ++ii)
#pragma unroll
    for (int kk = 0; kk < TC; ++kk) acc[ii][kk] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the keys any row of this block can see
  const int r_last = min(r0 + BR, rows) - 1;
  const int qpos_lo = q_offset + r0 / g;
  const int qpos_hi = q_offset + r_last / g;
  const int kv_hi = causal ? min(kv_len, qpos_hi + 1) : kv_len;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) / BK * BK : 0;

  for (int n0 = kv_lo; n0 < kv_hi; n0 += BK) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < BK * D4; idx += kThreads) {
      const int n = idx / D4, c = (idx % D4) * 4;
      const int N = n0 + n;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (N < kv_hi) {  // zero past the valid keys: P = 0 must not meet a NaN
        const size_t off = (((size_t)b * skv + N) * kh + kvh) * D + c;
        kv4 = load4(k + off);
        vv4 = load4(v + off);
      }
      store4(Ks + n * DP + c, kv4);
      store4(Vs + n * DP + c, vv4);
    }
    __syncthreads();

    // S = Q K^T on the register tile, then scale and mask into shared memory
    float s[TR][8];
#pragma unroll
    for (int ii = 0; ii < TR; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[TR];
#pragma unroll
      for (int ii = 0; ii < TR; ++ii) qv[ii] = load4(Qs + (rg + 16 * ii) * DP + d0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 kv4 = load4(Ks + (cg + 8 * jj) * DP + d0);
#pragma unroll
        for (int ii = 0; ii < TR; ++ii) {
          float a = s[ii][jj];
          a = fmaf(qv[ii].x, kv4.x, a);
          a = fmaf(qv[ii].y, kv4.y, a);
          a = fmaf(qv[ii].z, kv4.z, a);
          a = fmaf(qv[ii].w, kv4.w, a);
          s[ii][jj] = a;
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < TR; ++ii) {
      const int r = rg + 16 * ii;
      const int R = r0 + r;
      const int qpos = q_offset + R / g;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = cg + 8 * jj;
        const int N = n0 + c;
        const bool ok = R < rows && N < kv_len && (!causal || N <= qpos) &&
                        (window <= 0 || qpos - N < window);
        Ss[r * SP + c] = ok ? s[ii][jj] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row (two scores per lane)
    for (int r = warp; r < BR; r += kThreads / 32) {
      const float a0 = Ss[r * SP + lane], a1 = Ss[r * SP + lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      const float p0 = expf(a0 - m_safe), p1 = expf(a1 - m_safe);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * SP + lane] = p0;
      Ss[r * SP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int ii = 0; ii < TR; ++ii) {
      const float cr = c_s[rg + 16 * ii];
#pragma unroll
      for (int kk = 0; kk < TC; ++kk) {
        acc[ii][kk].x *= cr;
        acc[ii][kk].y *= cr;
        acc[ii][kk].z *= cr;
        acc[ii][kk].w *= cr;
      }
    }
#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      float pv[TR];
#pragma unroll
      for (int ii = 0; ii < TR; ++ii) pv[ii] = Ss[(rg + 16 * ii) * SP + n];
#pragma unroll
      for (int kk = 0; kk < TC; ++kk) {
        if (!kEven && cg + 8 * kk >= D4) continue;
        const float4 vv4 = load4(Vs + n * DP + 4 * (cg + 8 * kk));
#pragma unroll
        for (int ii = 0; ii < TR; ++ii) {
          acc[ii][kk].x = fmaf(pv[ii], vv4.x, acc[ii][kk].x);
          acc[ii][kk].y = fmaf(pv[ii], vv4.y, acc[ii][kk].y);
          acc[ii][kk].z = fmaf(pv[ii], vv4.z, acc[ii][kk].z);
          acc[ii][kk].w = fmaf(pv[ii], vv4.w, acc[ii][kk].w);
        }
      }
    }
  }
  __syncthreads();  // l_s is final (also when no tile was visited)

#pragma unroll
  for (int ii = 0; ii < TR; ++ii) {
    const int r = rg + 16 * ii;
    const int R = r0 + r;
    if (R >= rows) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const int i = R / g, j = R % g;
    TQ* dst = o + (((size_t)b * sq + i) * h + (size_t)kvh * g + j) * D;
#pragma unroll
    for (int kk = 0; kk < TC; ++kk) {
      if (!kEven && cg + 8 * kk >= D4) continue;
      const float4 a = acc[ii][kk];
      store4(dst + 4 * (cg + 8 * kk), make_float4(a.x / l, a.y / l, a.z / l, a.w / l));
    }
  }
}

template <typename TQ, typename TKV, int BR, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int h,
                   int kh, int skv, int kv_len, int q_offset, int window, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BR, D>();
  auto kernel = gqa_attention_kernel<TQ, TKV, BR, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = sq * (h / kh);
  dim3 grid((rows + BR - 1) / BR, kh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(o), sq, h, kh, skv, kv_len, q_offset, window, causal, sm_scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int b, int sq, int h,
                     int kh, int skv, int kv_len, int q_offset, int window, int causal,
                     float sm_scale, cudaStream_t stream) {
  // few rows (decode: Sq = 1, g rows) take the small tile
  if (sq * (h / kh) <= 16)
    return launch<TQ, TKV, 16, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                  causal, sm_scale, stream);
  return launch<TQ, TKV, 64, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                causal, sm_scale, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o, int b, int sq, int h,
                     int kh, int skv, int kv_len, int q_offset, int window, int causal,
                     float sm_scale, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_d<TQ, TKV, 32>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                   causal, sm_scale, stream);
    case 64:
      return launch_d<TQ, TKV, 64>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                   causal, sm_scale, stream);
    case 80:
      return launch_d<TQ, TKV, 80>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                   causal, sm_scale, stream);
    case 128:
      return launch_d<TQ, TKV, 128>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                    causal, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [b, sq, h, d]; k, v: [b, skv, kh, d]; all contiguous.  q/o are
// float32 (q_bf16 = 0) or bfloat16; k/v float32 (kv_bf16 = 0) or bfloat16.
// window <= 0 means no window.
extern "C" int repro_gqa_attention(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int h, int kh, int skv, int d, int kv_len,
                                   int q_offset, int window, int causal, float sm_scale,
                                   int q_bf16, int kv_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    err = launch_t<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset,
                                                 window, causal, sm_scale, d, s);
  else if (!q_bf16 && kv_bf16)
    err = launch_t<float, __nv_bfloat16>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                         causal, sm_scale, d, s);
  else if (!q_bf16 && !kv_bf16)
    err = launch_t<float, float>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                                 sm_scale, d, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
