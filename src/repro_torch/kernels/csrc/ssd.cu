// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py:ssd_scan
// (_ssd_kernel) together with its head fold in repro/kernels/ops.py:ssd_scan,
// and serves the model-side twin repro/models/ssm.py:ssd_chunked, whose
// final state the Pallas kernel does not return.
//
// Per (batch b, head h) the chunks of Q steps are walked in order with the
// state h [N, P] carried in f32.  For one chunk, with cum = cumsum(dt * a)
// and seg = cum[Q-1]:
//   G  = (C B^T) o L o dt_j,   L[i][j] = exp(cum_i - cum_j) for i >= j, else 0
//   y  = G x + (C o exp(cum)) h
//   h <- exp(seg) h + B^T (x o exp(seg - cum) o dt)
// Outputs: y [B, S, H, P] f32 and the final state [B, H, N, P] f32.
//
// Layouts are the model's, at rest: x [B, S, H, P], dt [B, S, H] (f32),
// a [H] (f32), bm / cm [B, S, N] shared by every head.  x, bm and cm are f32
// or bf16 (upcast in registers) and may be strided views with a unit last
// stride, as the Mamba block's slices of its convolution output are; no
// fold, transpose or copy precedes the launch.
//
// What bounds it on the H100, and what the design does about it:
//   * Operations.  Per chunk 2 (Q^2 N + Q^2 P + 2 Q N P) flops against
//     Q (2N + P) input values (half of the two Q^2 terms is the causal
//     triangle's zeros): at Q = 128, N = P = 64 that is ~6.3 MFLOP per
//     ~100 KB (bf16), far above the card's balance point.  This first
//     version does them with f32 FMAs from shared memory in register tiles
//     (8 x 8 of G, 8 x 4 of y, 4 x 4 of h per thread, float4 reads along the
//     reduced dimension), on the 16 x 16 bands of G at or below the diagonal
//     only; mma/wgmma are later work.
//   * The TPU's sequential grid axis over chunks becomes a loop inside one
//     CUDA block per (b, h), so the state never leaves the SM: it lives in
//     registers (the update) and in shared memory (the read by y).  B and C
//     are read per batch row from the model's tensor, not broadcast to every
//     head in device memory (x80 at full width, ops.py:60-61).  A thread
//     issues all of its loads of a chunk before it stores any to shared
//     memory, so the chunk's device-memory latency is paid about once.
//   * dt is folded into G's columns and into the state update's weights
//     (as repro/models/ssm.py:ssd_chunked does), not into a copy of x.
//   * Ragged chunks.  The wrapper passes Q = min(chunk, S) as the reference
//     pads to; rows past S in the last chunk are loaded as zeros (dt = 0
//     decays nothing and B = 0 adds no state), the same values the
//     reference's zero padding gives, without copying padded inputs.  The
//     kernel is instantiated for 1, 2, 4 or 8 bands of 16 rows, so a short
//     chunk (a short prompt, the smoke config's 16) computes no zero bands.
//   * Shared memory holds B, C, x tiles [128][68], h [64][68] and
//     G [128][144] in f32 (194 KB, one block per SM); rows are padded so the
//     16-byte register-tile reads and the G writes hit distinct banks.  N and
//     P below 64 run with zero columns.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the file does not take; the
// Python wrapper checks those first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int QM = 128;       // largest chunk
constexpr int NM = 64;        // largest state dim
constexpr int PM = 64;        // largest head dim
constexpr int RS = 64 + 4;    // padded row of the B, C, x and h tiles (floats)
constexpr int GS = QM + 16;   // padded row of G: the two rows a warp writes sit 16 banks apart

constexpr size_t kSmemFloats = 3 * QM * RS + NM * RS + QM * GS + 4 * QM + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float s, float4 v, float4 acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
  return acc;
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Thread t = 16 * ty + tx owns G rows ty + 16 ii and columns tx + 16 jj
// (jj <= ii < NB), y rows ty + 16 ii and columns 4 tx .. 4 tx + 3, and h rows
// ty + 16 nn (nn < 4) and the same four columns.  NB = the chunk's 16-row
// bands (1, 2, 4 or 8): a band pair above the diagonal of G is all zeros and
// is neither computed nor read.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ hlast, int S, int H, int P, int N, int Q,
                long long xsb, long long xss, long long xsh, long long dsb, long long dss,
                long long dsh, long long bsb, long long bss, long long csb, long long css) {
  constexpr int QT = 16 * NB;                    // rows of the chunk tiles
  constexpr int LOADS = QT * NM / kThreads;      // B (and C, x) values per thread
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [QM][RS]  B of the chunk
  float* Cs = Bs + QM * RS;                      // [QM][RS]  C
  float* Xs = Cs + QM * RS;                      // [QM][RS]  x
  float* Hs = Xs + QM * RS;                      // [NM][RS]  state entering the chunk
  float* Gs = Hs + NM * RS;                      // [QM][GS]  (C B^T) o L o dt_j
  float* dts = Gs + QM * GS;                     // [QM]
  float* cum = dts + QM;                         // [QM]  cumsum(dt * a)
  float* ecum = cum + QM;                        // [QM]  exp(cum)
  float* wdec = ecum + QM;                       // [QM]  exp(seg - cum) * dt
  float* wsum = wdec + QM;                       // [4]   scan carries between warps

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const float av = a[hh];
  const T* xb = x + b * xsb + hh * xsh;
  const float* dtb = dt + b * dsb + hh * dsh;
  const T* bb = bm + b * bsb;
  const T* cb = cm + b * csb;
  const int p0 = 4 * tx;
  const int lc = tid % NM, lr = tid / NM;        // load column, first load row

  float4 hreg[4];
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) hreg[nn] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < NM * RS; idx += kThreads) Hs[idx] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    const int qv = min(Q, S - t0);     // valid rows; the rest are zeros
    const int qv4 = (qv + 3) & ~3;

    // ---- load the chunk: rows past qv and columns past N / P as zeros.  All
    // of a thread's loads are issued before any is stored, so they overlap.
    if (tid < QM) dts[tid] = tid < qv ? dtb[(t0 + tid) * dss] : 0.f;
    {
      float bv[LOADS], cv[LOADS], xv[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int r = lr + (kThreads / NM) * k;
        const bool row = r < qv;
        bv[k] = row && lc < N ? to_f32(bb[(t0 + r) * bss + lc]) : 0.f;
        cv[k] = row && lc < N ? to_f32(cb[(t0 + r) * css + lc]) : 0.f;
        xv[k] = row && lc < P ? to_f32(xb[(t0 + r) * xss + lc]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int r = lr + (kThreads / NM) * k;
        Bs[r * RS + lc] = bv[k];
        Cs[r * RS + lc] = cv[k];
        Xs[r * RS + lc] = xv[k];
      }
    }
    __syncthreads();

    // ---- cum = inclusive cumsum of dt * a: a warp scan, then the carries
    float v = 0.f;
    if (tid < QM) {
      v = dts[tid] * av;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) wsum[warp] = v;
    }
    __syncthreads();
    if (tid < QM) {
      for (int w = 0; w < warp; ++w) v += wsum[w];
      cum[tid] = v;
    }
    __syncthreads();
    const float seg = cum[QM - 1];       // = the last valid row's: dt is 0 past it
    if (tid < QM) {
      ecum[tid] = expf(cum[tid]);
      wdec[tid] = expf(seg - cum[tid]) * dts[tid];
    }

    // ---- G = (C B^T) o L o dt_j on the bands at or below the diagonal
    {
      float acc[NB][NB];
#pragma unroll
      for (int ii = 0; ii < NB; ++ii)
#pragma unroll
        for (int jj = 0; jj <= ii; ++jj) acc[ii][jj] = 0.f;
      for (int n0 = 0; n0 < N; n0 += 4) {
        float4 cv[NB];
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) cv[ii] = ld4(Cs + (ty + 16 * ii) * RS + n0);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          const float4 bv = ld4(Bs + (tx + 16 * jj) * RS + n0);
#pragma unroll
          for (int ii = jj; ii < NB; ++ii) acc[ii][jj] = dot4(cv[ii], bv, acc[ii][jj]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) {
        const int i = ty + 16 * ii;
        const float ci = cum[i];
#pragma unroll
        for (int jj = 0; jj <= ii; ++jj) {
          const int j = tx + 16 * jj;
          // exp is taken only where i >= j: cum_i - cum_j <= 0 there
          Gs[i * GS + j] = i >= j ? acc[ii][jj] * expf(ci - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = (C h) o exp(cum) + G x
    {
      float4 acc[NB];
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) acc[ii] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n0 = 0; n0 < N; n0 += 4) {
        float4 cv[NB];
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) cv[ii] = ld4(Cs + (ty + 16 * ii) * RS + n0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 hv = ld4(Hs + (n0 + k) * RS + p0);
#pragma unroll
          for (int ii = 0; ii < NB; ++ii) acc[ii] = axpy4(comp(cv[ii], k), hv, acc[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) {
        const float e = ecum[ty + 16 * ii];
        acc[ii] = make_float4(acc[ii].x * e, acc[ii].y * e, acc[ii].z * e, acc[ii].w * e);
      }
      // band jb of columns feeds the row bands ii >= jb
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int jend = min(16 * jb + 16, qv4);
        for (int j0 = 16 * jb; j0 < jend; j0 += 4) {
          float4 gv[NB];
#pragma unroll
          for (int ii = jb; ii < NB; ++ii) gv[ii] = ld4(Gs + (ty + 16 * ii) * GS + j0);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = ld4(Xs + (j0 + k) * RS + p0);
#pragma unroll
            for (int ii = jb; ii < NB; ++ii) acc[ii] = axpy4(comp(gv[ii], k), xv, acc[ii]);
          }
        }
      }
      if (p0 < P) {
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) {
          const int i = ty + 16 * ii;
          if (i < qv)
            *reinterpret_cast<float4*>(y + (((size_t)b * S + t0 + i) * H + hh) * P + p0) =
                acc[ii];
        }
      }
    }

    // ---- h <- exp(seg) h + B^T (x o exp(seg - cum) o dt), in registers
    {
      const float eseg = expf(seg);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        hreg[nn] = make_float4(hreg[nn].x * eseg, hreg[nn].y * eseg, hreg[nn].z * eseg,
                               hreg[nn].w * eseg);
      for (int j = 0; j < qv4; ++j) {
        const float4 xv = ld4(Xs + j * RS + p0);
        const float w = wdec[j];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) hreg[nn] = axpy4(Bs[j * RS + ty + 16 * nn] * w, xv, hreg[nn]);
      }
    }
    __syncthreads();   // every read of Hs, B, C and x of this chunk is done
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
      *reinterpret_cast<float4*>(Hs + (ty + 16 * nn) * RS + p0) = hreg[nn];
  }

  if (p0 < P) {
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int n = ty + 16 * nn;
      if (n < N)
        *reinterpret_cast<float4*>(hlast + (((size_t)b * H + hh) * N + n) * P + p0) = hreg[nn];
    }
  }
}

template <typename T, int NB>
cudaError_t launch_nb(const void* x, const void* dt, const void* a, const void* bm,
                      const void* cm, void* y, void* hlast, int batch, int S, int H, int P,
                      int N, int Q, const long long* st, cudaStream_t stream) {
  constexpr size_t smem = kSmemFloats * sizeof(float);
  auto kernel = ssd_scan_kernel<T, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(hlast), S, H, P, N, Q, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

// the chunk's 16-row bands, rounded up to 1, 2, 4 or 8
template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                   void* y, void* hlast, int batch, int S, int H, int P, int N, int Q,
                   const long long* st, cudaStream_t stream) {
  if (Q <= 16)
    return launch_nb<T, 1>(x, dt, a, bm, cm, y, hlast, batch, S, H, P, N, Q, st, stream);
  if (Q <= 32)
    return launch_nb<T, 2>(x, dt, a, bm, cm, y, hlast, batch, S, H, P, N, Q, st, stream);
  if (Q <= 64)
    return launch_nb<T, 4>(x, dt, a, bm, cm, y, hlast, batch, S, H, P, N, Q, st, stream);
  return launch_nb<T, 8>(x, dt, a, bm, cm, y, hlast, batch, S, H, P, N, Q, st, stream);
}

}  // namespace

// x [batch, s, h, p] with strides (xsb, xss, xsh, 1); dt [batch, s, h] f32
// with strides (dsb, dss, dsh); a [h] f32 contiguous; bm, cm [batch, s, n]
// with strides (bsb, bss, 1), (csb, css, 1); x, bm, cm float32 (in_bf16 = 0)
// or bfloat16.  y [batch, s, h, p] and hlast [batch, h, n, p]: contiguous
// f32.  p, n in {16, 32, 64}; the chunk q in [1, 128].
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* hlast, int batch, int s, int h,
                              int p, int n, int q, long long xsb, long long xss, long long xsh,
                              long long dsb, long long dss, long long dsh, long long bsb,
                              long long bss, long long csb, long long css, int in_bf16,
                              int device, void* stream) {
  const bool dims_ok = (p == 16 || p == 32 || p == 64) && (n == 16 || n == 32 || n == 64);
  if (!dims_ok || q < 1 || q > QM || batch < 1 || s < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long st[10] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    err = launch<__nv_bfloat16>(x, dt, a, bm, cm, y, hlast, batch, s, h, p, n, q, st, stream_);
  else
    err = launch<float>(x, dt, a, bm, cm, y, hlast, batch, s, h, p, n, q, st, stream_);
  return (int)err;
}
