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
// a [H] (f32), bm / cm [B, S, N] shared by every head.  x, bm and cm are
// all f32 or all bf16 and may be strided views with a unit last stride, as
// the Mamba block's slices of its convolution output are; no fold or
// transpose precedes the launch.
//
// Two kernels, chosen by the inputs' type:
//
// 1. bf16 x, B and C (the serving path): tensor cores.
//    What bounds it: bytes.  The function's least time is its traffic,
//    mostly the f32 y (at the serving prefill [4, 256, 80, 64], N = 64:
//    37 MB, 11 us at 3.35 TB/s); its products, run on the tensor cores as
//    below, need under half of that time at the bf16 peak.  The f32 kernel
//    below runs them as f32 FMAs, at 4.5x its own f32-peak bound.
//    * The chunked form is exact for any chunk length: the caller's chunk
//      (<= 128) changes only where the plain version rounds.  The kernel
//      walks the sequence in tiles of 64 steps whatever chunk it is given:
//      against 128-step chunks that halves the quadratic work, and a tile's
//      B, C and x (bf16, 27 KB) can be double-buffered.
//    * Every product is mma.sync.m16n8k16, bf16 in, f32 accumulators, and
//      stays within 1e-4 of the plain version (a single bf16 pass over the
//      f32 factors reads ~2e-2 in the CPU model) with at most two
//      passes: x, B and C are bf16 at rest, so only the f32 factor of each
//      product is split into hi = bf16(v) and lo = bf16(v - hi):
//        C B^T        one pass, the products exact;
//        G x          G split (G = (C B^T) o L o dt_j, L the decay mask);
//        C h          the carried state h split;
//        (B o w)^T x  B o w split, w_j = exp(seg - cum_j) dt_j.
//      tests/test_torch_kernels.py models this arithmetic on the CPU.
//    * G stays in registers: each warp owns 16 rows of the tile and takes
//      the 16-column blocks of C B^T at or below its diagonal one at a
//      time; the accumulators are scaled by exp(cum_i - cum_j) dt_j (zero
//      above the diagonal), split, and handed to the G x product as its A
//      fragments, as the attention kernel (attention.cu) hands P from S to
//      P V.  No Q x Q tile exists in shared memory.
//    * The state [N, P] lives in the accumulators of the (B o w)^T x
//      product, warp w owning state rows 16w .. 16w + 15; at the end of a
//      tile it is written to shared memory as its hi and lo bf16 parts for
//      the next tile's C h.  The cumulative decay is a scan that every warp
//      runs in its own registers (lane l holds steps l and l + 32), read by
//      shuffles, so it costs no barrier.
//    * Filling the card: one block of 4 warps per (batch, head), 72.5 KB of
//      shared memory (two stages of B, C, x tiles [64][72] bf16, the state's
//      hi and lo [64][72]), at most 168 registers a thread (ptxas spills 4
//      bytes): three blocks an SM, so the 320 blocks of the serving prefill
//      run in one wave of 396.
//      Consecutive blocks share a batch row, so its B and C tiles come from
//      L2.  C B^T is computed per head (about a seventh of a tile's mma).
//    * Overlapping the loads: tile c + 1 arrives by cp.async (16 bytes a
//      thread; zero-filled past S and past N or P) while tile c computes.
//    Views of the conv output are read in place when their rows are 16-byte
//    aligned, as the Mamba block's are; the wrapper copies a view that is
//    not.  N and P below 64 run as zero columns.
//
// 2. f32 x, B and C (the f32 checks, the smoke configs): the first version's
//    kernel, unchanged: f32 FMAs from shared memory.
//    * Operations.  Per chunk 2 (Q^2 N + Q^2 P + 2 Q N P) flops against
//      Q (2N + P) input values (half of the two Q^2 terms is the causal
//      triangle's zeros), on the 16 x 16 bands of G at or below the
//      diagonal only, in register tiles (8 x 8 of G, 8 x 4 of y, 4 x 4 of h
//      per thread, float4 reads along the reduced dimension).
//    * The TPU's sequential grid axis over chunks becomes a loop inside one
//      CUDA block per (b, h), so the state never leaves the SM: it lives in
//      registers (the update) and in shared memory (the read by y).  B and C
//      are read per batch row from the model's tensor, not broadcast to every
//      head in device memory (x80 at full width, ops.py:60-61).  A thread
//      issues all of its loads of a chunk before it stores any to shared
//      memory, so the chunk's device-memory latency is paid about once.
//    * dt is folded into G's columns and into the state update's weights
//      (as repro/models/ssm.py:ssd_chunked does), not into a copy of x.
//    * Ragged chunks.  The wrapper passes Q = min(chunk, S) as the reference
//      pads to; rows past S in the last chunk are loaded as zeros (dt = 0
//      decays nothing and B = 0 adds no state), the same values the
//      reference's zero padding gives, without copying padded inputs.  The
//      kernel is instantiated for 1, 2, 4 or 8 bands of 16 rows, so a short
//      chunk (a short prompt, the smoke config's 16) computes no zero bands.
//    * Shared memory holds B, C, x tiles [128][68], h [64][68] and
//      G [128][144] in f32 (194 KB, one block per SM); rows are padded so the
//      16-byte register-tile reads and the G writes hit distinct banks.  N and
//      P below 64 run with zero columns.
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
constexpr int RS = 64 + 4;    // padded row of the B, C, x and h tiles (floats)
constexpr int GS = QM + 16;   // padded row of G: the two rows a warp writes sit 16 banks apart

constexpr size_t kSmemFloats = 3 * QM * RS + NM * RS + QM * GS + 4 * QM + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }

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

// ------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // 4 warps, 16 rows of a tile each
constexpr int kT = 64;            // steps per tile
constexpr int RT = 64 + 8;        // padded row of the bf16 tiles: ldmatrix rows 16 bytes apart in banks
constexpr size_t kTcSmemBytes =
    sizeof(bf16) * (2 * 3 * kT * RT + 2 * NM * RT) + sizeof(float) * 2 * kT;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// an f32 pair (u, v) as the bf16 pairs hi and lo, hi + lo = (u, v) within 2^-16
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi, uint32_t& lo) {
  const bf16 uh = __float2bfloat16_rn(u), vh = __float2bfloat16_rn(v);
  hi = pack_bf16(uh, vh);
  lo = pack_bf16(__float2bfloat16_rn(u - __bfloat162float(uh)),
                 __float2bfloat16_rn(v - __bfloat162float(vh)));
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16((unsigned short)(u & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16((unsigned short)(u >> 16))));
}

// The mma fragments (lane = 4 g + t): an A fragment (16 x 16) holds rows g
// and g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9; a B fragment (16 x 8)
// rows 2t, 2t + 1 and 2t + 8, 2t + 9 at column g; an accumulator rows g and
// g + 8 at columns 2t, 2t + 1.  Warp w owns rows 16w .. 16w + 15 of the tile
// (for y) and of the state (for h).
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, float* __restrict__ y,
                   float* __restrict__ hlast, int S, int H, int P, int N, long long xsb,
                   long long xss, long long xsh, long long dsb, long long dss, long long dsh,
                   long long bsb, long long bss, long long csb, long long css) {
  extern __shared__ uint4 smem_tc[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_tc);   // [2 stages][B, C, x][kT][RT]
  bf16* Hhi = tiles + 2 * 3 * kT * RT;              // [NM][RT]  the state entering the tile
  bf16* Hlo = Hhi + NM * RT;                        // [NM][RT]
  float* dts = reinterpret_cast<float*>(Hlo + NM * RT);   // [2 stages][kT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const float av = a[hh];
  const bf16* xb = x + b * xsb + hh * xsh;
  const float* dtb = dt + b * dsb + hh * dsh;
  const bf16* bb = bm + b * bsb;
  const bf16* cb = cm + b * csb;
  const int ntiles = (S + kT - 1) / kT;
  const unsigned full = 0xffffffffu;

  auto load = [&](int c, int st) {
    const int t0 = c * kT, qv = min(kT, S - t0);
    bf16* Bt = tiles + (st * 3) * kT * RT;
    bf16* Ct = Bt + kT * RT;
    bf16* Xt = Ct + kT * RT;
    for (int idx = tid; idx < kT * 8; idx += kTcThreads) {
      const int r = idx / 8, c8 = (idx % 8) * 8;
      const long long tr = t0 + r;
      const bool okn = r < qv && c8 < N, okp = r < qv && c8 < P;
      cp_async16(Bt + r * RT + c8, okn ? bb + tr * bss + c8 : bb, okn);
      cp_async16(Ct + r * RT + c8, okn ? cb + tr * css + c8 : cb, okn);
      cp_async16(Xt + r * RT + c8, okp ? xb + tr * xss + c8 : xb, okp);
    }
    if (tid < kT) {
      const bool ok = tid < qv;
      cp_async4(dts + st * kT + tid, ok ? dtb + (t0 + tid) * dss : dtb, ok);
    }
  };

  float hacc[8][4];   // state rows 16 warp + g (+ 8), columns 8 nt + 2t (+ 1)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) hacc[nt][0] = hacc[nt][1] = hacc[nt][2] = hacc[nt][3] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < ntiles; ++c) {
    const int st = c & 1;
    if (c + 1 < ntiles) load(c + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile c has landed; tile c + 1 may be in flight
    __syncthreads();      // ... for every thread, and so has the state split at the end of c - 1
    const bf16* Bt = tiles + (st * 3) * kT * RT;
    const bf16* Ct = Bt + kT * RT;
    const bf16* Xt = Ct + kT * RT;
    const float* dtt = dts + st * kT;
    const int t0 = c * kT, qv = min(kT, S - t0);

    // cum = inclusive cumsum of dt * a over the tile, in every warp: lane l
    // holds steps l (v0) and l + 32 (v1).  Steps past qv have dt = 0.
    const float d0 = dtt[lane], d1 = dtt[lane + 32];
    float v0 = d0 * av, v1 = d1 * av;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(full, v0, off), u1 = __shfl_up_sync(full, v1, off);
      if (lane >= off) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(full, v0, 31);
    const float seg = __shfl_sync(full, v1, 31);
    // the state update's weights w_j = exp(seg - cum_j) dt_j
    const float w0 = expf(seg - v0) * d0, w1 = expf(seg - v1) * d1;

    // ---- y rows 16 warp .. + 15: exp(cum_i) (C h)_i + (G x)_i
    if (16 * warp < qv) {
      const int i0 = 16 * warp + g, i1 = i0 + 8;
      const float vsrc = warp < 2 ? v0 : v1;   // the warp's rows lie in one half
      const float cum0 = __shfl_sync(full, vsrc, i0 % 32), cum1 = __shfl_sync(full, vsrc, i1 % 32);

      uint32_t cf[4][4];   // C rows of the warp, A fragments over N
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        ldsm_x4(cf[kd], Ct + (16 * warp + lane % 16) * RT + kd * 16 + (lane / 16) * 8);
      float yacc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;

      if (c > 0) {   // the carried state: C (h_hi + h_lo), scaled by exp(cum_i)
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            const int off = (kd * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RT + np * 16 + (lane / 16) * 8;
            uint32_t hb[4];
            ldsm_x4_t(hb, Hhi + off);
            mma_bf16(yacc[2 * np], cf[kd], hb[0], hb[1]);
            mma_bf16(yacc[2 * np + 1], cf[kd], hb[2], hb[3]);
            ldsm_x4_t(hb, Hlo + off);
            mma_bf16(yacc[2 * np], cf[kd], hb[0], hb[1]);
            mma_bf16(yacc[2 * np + 1], cf[kd], hb[2], hb[3]);
          }
        }
        const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          yacc[nt][0] *= e0;
          yacc[nt][1] *= e0;
          yacc[nt][2] *= e1;
          yacc[nt][3] *= e1;
        }
      }

      // the 16-step column blocks kk at or below the diagonal block
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp || 16 * kk >= qv) continue;   // warp-uniform
        float s[2][4];   // C B^T, columns 16 kk + 8 half + 2t (+ 1)
#pragma unroll
        for (int half = 0; half < 2; ++half) s[half][0] = s[half][1] = s[half][2] = s[half][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
          uint32_t kb[4];
          ldsm_x4(kb, Bt + (kk * 16 + lane % 8 + (lane / 16) * 8) * RT + kd * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[0], cf[kd], kb[0], kb[1]);
          mma_bf16(s[1], cf[kd], kb[2], kb[3]);
        }
        // G = (C B^T) o exp(cum_i - cum_j) o dt_j for j <= i, split into the
        // A fragments of the G x product (exp only where j <= i: there
        // cum_i - cum_j <= 0)
        const float csrc = kk < 2 ? v0 : v1, dsrc = kk < 2 ? d0 : d1;
        uint32_t ghi[4], glo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * kk + 8 * half + 2 * t;
          const float cj0 = __shfl_sync(full, csrc, j % 32), cj1 = __shfl_sync(full, csrc, (j + 1) % 32);
          const float dj0 = __shfl_sync(full, dsrc, j % 32), dj1 = __shfl_sync(full, dsrc, (j + 1) % 32);
          const float g00 = j <= i0 ? s[half][0] * expf(cum0 - cj0) * dj0 : 0.f;
          const float g01 = j + 1 <= i0 ? s[half][1] * expf(cum0 - cj1) * dj1 : 0.f;
          const float g10 = j <= i1 ? s[half][2] * expf(cum1 - cj0) * dj0 : 0.f;
          const float g11 = j + 1 <= i1 ? s[half][3] * expf(cum1 - cj1) * dj1 : 0.f;
          split2(g00, g01, ghi[2 * half], glo[2 * half]);
          split2(g10, g11, ghi[2 * half + 1], glo[2 * half + 1]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RT + np * 16 + (lane / 16) * 8);
          mma_bf16(yacc[2 * np], ghi, xf[0], xf[1]);
          mma_bf16(yacc[2 * np + 1], ghi, xf[2], xf[3]);
          mma_bf16(yacc[2 * np], glo, xf[0], xf[1]);
          mma_bf16(yacc[2 * np + 1], glo, xf[2], xf[3]);
        }
      }

#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        if (8 * nt >= P) continue;
        if (i0 < qv)
          *reinterpret_cast<float2*>(y + (((size_t)b * S + t0 + i0) * H + hh) * P + p) =
              make_float2(yacc[nt][0], yacc[nt][1]);
        if (i1 < qv)
          *reinterpret_cast<float2*>(y + (((size_t)b * S + t0 + i1) * H + hh) * P + p) =
              make_float2(yacc[nt][2], yacc[nt][3]);
      }
    }

    // ---- state rows 16 warp .. + 15: h <- exp(seg) h + (B o w)^T x
    {
      const float eseg = expf(seg);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        hacc[nt][0] *= eseg;
        hacc[nt][1] *= eseg;
        hacc[nt][2] *= eseg;
        hacc[nt][3] *= eseg;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= qv) continue;   // block-uniform
        // A = B^T (rows n, columns j), from B [j][n] by a transposing ldmatrix
        uint32_t ab[4];
        ldsm_x4_t(ab, Bt + (kk * 16 + lane % 8 + (lane / 16) * 8) * RT + 16 * warp + ((lane / 8) % 2) * 8);
        const float wsrc = kk < 2 ? w0 : w1;
        const int j = 16 * kk + 2 * t;
        const float wa = __shfl_sync(full, wsrc, j % 32), wb = __shfl_sync(full, wsrc, (j + 1) % 32);
        const float wc = __shfl_sync(full, wsrc, (j + 8) % 32), wd = __shfl_sync(full, wsrc, (j + 9) % 32);
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack_bf16(ab[r]);
          split2(f.x * (r < 2 ? wa : wc), f.y * (r < 2 ? wb : wd), ahi[r], alo[r]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, Xt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RT + np * 16 + (lane / 16) * 8);
          mma_bf16(hacc[2 * np], ahi, xf[0], xf[1]);
          mma_bf16(hacc[2 * np + 1], ahi, xf[2], xf[3]);
          mma_bf16(hacc[2 * np], alo, xf[0], xf[1]);
          mma_bf16(hacc[2 * np + 1], alo, xf[2], xf[3]);
        }
      }
    }

    __syncthreads();   // every warp is done with this stage and with Hhi / Hlo
    if (c + 1 < ntiles) {   // the state entering tile c + 1, split for its C h
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int r0 = 16 * warp + g, p = 8 * nt + 2 * t;
        uint32_t hi, lo;
        split2(hacc[nt][0], hacc[nt][1], hi, lo);
        *reinterpret_cast<uint32_t*>(Hhi + r0 * RT + p) = hi;
        *reinterpret_cast<uint32_t*>(Hlo + r0 * RT + p) = lo;
        split2(hacc[nt][2], hacc[nt][3], hi, lo);
        *reinterpret_cast<uint32_t*>(Hhi + (r0 + 8) * RT + p) = hi;
        *reinterpret_cast<uint32_t*>(Hlo + (r0 + 8) * RT + p) = lo;
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n0 = 16 * warp + g, p = 8 * nt + 2 * t;
    if (8 * nt >= P) continue;
    if (n0 < N)
      *reinterpret_cast<float2*>(hlast + (((size_t)b * H + hh) * N + n0) * P + p) =
          make_float2(hacc[nt][0], hacc[nt][1]);
    if (n0 + 8 < N)
      *reinterpret_cast<float2*>(hlast + (((size_t)b * H + hh) * N + n0 + 8) * P + p) =
          make_float2(hacc[nt][2], hacc[nt][3]);
  }
}

cudaError_t launch_tc(const void* x, const void* dt, const void* a, const void* bm,
                      const void* cm, void* y, void* hlast, int batch, int S, int H, int P,
                      int N, const long long* st, cudaStream_t stream) {
  auto kernel = ssd_scan_tc_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch * H, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const bf16*>(bm), static_cast<const bf16*>(cm), static_cast<float*>(y),
      static_cast<float*>(hlast), S, H, P, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9]);
  return cudaGetLastError();
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
  if (in_bf16)   // the tensor-core kernel walks 64-step tiles whatever the chunk
    err = launch_tc(x, dt, a, bm, cm, y, hlast, batch, s, h, p, n, st, stream_);
  else
    err = launch<float>(x, dt, a, bm, cm, y, hlast, batch, s, h, p, n, q, st, stream_);
  return (int)err;
}
