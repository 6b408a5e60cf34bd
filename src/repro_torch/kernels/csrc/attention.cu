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
// key gets 0, as in the reference.  The Sq x Skv score matrix never exists.
//
// GQA fold, in every path: a block owns one (batch, KV head), and a "row" is
// a (query position, group member) pair, so the g = 6 query heads of
// qwen2-1.5b that share KV head h / g are rows of one tile.  Each K/V tile is
// read from device memory once per KV head and reused by all g heads.
//
// Three kernels, chosen by the pair of types and the row count rows = Sq * g:
//
// 1. bf16 q and kv, rows > 16 (prefill, training): tensor cores.
//    Bound by operations (4 * D flops per visible query-key pair) at long
//    sequences; at the serving shapes the work is small and latency decides.
//    S = Q K^T and O += P V run as mma.sync.m16n8k16 (bf16 in, f32
//    accumulators in registers) in the FlashAttention-2 layout: 4 warps, each
//    owning 16 of the block's 64 rows, over 64-key tiles.  mma.sync and not
//    wgmma: with 16 rows a warp the softmax stays in the registers that hold
//    S, P goes from the S accumulators straight into the A fragments of the
//    PV product with no trip through shared memory, and the kernel needs no
//    TMA descriptors (the GQA fold gathers rows across heads, which a tensor
//    map does not express).  wgmma/TMA with warp specialisation is later
//    work.  Q, K and V stay bf16 in shared memory, rows padded by 8 values
//    (16 bytes) so the 8 row addresses of each ldmatrix fall in distinct
//    banks; K/V tiles arrive by cp.async (16 bytes a thread) in two stages,
//    the next tile loading while this one computes.  P is rounded to bf16
//    for the PV product, as FlashAttention, SDPA and the reference's
//    decode_attention do; l sums the f32 P.  Tiles the causal or window mask
//    hides entirely are skipped, per-element masking runs only on tiles that
//    the mask cuts, and the heaviest causal row tiles are issued first.
//    Shared memory 87 KB at D = 128, so two blocks share an SM.
//
// 2. bf16 q and kv, rows <= 16 (decode, short prompts): split-KV.  Bound by
//    bytes: the visible cache rows are read once.  The visible keys are cut
//    into as many splits (of at least 32 keys) as one wave of blocks holds
//    (from the occupancy of the kernel), so that B * K * splits fills the
//    card: 16 splits for qwen2-1.5b's B * K = 8, 6 for zamba2's 128.  A
//    block walks its split in 32-key tiles that arrive by cp.async (16
//    bytes a thread) in two stages, with an online softmax; scores and P V
//    are f32 FMAs (no 16-row tile is spent on zamba2's single row; with few
//    rows the keys of a tile are dealt out over several threads per output
//    column group).  Each block writes its partial (m, l, acc) in f32 to
//    scratch.  The last block of each (batch, KV head) to finish, found by
//    an atomic ticket after a threadfence, merges the partials by
//    log-sum-exp in split order (the output does not depend on which block
//    merges), with eight splits' loads in flight at a time, and resets its
//    ticket to 0.  A split that shows a row no key merges as nothing; a row
//    that sees none anywhere gets 0.  One launch per call.
//
// 3. f32 q (kv f32 or bf16): the first version's f32 FMA kernel, its
//    arithmetic unchanged: it carries the f32 checks (card f32 against the
//    CPU within 2e-5).  A block of BR = 64 (16 for rows <= 16) rows walks the
//    64-key tiles with K/V widened to f32 in shared memory (rows padded to
//    D + 4 floats).  Launch bounds of one block per SM let ptxas keep it free
//    of spills.
//
// Head dims 32, 64, 128 (qwen2) and 80 (zamba2's shared block, 2560 / 32);
// the head dimension is not padded in device memory.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a type/head_dim the file does not
// instantiate or a split-KV call without its scratch; the Python wrapper
// checks those first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int BK = 64;       // keys per tile
constexpr int SP = BK + 8;   // padded score row (floats)
constexpr int kSplitRows = 16;   // rows <= this take the split-KV kernel
constexpr int kSplitTile = 32, kSplitMinKeys = 32;  // keys per tile; the shortest split
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

// ------------------------------------------------ bf16: PTX building blocks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ bool visible(int n, int qpos, int kv_len, int window, int causal) {
  return n < kv_len && (!causal || n <= qpos) && (window <= 0 || qpos - n < window);
}

// ------------------------------------------ bf16, rows > 16: tensor cores

template <int D>
constexpr size_t tc_smem_bytes() {
  // Qs [64][D+8], Ks/Vs [2 stages][64][D+8], bf16
  return sizeof(bf16) * (size_t)(64 + 4 * BK) * (D + 8);
}

// Grid: one block per (row tile, batch, KV head), flattened with the row
// tile slowest and reversed, so the causal tiles with the most keys go first.
// Warp w owns rows 16w .. 16w + 15 of the tile; lane l holds, in the mma
// accumulator layout, rows l/4 and l/4 + 8 of those and columns 2(l%4), +1
// of every 8-column tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
gqa_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int nb, int sq, int h,
                        int kh, int skv, int kv_len, int q_offset, int window, int causal,
                        float scale_log2) {
  static_assert(D % 16 == 0, "head_dim");
  constexpr int BR = 64, DP = D + 8, C8 = D / 8, KD = D / 16;
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + BR * DP;      // [2][BK][DP]
  bf16* Vs = Ks + 2 * BK * DP;  // [2][BK][DP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / kh, rows = sq * g;
  const int bh = blockIdx.x % (nb * kh);
  const int r0 = ((rows + BR - 1) / BR - 1 - blockIdx.x / (nb * kh)) * BR;
  const int b = bh / kh, kvh = bh % kh;

  // the keys any row of this block can see
  const int r_last = min(r0 + BR, rows) - 1;
  const int qpos_lo = q_offset + r0 / g, qpos_hi = q_offset + r_last / g;
  const int kv_hi = causal ? min(kv_len, qpos_hi + 1) : kv_len;
  const int kv_lo = window > 0 ? max(0, qpos_lo - window + 1) / BK * BK : 0;

  for (int idx = tid; idx < BR * C8; idx += kThreads) {
    const int r = idx / C8, c = idx % C8, R = r0 + r;
    const bool ok = R < rows;
    const bf16* src = ok ? q + (((size_t)b * sq + R / g) * h + (size_t)kvh * g + R % g) * D + c * 8
                         : q;
    cp_async16(Qs + r * DP + c * 8, src, ok);
  }
  auto load_kv = [&](int n0, int stage) {
    for (int idx = tid; idx < BK * C8; idx += kThreads) {
      const int n = idx / C8, c = idx % C8, N = n0 + n;
      const bool ok = N < kv_hi;  // zero past the valid keys: P = 0 must not meet a NaN
      const size_t off = ok ? (((size_t)b * skv + N) * kh + kvh) * D + c * 8 : 0;
      cp_async16(Ks + (stage * BK + n) * DP + c * 8, k + off, ok);
      cp_async16(Vs + (stage * BK + n) * DP + c * 8, v + off, ok);
    }
  };
  if (kv_lo < kv_hi) load_kv(kv_lo, 0);
  cp_async_commit();

  const int rA = r0 + warp * 16 + lane / 4, rB = rA + 8;
  const int posA = q_offset + rA / g, posB = q_offset + rB / g;
  const bool okA = rA < rows, okB = rB < rows;
  const bool rows_full = r0 + BR <= rows;

  uint32_t qf[KD][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  int stage = 0;
  for (int n0 = kv_lo; n0 < kv_hi; n0 += BK, stage ^= 1) {
    if (n0 + BK < kv_hi) load_kv(n0 + BK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed; the next may be in flight
    __syncthreads();
    if (n0 == kv_lo) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], Qs + (warp * 16 + lane % 16) * DP + kd * 16 + (lane / 16) * 8);
    }
    const bf16* Kt = Ks + stage * BK * DP;
    const bf16* Vt = Vs + stage * BK * DP;

    // S = Q K^T: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * DP + kd * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kd], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }
    }

    // scale (log2 domain) and mask; tiles inside every row's view skip the test
    const bool tile_full = rows_full && n0 + BK <= kv_len && (!causal || n0 + BK - 1 <= qpos_lo) &&
                           (window <= 0 || qpos_hi - n0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int N = n0 + j * 8 + (lane % 4) * 2 + (e & 1);
        const bool ok = tile_full || (e < 2 ? okA && visible(N, posA, kv_len, window, causal)
                                            : okB && visible(N, posB, kv_len, window, causal));
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax on the two rows this lane holds (a quad shares a row)
    float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mxA = fmaxf(mxA, fmaxf(s[j][0], s[j][1]));
      mxB = fmaxf(mxB, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const float msA = mnA == -INFINITY ? 0.f : mnA;  // fully masked so far
    const float msB = mnB == -INFINITY ? 0.f : mnB;
    const float cA = exp2f(mA - msA), cB = exp2f(mB - msB);  // 0 while m is -inf
    mA = mnA;
    mB = mnB;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - msA);
      s[j][1] = exp2f(s[j][1] - msA);
      s[j][2] = exp2f(s[j][2] - msB);
      s[j][3] = exp2f(s[j][3] - msB);
      sumA += s[j][0] + s[j][1];
      sumB += s[j][2] + s[j][3];
    }
    lA = lA * cA + sumA;  // this lane's share; the quad is summed at the end
    lB = lB * cB + sumB;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= cA;
      acc[j][1] *= cA;
      acc[j][2] *= cB;
      acc[j][3] *= cB;
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk + 1 are the A
    // fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * DP + dp * 16 +
                          (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration's load may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / fmaxf(lA, 1e-30f), iB = 1.f / fmaxf(lB, 1e-30f);
  const int col = (lane % 4) * 2;
  if (okA) {
    bf16* dst = o + (((size_t)b * sq + rA / g) * h + (size_t)kvh * g + rA % g) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) = pack_bf16(acc[j][0] * iA, acc[j][1] * iA);
  }
  if (okB) {
    bf16* dst = o + (((size_t)b * sq + rB / g) * h + (size_t)kvh * g + rB % g) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) = pack_bf16(acc[j][2] * iB, acc[j][3] * iB);
  }
}

// --------------------------------------------- bf16, rows <= 16: split-KV

template <int D>
constexpr size_t split_smem_bytes() {
  // Ks/Vs [2 stages][32][D+8] bf16; Qs [16][D], Ss [16][32], m/l/corr [16],
  // partial sums [128][8] f32
  return sizeof(bf16) * 4 * kSplitTile * (D + 8) +
         sizeof(float) * (kSplitRows * D + kSplitRows * kSplitTile + 3 * kSplitRows + kThreads * 8);
}

// Grid (splits, K, B).  Split s covers keys [kv_lo + s * len, + len) of the
// visible range, in 32-key tiles that arrive by cp.async in two stages, with
// an online softmax over the tiles.  Scratch holds, for each (batch, KV head,
// split, row < 16), first m (log2 domain, -inf if the split shows the row no
// key) and l, then, after all of those, the unnormalised acc of D floats.
// tickets[b * K + kvh] counts finished splits.
template <int D>
__global__ void __launch_bounds__(kThreads)
gqa_attention_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int h,
                           int kh, int skv, int kv_len, int q_offset, int window, int causal,
                           float scale_log2, int kv_lo, int kv_hi, int len,
                           float* __restrict__ scratch, int* __restrict__ tickets) {
  constexpr int T = kSplitTile, DP = D + 8, C8 = D / 8;
  constexpr int IPT = (kSplitRows * C8 + kThreads - 1) / kThreads;  // PV items a thread holds
  extern __shared__ uint4 smem_split[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_split);  // [2][T][DP]
  bf16* Vs = Ks + 2 * T * DP;                      // [2][T][DP]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * T * DP);
  float* Ss = Qs + kSplitRows * D;
  float* m_s = Ss + kSplitRows * T;
  float* l_s = m_s + kSplitRows;
  float* c_s = l_s + kSplitRows;
  float* red = c_s + kSplitRows;
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / kh, rows = sq * g;
  const int s = blockIdx.x, nsplit = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int bh = b * kh + kvh;
  const size_t rec0 = ((size_t)bh * nsplit + s) * kSplitRows;  // this split's row 0
  float* ml = scratch;                                        // [.., 16][2]
  float* accs = scratch + (size_t)gridDim.z * kh * nsplit * kSplitRows * 2;  // [.., 16][D]
  const int n_lo = kv_lo + s * len, n_hi = min(n_lo + len, kv_hi);

  auto load_kv = [&](int n0, int stage) {
    const int cnt = min(T, n_hi - n0);
    for (int idx = tid; idx < cnt * C8; idx += kThreads) {
      const int n = idx / C8, c = idx % C8;
      const size_t off = (((size_t)b * skv + n0 + n) * kh + kvh) * D + c * 8;
      cp_async16(Ks + (stage * T + n) * DP + c * 8, k + off, true);
      cp_async16(Vs + (stage * T + n) * DP + c * 8, v + off, true);
    }
  };
  if (n_lo < n_hi) load_kv(n_lo, 0);
  cp_async_commit();
  for (int idx = tid; idx < rows * C8; idx += kThreads) {
    const int r = idx / C8, c = idx % C8;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + (((size_t)b * sq + r / g) * h + (size_t)kvh * g + r % g) * D + c * 8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      Qs[r * D + c * 8 + 2 * e] = f.x;
      Qs[r * D + c * 8 + 2 * e + 1] = f.y;
    }
  }
  if (tid < kSplitRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // P V: an item is (row, 8 columns); with few items the keys are dealt out
  // over `parts` threads per item, summed in shared memory at the end
  const int items = rows * C8;
  const int parts = max(1, kThreads / items);
  float acc[IPT][8];
#pragma unroll
  for (int u = 0; u < IPT; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;

  int stage = 0;
  for (int n0 = n_lo; n0 < n_hi; n0 += T, stage ^= 1) {
    if (n0 + T < n_hi) load_kv(n0 + T, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int Lt = min(T, n_hi - n0);
    const bf16* Kt = Ks + stage * T * DP;
    const bf16* Vt = Vs + stage * T * DP;

    // scores, one (row, key) pair a thread: neighbouring lanes take neighbouring keys
    for (int p = tid; p < rows * T; p += kThreads) {
      const int r = p / T, n = p % T;
      float sc = -INFINITY;
      if (n < Lt && visible(n0 + n, q_offset + r / g, kv_len, window, causal)) {
        const bf16* kr = Kt + n * DP;
        const float* qr = Qs + r * D;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < D; c += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 q0 = *reinterpret_cast<const float4*>(qr + c);
          const float4 q1 = *reinterpret_cast<const float4*>(qr + c + 4);
          const float2 k0 = __bfloat1622float2(h2[0]), k1 = __bfloat1622float2(h2[1]);
          const float2 k2 = __bfloat1622float2(h2[2]), k3 = __bfloat1622float2(h2[3]);
          a[0] = fmaf(q0.x, k0.x, a[0]);
          a[1] = fmaf(q0.y, k0.y, a[1]);
          a[2] = fmaf(q0.z, k1.x, a[2]);
          a[3] = fmaf(q0.w, k1.y, a[3]);
          a[0] = fmaf(q1.x, k2.x, a[0]);
          a[1] = fmaf(q1.y, k2.y, a[1]);
          a[2] = fmaf(q1.z, k3.x, a[2]);
          a[3] = fmaf(q1.w, k3.y, a[3]);
        }
        sc = ((a[0] + a[1]) + (a[2] + a[3])) * scale_log2;
      }
      Ss[r * T + n] = sc;
    }
    __syncthreads();

    // online softmax, one warp a row, one key a lane
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float x = Ss[r * T + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      const float ms = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      const float p = exp2f(x - ms);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * T + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = exp2f(m_old - ms);  // 0 while m is -inf
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int t = tid + u * kThreads;
      if (t >= items * parts) continue;
      const int item = t % items, part = t / items;
      const int r = item / C8, c = item % C8;
      const float cr = c_s[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][e] *= cr;
      for (int n = part; n < Lt; n += parts) {
        const float pr = Ss[r * T + n];
        const uint4 raw = *reinterpret_cast<const uint4*>(Vt + n * DP + c * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          acc[u][2 * e] = fmaf(pr, f.x, acc[u][2 * e]);
          acc[u][2 * e + 1] = fmaf(pr, f.y, acc[u][2 * e + 1]);
        }
      }
    }
    __syncthreads();  // this stage and Ss are read
  }
  cp_async_wait<0>();
  __syncthreads();  // m_s, l_s are final (also when the split holds no tile)

  if (tid < rows) {
    ml[(rec0 + tid) * 2] = m_s[tid];
    ml[(rec0 + tid) * 2 + 1] = l_s[tid];
  }
  if (parts == 1) {
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int t = tid + u * kThreads;
      if (t >= items) continue;
      float4* dst = reinterpret_cast<float4*>(accs + (rec0 + t / C8) * D + (t % C8) * 8);
      dst[0] = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      dst[1] = make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
    }
  } else {  // items * parts <= kThreads: one item a thread
    if (tid < items * parts) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[tid * 8 + e] = acc[0][e];
    }
    __syncthreads();
    for (int idx = tid; idx < items * 8; idx += kThreads) {  // one float a thread
      const int item = idx / 8, e = idx % 8;
      float sum = 0.f;
      for (int part = 0; part < parts; ++part) sum += red[(part * items + item) * 8 + e];
      accs[(rec0 + item / C8) * D + (item % C8) * 8 + e] = sum;
    }
  }

  // the last split of this (batch, KV head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The partials live in L2 (written by other SMs): read past L1.  An item
  // is (row, 8 columns); the splits are taken 8 at a time with all their
  // loads in flight together, merged online (rescaled to the running max)
  // in split order, so the result does not depend on which block merges.
  constexpr int MC = 8;
  const float* mlb = ml + (size_t)bh * nsplit * kSplitRows * 2;
  const float* accb = accs + (size_t)bh * nsplit * kSplitRows * D;
  for (int item = tid; item < items; item += kThreads) {
    const int r = item / C8, c = item % C8;
    float m = -INFINITY, l = 0.f, a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < nsplit; t0 += MC) {
      float mt[MC], lt[MC];
      float4 x0[MC], x1[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const size_t rec = (size_t)(t0 + j) * kSplitRows + r;
        const bool ok = t0 + j < nsplit;
        mt[j] = ok ? __ldcg(mlb + rec * 2) : -INFINITY;
        lt[j] = ok ? __ldcg(mlb + rec * 2 + 1) : 0.f;
        const float4* src = reinterpret_cast<const float4*>(accb + rec * D + c * 8);
        x0[j] = ok ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        x1[j] = ok ? __ldcg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < MC; ++j) m_new = fmaxf(m_new, mt[j]);
      if (m_new == -INFINITY) continue;  // no key in these splits or before
      const float corr = exp2f(m - m_new);  // 0 while m is -inf
      l *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] *= corr;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const float w = exp2f(mt[j] - m_new);  // 0 for a split that saw no key
        l = fmaf(w, lt[j], l);
        a[0] = fmaf(w, x0[j].x, a[0]);
        a[1] = fmaf(w, x0[j].y, a[1]);
        a[2] = fmaf(w, x0[j].z, a[2]);
        a[3] = fmaf(w, x0[j].w, a[3]);
        a[4] = fmaf(w, x1[j].x, a[4]);
        a[5] = fmaf(w, x1[j].y, a[5]);
        a[6] = fmaf(w, x1[j].z, a[6]);
        a[7] = fmaf(w, x1[j].w, a[7]);
      }
      m = m_new;
    }
    const float il = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key gets 0
    uint4 out;
    out.x = pack_bf16(a[0] * il, a[1] * il);
    out.y = pack_bf16(a[2] * il, a[3] * il);
    out.z = pack_bf16(a[4] * il, a[5] * il);
    out.w = pack_bf16(a[6] * il, a[7] * il);
    *reinterpret_cast<uint4*>(o + (((size_t)b * sq + r / g) * h + (size_t)kvh * g + r % g) * D +
                              c * 8) = out;
  }
  if (tid == 0) tickets[bh] = 0;
}

// ------------------------------------------------------------- f32 queries

template <int BR, int D>
constexpr size_t smem_bytes() {
  // Qs [BR][D+4], Ks/Vs [BK][D+4], Ss [BR][SP], m/l/corr [BR]
  return sizeof(float) * ((size_t)(BR + 2 * BK) * (D + 4) + (size_t)BR * SP + 3 * BR);
}

// Thread t owns rows rg + 16*ii (ii < BR/16) with rg = t / 8, the score
// columns cg + 8*jj (jj < 8) and the output columns 4*(cg + 8*kk) .. +3
// (kk < ceil(D/32), those below D) with cg = t % 8.
template <typename TQ, typename TKV, int BR, int D>
__global__ void __launch_bounds__(kThreads, 1)
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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int b, int sq, int h,
                      int kh, int skv, int kv_len, int q_offset, int window, int causal,
                      float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = gqa_attention_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (sq * (h / kh) + 63) / 64;
  kernel<<<tiles * b * kh, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), b, sq, h, kh, skv, kv_len, q_offset, window, causal,
      sm_scale * kLog2e);
  return cudaGetLastError();
}

// scratch holds b * kh * ceil(skv / 32) * 16 * (D + 2) floats (room for
// the most splits the rule below can choose); tickets b * kh zeros.
template <int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o, int b, int sq,
                         int h, int kh, int skv, int kv_len, int q_offset, int window,
                         int causal, float sm_scale, float* scratch, int* tickets, int device,
                         cudaStream_t stream) {
  if (scratch == nullptr || tickets == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem = split_smem_bytes<D>();
  auto kernel = gqa_attention_split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  // the keys some row sees
  const int kv_hi = causal ? min(kv_len, q_offset + sq) : kv_len;
  const int kv_lo = window > 0 ? max(0, q_offset - window + 1) : 0;
  const int n_keys = max(0, kv_hi - kv_lo);
  // as many splits as one wave of blocks holds, none shorter than 32 keys;
  // a split of more than one tile takes whole tiles
  int splits = max(1, min(sms * per_sm / (b * kh), (n_keys + kSplitMinKeys - 1) / kSplitMinKeys));
  int len = max(1, (n_keys + splits - 1) / splits);
  if (len > kSplitTile) len = (len + kSplitTile - 1) / kSplitTile * kSplitTile;
  splits = max(1, (n_keys + len - 1) / len);  // every split holds a key
  kernel<<<dim3(splits, kh, b), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, h, kh, skv, kv_len, q_offset, window, causal,
      sm_scale * kLog2e, kv_lo, kv_hi, len, scratch, tickets);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int sq,
                        int h, int kh, int skv, int kv_len, int q_offset, int window, int causal,
                        float sm_scale, float* scratch, int* tickets, int device,
                        cudaStream_t stream) {
  if (sq * (h / kh) <= kSplitRows)
    return launch_split<D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                           sm_scale, scratch, tickets, device, stream);
  return launch_tc<D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal, sm_scale,
                      stream);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int sq,
                       int h, int kh, int skv, int kv_len, int q_offset, int window, int causal,
                       float sm_scale, cudaStream_t stream) {
  // few rows (decode: Sq = 1, g rows) take the small tile
  if (sq * (h / kh) <= 16)
    return launch<TQ, TKV, 16, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                  causal, sm_scale, stream);
  return launch<TQ, TKV, 64, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                causal, sm_scale, stream);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int b, int sq, int h,
                     int kh, int skv, int kv_len, int q_offset, int window, int causal,
                     float sm_scale, int q_bf16, int kv_bf16, float* scratch, int* tickets,
                     int device, cudaStream_t stream) {
  if (q_bf16 && kv_bf16)
    return launch_bf16<D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                          sm_scale, scratch, tickets, device, stream);
  if (!q_bf16 && kv_bf16)
    return launch_f32<float, bf16, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                      causal, sm_scale, stream);
  if (!q_bf16 && !kv_bf16)
    return launch_f32<float, float, D>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window,
                                       causal, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: [b, sq, h, d]; k, v: [b, skv, kh, d]; all contiguous and 16-byte
// aligned.  q/o are float32 (q_bf16 = 0) or bfloat16; k/v float32
// (kv_bf16 = 0) or bfloat16.  window <= 0 means no window.  scratch and
// tickets serve the split-KV path (bf16, sq * h / kh <= 16) and may be null
// otherwise: scratch holds b * kh * ceil(skv / 32) * 16 * (d + 2) floats of
// any content, tickets b * kh ints that are 0 (each launch leaves them 0).
extern "C" int repro_gqa_attention(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int h, int kh, int skv, int d, int kv_len,
                                   int q_offset, int window, int causal, float sm_scale,
                                   int q_bf16, int kv_bf16, void* scratch, void* tickets,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  int* tk = static_cast<int*>(tickets);
  switch (d) {
    case 32:
      return (int)launch_d<32>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                               sm_scale, q_bf16, kv_bf16, sc, tk, device, s);
    case 64:
      return (int)launch_d<64>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                               sm_scale, q_bf16, kv_bf16, sc, tk, device, s);
    case 80:
      return (int)launch_d<80>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                               sm_scale, q_bf16, kv_bf16, sc, tk, device, s);
    case 128:
      return (int)launch_d<128>(q, k, v, o, b, sq, h, kh, skv, kv_len, q_offset, window, causal,
                                sm_scale, q_bf16, kv_bf16, sc, tk, device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
