// Flash attention backward (GQA; causal, sliding-window or full) for Hopper.
//
// The TPU side has no backward kernel: the JAX package differentiates its
// XLA attention with jax.grad.  This is the gradient of the forward in
// csrc/flash_attention.cu, for training.  With the forward's per-row
// log-sum-exp `lse` (natural log of the sum of exp over the row's scaled,
// masked scores) and, for GQA, g = H / KV query heads per kv head:
//
//   P  = exp(scale * Q K^T - lse)       (masked entries 0)
//   dV = sum over g of P^T dO
//   dP = dO V^T
//   dS = P o (dP - delta),               delta = rowsum(dO o O), fp32
//   dQ = scale * dS K
//   dK = scale * sum over g of dS^T Q
//
// q, o, dO (B, H, Sq, D); k, v (B, KV, Sk, D); lse and delta (B, H, Sq)
// fp32; dq, dk, dv in the input dtype (fp32, fp16 or bf16); all sums fp32.
// The masks are the forward's: query and key positions both count from 0,
// a row q sees keys k < Sk with k <= q (causal) and k > q - window
// (window > 0).  Head dims 64 and 128.  Rows that see no key are refused
// by the wrapper (kernels/flash_attention.py), so P never needs the
// forward's mean-of-v repair.
//
// Three kernels on one stream, with no atomics, so dq, dk and dv are the
// same bits from run to run: delta (one warp a row, delta = rowsum(dO o O));
// dk/dv, one block per (key tile, kv head, batch), which walks the g query
// heads of its group in order and, for each, the query tiles that can see
// the key tile (none below the diagonal, none past the window), recomputing
// S and dP; and dq, one block per (query tile, head, batch), longest causal
// tiles first, walking the key tiles the forward visits and recomputing S
// and dP again.  So 5 products of the math become 7, which is the price of
// no atomics and no (Sq, Sk) buffer in device memory: it caps either tiling
// at 5/7 of the bound's rate.
//
// Two tilings, one C entry point each; kernels/flash_attention.py's
// `attention_bwd_tiling` chooses among them:
//
// * wgmma (bf16/fp16; D = 64 or 128; every training step of the card's
//   bf16 models).  The dk/dv and dq kernels on the tensor cores, built like
//   the wgmma forward: blocks of three warpgroups, a producer at 24
//   registers (setmaxnreg) that feeds a 2-stage ring of 64-row tiles by TMA
//   (128-byte swizzle, zeros past Sq and Sk), and two consumers at 240 that
//   each own 64 rows of the block's 128.
//   - dk/dv: one block owns 128 keys; K and V are loaded once.  The
//     producer's first warp streams (Q, dO) tiles of 64 query rows and
//     copies their lse (times log2 e) and delta into the stage beside them.
//     Each consumer computes the transposed tiles S^T = K Q^T and dP^T =
//     V dO^T (wgmma m64n64k16, both operands K-major in shared memory, as
//     the forward's S = Q K^T), so the query is the accumulator's column:
//     P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T o (dP^T -
//     delta) read lse and delta by column.  The mask is applied only on
//     tiles that straddle the diagonal, the window's edge or Sq's tail;
//     tiles wholly masked for the warpgroup's keys are skipped.  P^T and
//     dS^T are rounded to the input's 16-bit type in registers, where the
//     accumulator's layout is the A fragment's (as the forward feeds P to
//     P V), and dV += P^T dO and dK += dS^T Q run as register-A wgmma with
//     dO and Q the MN-major B operand (the transpose bit) of the same tiles.
//     dK and dV take D fp32 registers a thread; dK is scaled once in the
//     epilogue, and key rows past Sk are not stored.
//   - dq: one block owns 128 query rows; Q and dO are loaded once, lse and
//     delta sit in registers, and the producer streams (K, V) tiles of 64
//     keys over the key tiles the forward visits.  S = Q K^T and dP = dO V^T
//     (K-major), dS = P o (dP - delta) rounded to 16 bits in registers, and
//     dQ += dS K with K read MN-major; dQ is scaled in the epilogue.
//   P and dS never touch shared memory, and the 16-bit rounding of P is
//   the JAX model's own (`_sdpa` rounds its probabilities to v's dtype,
//   and under jax.grad its dP and dS pass through 16-bit einsums too).
//   In both kernels S and dP are two wgmma groups, so P is computed while
//   dP's product runs, and the two consumers take turns at issuing them
//   (named barriers, ping-pong), so one's products run while the other
//   computes P and dS, rather than both waiting on the same stage in lockstep.
//   Shared memory: two 128-row operands and two stages of two 64-row tiles
//   (plus 512 bytes of lse and delta a stage for dk/dv): 65 KB at D = 64,
//   129 KB at D = 128.
// * fma (fp32, fp16 or bf16; exact fp32 for the narrow fp32 models, which
//   TF32 would not give).  Thread (ty, tx) of a 16 x 16 grid owns query
//   rows 4ty .. 4ty+3 and keys tx + 16j of a 64 x 64 tile pair; tiles are
//   staged in shared memory as fp32 (row stride D + 4), S and dP are fp32
//   FMAs on the CUDA cores, P and dS go through shared memory, and dV, dK
//   (key rows 4ty .. 4ty+3, columns 64c + 4tx .. +3) and dQ accumulate in
//   registers.  Keys past Sk and rows past Sq get P = 0.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 5 products of
// 2 * D flops a kept (query, key) pair.  At minicpm-2b's training shape
// (B = 4, H = KV = 36, S = 4096, D = 64, causal, bf16) that is 773 GFLOP a
// layer, 0.78 ms on the tensor cores against 0.45 GB of q, k, v, o, dO,
// lse, dq, dk, dv (0.13 ms): bound by operations; with 7 products the
// tensor cores need at least 1.09 ms.  The FMA pipes' own peak is
// 67 TFLOP/s, 15x below the tensor cores'.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3, CUDA-
// event means over 10 launches; PERF.md section 6, row 1b): at minicpm-2b's
// shape wgmma 2.55 ms, fma 35.04 ms on the same bf16 inputs, SDPA's backward
// 2.09 ms; at granite-8b's (B = 4, H = 32, KV = 8, S = 2048, D = 128) 1.03,
// 17.19 and 0.97 ms.  Per product the wgmma tiling outruns SDPA's backward;
// the two recomputed products are the gap.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // keys of a tile
constexpr int RQ = BQ / 16;   // query rows a thread owns in S, dP and dQ
constexpr int KJ = BK / 16;   // keys a thread owns in S and dP
constexpr int RK = BK / 16;   // key rows a thread owns in dK and dV
constexpr int LDP = BK + 4;   // row stride of the P and dS tiles, in floats
// Blocks of the dk/dv and dq kernels that fit on an SM by shared memory (104
// and 87 KB at D = 64, 170 and 153 KB at D = 128): the register budget
// ptxas is given, 128 or 255 a thread.
#define BLOCKS_PER_SM(D) ((D) == 64 ? 2 : 1)

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int dkdv_smem_bytes() {  // K, V, Q, dO tiles; P, dS; lse, delta
  return (4 * 64 * (D + 4) + 2 * BQ * LDP + 2 * BQ) * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, K, V tiles; dS; lse, delta
  return (4 * 64 * (D + 4) + BQ * LDP + 2 * BQ) * (int)sizeof(float);
}

// Copies rows [row0, row0 + ROWS) of a contiguous (rows, D) matrix into
// shared memory as fp32 with row stride D + 4; rows at or past `rows` are
// zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load: 4 or 8
  constexpr int VPR = D / VEC;         // 16-byte loads per row
  constexpr int LD = D + 4;
  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* d = dst + r * LD + c;
    const int row = row0 + r;
    float f[VEC];
    if (row < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = to_float<T>(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

// Copies rows [row0, row0 + BQ) of a per-row fp32 vector; 0 past `rows`.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int tid) {
  if (tid < BQ) dst[tid] = row0 + tid < rows ? src[row0 + tid] : 0.f;
}

// acc[i][j] = a[RQ*ty + i] . b[tx + 16*j] over D, for two (rows, D) tiles in
// shared memory with row stride D + 4.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[RQ][KJ], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[RQ], bv[KJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (RQ * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// For the (query tile q0, key tile k0) pair staged in shared memory, writes
// P and dS of this thread's entries (rows RQ*ty + i, keys tx + 16*j) to sP
// (if given) and sdS.  sQ, sK, sdO and sV hold the tiles, sLse and sDelta
// the query rows' lse and delta.
template <int D>
__device__ __forceinline__ void p_and_ds(float* sP, float* sdS, const float* sQ, const float* sK,
                                         const float* sdO, const float* sV, const float* sLse,
                                         const float* sDelta, int q0, int k0, int Sq, int Sk,
                                         int causal, int window, float scale, int ty, int tx) {
  float s[RQ][KJ], dp[RQ][KJ];
  dot_tile<D>(s, sQ, sK, ty, tx);
  dot_tile<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = RQ * ty + i;
    const int qpos = q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kpos = k0 + tx + 16 * j;
      bool keep = qpos < Sq && kpos < Sk;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      const float p = keep ? expf(s[i][j] * scale - lse) : 0.f;
      if (sP != nullptr) sP[r * LDP + tx + 16 * j] = p;
      sdS[r * LDP + tx + 16 * j] = p * (dp[i][j] - delta);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long rows) {
  const long row = ((long)blockIdx.x * THREADS + threadIdx.x) / 32;  // one warp a row
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) sum = fmaf(to_float<T>(orow[c]), to_float<T>(drow[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM(D))
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
            int KV, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;  // groups of 4 columns a thread owns in dK and dV
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sdS = sP + BQ * LDP;
  float* sLse = sdS + BQ * LDP;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;  // causal: key tile 0 has the most work and starts first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const size_t kv_off = (size_t)(b * KV + kvh) * Sk * D;

  load_tile<T, D, BK>(sK, k + kv_off, k0, Sk, tid);
  load_tile<T, D, BK>(sV, v + kv_off, k0, Sk, tid);

  // Query tiles that see a key of this tile: none above it (causal), none
  // whose rows are all past the window of its last key.
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt_begin = causal ? min(nq, k0 / BQ) : 0;
  const int qt_end = window > 0 ? min(nq, (k0 + BK + window - 2) / BQ + 1) : nq;

  float dk_acc[RK][4 * NC], dv_acc[RK][4 * NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int r = 0; r < g; ++r) {  // the group's query heads, in order
    const size_t bh = (size_t)b * H + kvh * g + r;
    const T* qp = q + bh * Sq * D;
    const T* dop = dout + bh * Sq * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, BQ>(sQ, qp, q0, Sq, tid);
      load_tile<T, D, BQ>(sdO, dop, q0, Sq, tid);
      load_rows(sLse, lse + bh * Sq, q0, Sq, tid);
      load_rows(sDelta, delta + bh * Sq, q0, Sq, tid);
      __syncthreads();
      p_and_ds<D>(sP, sdS, sQ, sK, sdO, sV, sLse, sDelta, q0, k0, Sq, Sk, causal, window, scale,
                  ty, tx);
      __syncthreads();
      // dV[kr][c] += sum_i P[i][kr] dO[i][c];  dK[kr][c] += sum_i dS[i][kr] Q[i][c]
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(sP + i * LDP + RK * ty);
        const float4 sv = *reinterpret_cast<const float4*>(sdS + i * LDP + RK * ty);
        const float pr[RK] = {pv.x, pv.y, pv.z, pv.w};
        const float sr[RK] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 dov = *reinterpret_cast<const float4*>(sdO + i * LD + 64 * c + 4 * tx);
          const float4 qv = *reinterpret_cast<const float4*>(sQ + i * LD + 64 * c + 4 * tx);
#pragma unroll
          for (int kk = 0; kk < RK; ++kk) {
            dv_acc[kk][4 * c + 0] = fmaf(pr[kk], dov.x, dv_acc[kk][4 * c + 0]);
            dv_acc[kk][4 * c + 1] = fmaf(pr[kk], dov.y, dv_acc[kk][4 * c + 1]);
            dv_acc[kk][4 * c + 2] = fmaf(pr[kk], dov.z, dv_acc[kk][4 * c + 2]);
            dv_acc[kk][4 * c + 3] = fmaf(pr[kk], dov.w, dv_acc[kk][4 * c + 3]);
            dk_acc[kk][4 * c + 0] = fmaf(sr[kk], qv.x, dk_acc[kk][4 * c + 0]);
            dk_acc[kk][4 * c + 1] = fmaf(sr[kk], qv.y, dk_acc[kk][4 * c + 1]);
            dk_acc[kk][4 * c + 2] = fmaf(sr[kk], qv.z, dk_acc[kk][4 * c + 2]);
            dk_acc[kk][4 * c + 3] = fmaf(sr[kk], qv.w, dk_acc[kk][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < RK; ++kk) {
    const int kpos = k0 + RK * ty + kk;
    if (kpos >= Sk) continue;
    T* dkrow = dk + kv_off + (size_t)kpos * D;
    T* dvrow = dv + kv_off + (size_t)kpos * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkrow[64 * c + 4 * tx + e] = from_float<T>(dk_acc[kk][4 * c + e] * scale);
        dvrow[64 * c + 4 * tx + e] = from_float<T>(dv_acc[kk][4 * c + e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM(D))
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Sq, int Sk,
          int causal, int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 64;  // groups of 4 columns a thread owns in dQ
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;
  float* sLse = sdS + BQ * LDP;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // causal: late query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t kv_off = (size_t)(b * KV + h / (H / KV)) * Sk * D;

  load_tile<T, D, BQ>(sQ, q + bh * Sq * D, q0, Sq, tid);
  load_tile<T, D, BQ>(sdO, dout + bh * Sq * D, q0, Sq, tid);
  load_rows(sLse, lse + bh * Sq, q0, Sq, tid);
  load_rows(sDelta, delta + bh * Sq, q0, Sq, tid);

  // The key tiles the forward visits: none above the diagonal, none before the window.
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;

  float acc[RQ][4 * NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of sK, sV and sdS are done
    load_tile<T, D, BK>(sK, k + kv_off, k0, Sk, tid);
    load_tile<T, D, BK>(sV, v + kv_off, k0, Sk, tid);
    __syncthreads();
    p_and_ds<D>(nullptr, sdS, sQ, sK, sdO, sV, sLse, sDelta, q0, k0, Sq, Sk, causal, window,
                scale, ty, tx);
    __syncthreads();
    // dQ[RQ*ty + i][64c + 4tx + e] += sum_j dS[RQ*ty + i][j] K[j][64c + 4tx + e]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 sv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        sv[i] = *reinterpret_cast<const float4*>(sdS + (RQ * ty + i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (j + jj) * LD + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float s = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y : jj == 2 ? sv[i].z : sv[i].w;
            acc[i][4 * c + 0] = fmaf(s, kv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(s, kv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(s, kv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(s, kv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + RQ * ty + i;
    if (qpos >= Sq) continue;
    T* dqrow = dq + bh * Sq * D + (size_t)qpos * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dqrow[64 * c + 4 * tx + e] = from_float<T>(acc[i][4 * c + e] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, long rows,
                         cudaStream_t stream) {
  delta_kernel<T, D><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0,
                       stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout), delta,
                                 rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int H,
                   int KV, int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_smem_bytes<D>(), dq_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_bytes);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf((float)D);

  err = launch_delta<T, D>(o, dout, delta, (long)B * H * Sq, stream);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D><<<dim3((Sk + BK - 1) / BK, KV, B), THREADS, dkdv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, KV, Sq, Sk,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H, KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int H,
                     int KV, int Sq, int Sk, int D, int causal, int window, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                         window, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                          window, stream);
  return cudaErrorInvalidValue;
}

// wgmma tiling.

namespace wg {
constexpr int BM = 128;  // keys of a dk/dv block, query rows of a dq block: two consumers of 64
constexpr int BN = 64;   // rows of a streamed tile: queries (dk/dv) or keys (dq)
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Smem {
  static constexpr int BIG = BM * D * 2;   // a 128-row operand: D / 64 boxes of 128 x 128 bytes
  static constexpr int TILE = BN * D * 2;  // a streamed 64-row tile: D / 64 boxes of 64 x 128
  static constexpr int ROWS = 2 * BN * 4;  // a query tile's lse and delta (dk/dv)
  static constexpr int BYTES = 2 * BIG + STAGES * (2 * TILE + ROWS) + 8 * (1 + 2 * STAGES) + 1024;
};

// Shared-memory descriptors of the two operand layouts (hopper.cuh): a
// K-major tile of `rows` rows at k16 step kk, and an MN-major 64-row tile
// at k16 step kk (16 rows of each 64-column box).
template <int ROWS> __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  return hopper::desc_sw128(base + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
  return hopper::desc_sw128(base + kk * 2048, BN * 128, 1024);
}

// Ping-pong between the two consumer warpgroups: each issues its S and dP
// products (S^T and dP^T in dk/dv) only in its turn, named barrier 1 + its
// index, at which the other warpgroup arrives once it has issued its own.
// So one warpgroup's products run while the other computes P and dS,
// instead of both waiting on the same stage and running in lockstep.  Both
// warpgroups take and pass a turn at every tile, skipped ones included.
__device__ __forceinline__ void take_turn(int warpgroup) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + warpgroup) : "memory");
}
__device__ __forceinline__ void pass_turn(int warpgroup) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - warpgroup) : "memory");
}
}  // namespace wg

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
                  int KV, int Sq, int Sk, int causal, int window, float scale, float scale_log2) {
  using wg::BM;
  using wg::BN;
  using wg::STAGES;
  using S = wg::Smem<D>;
  constexpr int CH = D / 64;  // 64-wide column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sk = smem;                  // K: the block's 128 keys
  uint8_t* sv = sk + S::BIG;           // V
  uint8_t* sq = sv + S::BIG;           // Q tile of stage s at sq + s * S::TILE
  uint8_t* sdo = sq + STAGES * S::TILE;  // dO tile of stage s
  float* srows = reinterpret_cast<float*>(sdo + STAGES * S::TILE);  // stage s: lse2[BN], delta[BN]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(srows + STAGES * 2 * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BM;  // causal: key tile 0 sees the most queries and starts first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const int bkv = b * KV + kvh;
  const int k_last = min(k0 + BM, Sk) - 1;
  // Query tiles that see a key of this block: none above it (causal), none
  // whose rows are all past the window of its last key.
  const int nq = (Sq + BN - 1) / BN;
  const int qt_begin = causal ? min(nq, k0 / BN) : 0;
  const int qt_end = window > 0 ? min(nq, (k_last + window - 1) / BN + 1) : nq;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's 32 lanes, one with the TMA bytes
      hopper::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x < 256 + 32) {  // its first warp
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * S::BIG);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_3d(sk + c * BM * 128, &map_k, kv_full, 64 * c, k0, bkv);
          hopper::tma_load_3d(sv + c * BM * 128, &map_v, kv_full, 64 * c, k0, bkv);
        }
      }
      int i = 0;
      for (int r = 0; r < g; ++r) {  // the group's query heads, in order
        const int bh = bkv * g + r;
        for (int qt = qt_begin; qt < qt_end; ++qt, ++i) {
          const int s = i % STAGES;
          const int q0 = qt * BN;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          float* rows = srows + s * 2 * BN;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {  // rows past Sq: lse 0, delta 0 (the mask zeroes P)
            const int row = q0 + lane + 32 * h2;
            const bool in = row < Sq;
            rows[lane + 32 * h2] = in ? lse[(size_t)bh * Sq + row] * wg::LOG2E : 0.f;
            rows[BN + lane + 32 * h2] = in ? delta[(size_t)bh * Sq + row] : 0.f;
          }
          if (lane == 0) {  // after its own stores: its arrive releases them
            hopper::mbar_arrive_expect_tx(&full[s], 2 * S::TILE);
#pragma unroll
            for (int c = 0; c < CH; ++c) {
              hopper::tma_load_3d(sq + s * S::TILE + c * BN * 128, &map_q, &full[s], 64 * c, q0,
                                  bh);
              hopper::tma_load_3d(sdo + s * S::TILE + c * BN * 128, &map_do, &full[s], 64 * c,
                                  q0, bh);
            }
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {  // consumers
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) % 4;
    const int wk0 = k0 + 64 * warpgroup;          // this warpgroup's first key
    const int wk_last = min(wk0 + 63, Sk - 1);    // and its last real one (< wk0 if none)
    const int row0 = wk0 + 16 * warp + lane / 4;  // this thread's keys: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and queries col0, col0 + 1 of each 8

    float dk_acc[D / 2], dv_acc[D / 2];  // [4j + 2i + c]: key row0 + 8i, column 8j + col0 + c
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dk_acc[n] = dv_acc[n] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    if (warpgroup == 1) wg::pass_turn(1);  // warpgroup 0 takes the first turn
    int i = 0;
    for (int r = 0; r < g; ++r) {
      for (int qt = qt_begin; qt < qt_end; ++qt, ++i) {
        const int s = i % STAGES;
        const int q0 = qt * BN;
        hopper::mbar_wait(&full[s], (i / STAGES) & 1);
        // A tile wholly masked for this warpgroup's keys (or a warpgroup
        // past Sk) only frees the stage.
        const bool skip = wk_last < wk0 || (causal && q0 + BN - 1 < wk0) ||
                          (window > 0 && q0 >= wk_last + window);
        wg::take_turn(warpgroup);
        if (skip) wg::pass_turn(warpgroup);
        if (!skip) {
          const uint32_t kw = hopper::opaque(hopper::smem_u32(sk) + warpgroup * 64 * 128);
          const uint32_t vw = hopper::opaque(hopper::smem_u32(sv) + warpgroup * 64 * 128);
          const uint32_t qs = hopper::opaque(hopper::smem_u32(sq) + s * S::TILE);
          const uint32_t dos = hopper::opaque(hopper::smem_u32(sdo) + s * S::TILE);
          // S^T and dP^T: [4j + 2i + c] is key row0 + 8i, query q0 + 8j + col0 + c.
          float st[BN / 2], dpt[BN / 2];
#pragma unroll
          for (int n = 0; n < BN / 2; ++n) st[n] = dpt[n] = 0.f;
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::Wgmma<BN, T>::template ss<0>(st, wg::kmajor<BM>(kw, kk),
                                                 wg::kmajor<BN>(qs, kk), kk > 0);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::Wgmma<BN, T>::template ss<0>(dpt, wg::kmajor<BM>(vw, kk),
                                                 wg::kmajor<BN>(dos, kk), kk > 0);
          hopper::wgmma_commit();
          wg::pass_turn(warpgroup);
          hopper::wgmma_wait<1>();  // S^T is in: P^T is computed while dP^T runs
          hopper::fence_regs(st);

          const bool masked = (causal && q0 < wk_last) ||
                              (window > 0 && q0 + BN - 1 >= wk0 + window) || q0 + BN > Sq;
          const float* rows = srows + s * 2 * BN;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + col0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = 4 * j + e;
              float p = hopper::exp2_approx(st[n] * scale_log2 - (e % 2 ? l2.y : l2.x));
              if (masked) {
                const int kpos = row0 + 8 * (e / 2);
                const int qpos = q0 + 8 * j + col0 + e % 2;
                bool keep = qpos < Sq;
                if (causal) keep = keep && kpos <= qpos;
                if (window > 0) keep = keep && kpos > qpos - window;
                if (!keep) p = 0.f;
              }
              st[n] = p;
            }
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 dl = *reinterpret_cast<const float2*>(rows + BN + 8 * j + col0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? dl.y : dl.x));  // dS^T
          }
          uint32_t pa[BN / 16][4], da[BN / 16][4];
          hopper::to_a_frags<T>(pa, st);
          hopper::to_a_frags<T>(da, dpt);

          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)  // 16 queries, 16 rows of the tiles' boxes, a step
            hopper::Wgmma<D, T>::template rs<1>(dv_acc, pa[kk], wg::mnmajor(dos, kk), 1);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            hopper::Wgmma<D, T>::template rs<1>(dk_acc, da[kk], wg::mnmajor(qs, kk), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
    }
    if (warpgroup == 0) wg::take_turn(0);  // the turn warpgroup 1 passed last

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kpos = row0 + 8 * rr;
      if (kpos > wk_last) continue;
      T* dkrow = dk + ((size_t)bkv * Sk + kpos) * D;
      T* dvrow = dv + ((size_t)bkv * Sk + kpos) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j + col0) =
            hopper::pack2<T>(dk_acc[4 * j + 2 * rr] * scale, dk_acc[4 * j + 2 * rr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j + col0) =
            hopper::pack2<T>(dv_acc[4 * j + 2 * rr], dv_acc[4 * j + 2 * rr + 1]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Sq, int Sk,
                int causal, int window, float scale, float scale_log2) {
  using wg::BM;
  using wg::BN;
  using wg::STAGES;
  using S = wg::Smem<D>;
  constexpr int CH = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;                   // Q: the block's 128 query rows
  uint8_t* sdo = sq + S::BIG;           // dO
  uint8_t* sk = sdo + S::BIG;           // K tile of stage s at sk + s * S::TILE
  uint8_t* sv = sk + STAGES * S::TILE;  // V tile of stage s
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sv + STAGES * S::TILE);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + STAGES;

  // Causal query tiles late in the sequence do the most work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int bkv = b * KV + h / (H / KV);
  const int q_last = min(q0 + BM, Sq) - 1;
  // The key tiles the forward visits: none above the diagonal, none before the window.
  const int nk = (Sk + BN - 1) / BN;
  const int kt_end = causal ? min(nk, q_last / BN + 1) : nk;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BN : 0;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(qd_full, 2 * S::BIG);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        hopper::tma_load_3d(sq + c * BM * 128, &map_q, qd_full, 64 * c, q0, bh);
        hopper::tma_load_3d(sdo + c * BM * 128, &map_do, qd_full, 64 * c, q0, bh);
      }
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin, s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * S::TILE);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          hopper::tma_load_3d(sk + s * S::TILE + c * BN * 128, &map_k, &full[s], 64 * c, kt * BN,
                              bkv);
          hopper::tma_load_3d(sv + s * S::TILE + c * BN * 128, &map_v, &full[s], 64 * c, kt * BN,
                              bkv);
        }
      }
    }
  } else {  // consumers
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) % 4;
    const int wq0 = q0 + 64 * warpgroup;          // this warpgroup's first query row
    const int wq_last = min(wq0 + 63, Sq - 1);    // and its last real one (< wq0 if none)
    const int row0 = wq0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and keys col0, col0 + 1 of each 8
    float lse2[2], dl[2];                         // rows past Sq: 0 (never stored)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < Sq ? lse[(size_t)bh * Sq + row] * wg::LOG2E : 0.f;
      dl[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }

    float acc[D / 2];  // dQ: acc[4j + 2i + c] is row row0 + 8i, column 8j + col0 + c
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;

    hopper::mbar_wait(qd_full, 0);
    if (warpgroup == 1) wg::pass_turn(1);  // warpgroup 0 takes the first turn
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int i = kt - kt_begin, s = i % STAGES;
      const int k0 = kt * BN;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      // A tile wholly masked for this warpgroup's rows (or a warpgroup past
      // Sq) only frees the stage.
      const bool skip = wq_last < wq0 || (causal && k0 > wq_last) ||
                        (window > 0 && k0 + BN - 1 <= wq0 - window);
      wg::take_turn(warpgroup);
      if (skip) wg::pass_turn(warpgroup);
      if (!skip) {
        const uint32_t qw = hopper::opaque(hopper::smem_u32(sq) + warpgroup * 64 * 128);
        const uint32_t dow = hopper::opaque(hopper::smem_u32(sdo) + warpgroup * 64 * 128);
        const uint32_t ks = hopper::opaque(hopper::smem_u32(sk) + s * S::TILE);
        const uint32_t vs = hopper::opaque(hopper::smem_u32(sv) + s * S::TILE);
        // S and dP: [4j + 2i + c] is row row0 + 8i, key k0 + 8j + col0 + c.
        float sc[BN / 2], dp[BN / 2];
#pragma unroll
        for (int n = 0; n < BN / 2; ++n) sc[n] = dp[n] = 0.f;
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<BN, T>::template ss<0>(sc, wg::kmajor<BM>(qw, kk),
                                               wg::kmajor<BN>(ks, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<BN, T>::template ss<0>(dp, wg::kmajor<BM>(dow, kk),
                                               wg::kmajor<BN>(vs, kk), kk > 0);
        hopper::wgmma_commit();
        wg::pass_turn(warpgroup);
        hopper::wgmma_wait<1>();  // S is in: P is computed while dP runs
        hopper::fence_regs(sc);

        const bool masked = (causal && k0 + BN - 1 > wq0) ||
                            (window > 0 && k0 <= wq_last - window) || k0 + BN > Sk;
#pragma unroll
        for (int n = 0; n < BN / 2; ++n) {
          const int r = (n / 2) % 2;
          float p = hopper::exp2_approx(sc[n] * scale_log2 - lse2[r]);
          if (masked) {
            const int qpos = row0 + 8 * r;
            const int kpos = k0 + 8 * (n / 4) + col0 + n % 2;
            bool keep = kpos < Sk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) p = 0.f;
          }
          sc[n] = p;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int n = 0; n < BN / 2; ++n) sc[n] *= dp[n] - dl[(n / 2) % 2];  // dS
        uint32_t da[BN / 16][4];
        hopper::to_a_frags<T>(da, sc);

        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys, 16 rows of K's boxes, a step
          hopper::Wgmma<D, T>::template rs<1>(acc, da[kk], wg::mnmajor(ks, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    if (warpgroup == 0) wg::take_turn(0);  // the turn warpgroup 1 passed last
    T* dqp = dq + (size_t)bh * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos > wq_last) continue;
      T* dqrow = dqp + (size_t)qpos * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqrow + 8 * j + col0) =
            hopper::pack2<T>(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv,
                         float* delta, int B, int H, int KV, int Sq, int Sk, int causal,
                         int window, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = wg::Smem<D>::BYTES;
  const uint64_t bh = (uint64_t)B * H, bkv = (uint64_t)B * KV;
  // dk/dv streams 64-row tiles of q and dO past 128-key blocks of k and v;
  // dq the other way round.
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  cudaError_t err = hopper::make_map_3d(&q64, q, bf16, D, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_map_3d(&do64, dout, bf16, D, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_map_3d(&k128, k, bf16, D, Sk, bkv, wg::BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&v128, v, bf16, D, Sk, bkv, wg::BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&q128, q, bf16, D, Sq, bh, wg::BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&do128, dout, bf16, D, Sq, bh, wg::BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&k64, k, bf16, D, Sk, bkv, wg::BN);
  if (err == cudaSuccess) err = hopper::make_map_3d(&v64, v, bf16, D, Sk, bkv, wg::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_wgmma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_wgmma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const float scale_log2 = scale * wg::LOG2E;

  err = launch_delta<T, D>(o, dout, delta, (long)B * H * Sq, stream);
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<T, D><<<dim3((Sk + wg::BM - 1) / wg::BM, KV, B), wg::THREADS, bytes, stream>>>(
      q64, k128, v128, do64, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, KV, Sq, Sk,
      causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<T, D><<<dim3((Sq + wg::BM - 1) / wg::BM, H, B), wg::THREADS, bytes, stream>>>(
      q128, k64, v64, do128, lse, delta, static_cast<T*>(dq), H, KV, Sq, Sk, causal, window, scale,
      scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, void* dq, void* dk, void* dv,
                           float* delta, int B, int H, int KV, int Sq, int Sk, int D, int causal,
                           int window, cudaStream_t stream) {
  if (D == 64)
    return launch_wgmma<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk,
                               causal, window, stream);
  if (D == 128)
    return launch_wgmma<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk,
                                causal, window, stream);
  return cudaErrorInvalidValue;
}

bool valid(int B, int H, int KV, int Sq, int Sk, int window) {
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && Sq >= 1 && Sk >= 1 && B <= 65535 &&
         H <= 65535 && window >= 0;
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D); lse, delta:
// (B, H, Sq) fp32, delta scratch the call overwrites.  Contiguous device
// arrays, 16-byte aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.  D: 64
// or 128.  Each entry point launches one tiling's three kernels on `stream`
// and returns a cudaError_t (0 on success); a shape or dtype its tiling does
// not take returns cudaErrorInvalidValue.

// Tensor cores; float16 or bfloat16.
extern "C" int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               void* dq, void* dk, void* dv, float* delta, int B,
                                               int H, int KV, int Sq, int Sk, int D, int causal,
                                               int window, int dtype, void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)launch_wgmma_d<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq,
                                         Sk, D, causal, window, s);
    case 2:
      return (int)launch_wgmma_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                                                KV, Sq, Sk, D, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any of the three dtypes.
extern "C" int repro_flash_attention_bwd_fma(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             void* dq, void* dk, void* dv, float* delta, int B,
                                             int H, int KV, int Sq, int Sk, int D, int causal,
                                             int window, int dtype, void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, D,
                                  causal, window, s);
    case 1:
      return (int)launch_d<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, D,
                                   causal, window, s);
    case 2:
      return (int)launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq,
                                          Sk, D, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
