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
// (window > 0).  Head dims 64, 80, 128 and 256, and 32 on the fma tiling
// (the twin of examples/train_lm_topoopt.py).  Rows that see no key are refused
// by the wrapper (kernels/flash_attention.py), so P never needs the
// forward's mean-of-v repair.
//
// Three kernels on one stream (at D = 80 on wgmma, below, the dq kernel's
// work is done by the dk/dv blocks and a cast), with no float atomics, so
// dq, dk and dv are the same bits from run to run: delta (one warp a row,
// delta = rowsum(dO o O));
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
// * wgmma (bf16/fp16; D = 64, 80, 128 or 256; every training step of the
//   card's bf16 models).  The dk/dv and dq kernels on the tensor cores, built like
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
//   At D = 80 (hubert-xlarge) the tiling has kernels of its own
//   (dkdv_d80_wgmma_kernel, dq_d80_cast_kernel) that run the math's 5
//   products at the true width: every tile is hopper.cuh's d80 layout (a
//   64-column box with the 128-byte swizzle beside a 16-column one with the
//   32-byte swizzle), so S and dP take 5 k16 steps and dV, dK and dQ run at
//   N = 64 + 16 (at a padded width of 128 the two kernels ran 7 products,
//   3 of them on 48 zero columns: 704 product columns where the bound
//   counts 400).  S and dP are computed once: the dk/dv blocks also form
//   dQ's partial dS K for each query tile they visit (dS^T goes through
//   shared memory, the MN-major A operand of a wgmma over the item's 128
//   keys) and add it in fp32 into scratch, (B*H, ceil(Sq / 64)*64, 80), the
//   items that see a query tile taking turns at it in a fixed order (a
//   counter a tile, zeroed on every call; the first turn stores, the rest
//   add by cp.reduce.async.bulk in L2), and dq_d80_cast_kernel scales and
//   casts the sums.  So each (query, key) pair costs one exp, and no float
//   atomics make the order vary.  The grid is persistent (a block an SM of
//   the card at most) and walks its items in order, and the items of a kv
//   head visit their tiles from staggered starts, so that the turns neither
//   wait on a block that has not started nor queue the items behind one
//   another (wg80 below).  Where the items, ceil(Sk / 128) x KV x B, are
//   fewer than the SMs (small GQA shapes), SMs stay idle.
//   At D = 256 (recurrentgemma-9b) that layout needs 256 KB of shared
//   memory and 256 accumulator registers a consumer thread, past the 227 KB
//   and the 240 of the setmaxnreg split.  So a block owns 64 keys (dk/dv)
//   or query rows (dq), both consumers compute S and dP for all 64 of them,
//   and each keeps the accumulator columns of one half of D (128: 64 + 64
//   registers for dK and dV, 64 for dQ), the dV, dK and dQ products running
//   at N = 128 on that half of the tiles' boxes: the 64/128 kernels'
//   register budget at 168, 194 KB of shared memory.  The price is S and dP
//   computed twice: 11 products where the math has 5.  With one kv head and
//   one sequence a block a key tile fills half the card (64 blocks at
//   S = 4096), so the dk/dv launch cuts a kv head's query heads into as
//   many splits as fill the SMs; each writes fp32 partials of dk and dv
//   (scratch from the wrapper) that a fourth kernel adds in a fixed order.
// * fma (fp32, fp16 or bf16; exact fp32 for the narrow fp32 models, which
//   TF32 would not give).  Thread (ty, tx) of a 16 x 16 grid owns query
//   rows 4ty .. 4ty+3 and keys tx + 16j of a 64 x 64 tile pair (2 rows of
//   32 x 32 tiles at D = 256, whose 64-row tiles would not fit); tiles are
//   staged in shared memory as fp32 (row stride D + 4), S and dP are fp32
//   FMAs on the CUDA cores, P and dS go through shared memory, and dV, dK
//   (key rows 4ty .. 4ty+3, columns 64c + 4tx .. +3) and dQ accumulate in
//   registers.  Keys past Sk and rows past Sq get P = 0.  At D = 80 a
//   thread's columns of dV, dK and dQ are 4tx .. +3 and, for tx < 4 only,
//   64 + 4tx .. +3 (the forward's column split); at D = 32 only threads
//   tx < 8 own columns, 4tx .. +3.
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
// the two recomputed products are the gap.  At D = 80 (tools/attn80_variants.py,
// medians of 5 rounds in turns, same card), hubert-xlarge's training shape
// (B = 4, H = KV = 16, S = 4096): 2.16-2.21 ms, 39-40% of its 0.8685 ms
// bound (cuDNN 2.35-2.43; at a padded width of 128 with 7 products, 2.69);
// with dq on a kernel of its own at the true width (7 products) 2.60-2.62;
// with each dQ partial formed in its own step, its consumer waiting for the
// other's half of dS^T, 2.29-2.45.  Without any of dQ's work the dk/dv
// items take 1.53-1.58 ms; the stores and hand-offs of dS^T and of the
// partials cost about 0.4 ms more and dQ's product about 0.2; the turns and
// the L2 adds nothing that shows.  With fewer items than SMs (B = 2, H = 16,
// KV = 4, S = 1000, causal: 64 items) 0.1385 ms, against 0.1283 with dq on
// a kernel of its own and 0.1335 at the padded width (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads

// The fma tiling's tiles: 64 query rows and 64 keys, 32 at D = 256, where
// 64-row fp32 tiles would take 294 KB of shared memory (as the forward's
// fma tiling cuts its tiles at D = 256).
template <int D> struct Fma {
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows of a tile
  static constexpr int BK = BQ;                  // keys of a tile
  static constexpr int RQ = BQ / 16;             // query rows a thread owns in S, dP and dQ
  static constexpr int KJ = BK / 16;             // keys a thread owns in S and dP
  static constexpr int RK = BK / 16;             // key rows a thread owns in dK and dV
  static constexpr int LDP = BK + 4;             // row stride of the P and dS tiles, in floats
};
// Blocks of the dk/dv and dq kernels a launch asks of an SM (the shared
// memory of a block: 72 and 55 KB at D = 32, 104 and 87 KB at D = 64, 119 and
// 102 KB at D = 80, 170 and 153 KB at D = 128, 139 and 135 KB at D = 256),
// which sets the register budget ptxas is given: 128 a thread at 2, 255 at
// 1.  The dk/dv kernel at D = 32 spills at 128 (its column guard, which
// D = 64 compiles out), so it asks for 1.
#define DKDV_BLOCKS_PER_SM(D) ((D) == 64 ? 2 : 1)
#define DQ_BLOCKS_PER_SM(D) ((D) <= 64 ? 2 : 1)

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
  using F = Fma<D>;
  return (2 * (F::BK + F::BQ) * (D + 4) + 2 * F::BQ * F::LDP + 2 * F::BQ) * (int)sizeof(float);
}

template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, K, V tiles; dS; lse, delta
  using F = Fma<D>;
  return (2 * (F::BK + F::BQ) * (D + 4) + F::BQ * F::LDP + 2 * F::BQ) * (int)sizeof(float);
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
template <int BQ>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int tid) {
  if (tid < BQ) dst[tid] = row0 + tid < rows ? src[row0 + tid] : 0.f;
}

// acc[i][j] = a[RQ*ty + i] . b[tx + 16*j] over D, for two (rows, D) tiles in
// shared memory with row stride D + 4.
template <int D, int RQ = Fma<D>::RQ, int KJ = Fma<D>::KJ>
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
  constexpr int RQ = Fma<D>::RQ, KJ = Fma<D>::KJ, LDP = Fma<D>::LDP;
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
__global__ void __launch_bounds__(THREADS, DKDV_BLOCKS_PER_SM(D))
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
            int KV, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int BQ = Fma<D>::BQ, BK = Fma<D>::BK, RK = Fma<D>::RK, LDP = Fma<D>::LDP;
  constexpr int LD = D + 4;
  constexpr int NC = (D + 63) / 64;  // groups of 4 columns a thread owns in dK and dV
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
      load_rows<BQ>(sLse, lse + bh * Sq, q0, Sq, tid);
      load_rows<BQ>(sDelta, delta + bh * Sq, q0, Sq, tid);
      __syncthreads();
      p_and_ds<D>(sP, sdS, sQ, sK, sdO, sV, sLse, sDelta, q0, k0, Sq, Sk, causal, window, scale,
                  ty, tx);
      __syncthreads();
      // dV[kr][c] += sum_i P[i][kr] dO[i][c];  dK[kr][c] += sum_i dS[i][kr] Q[i][c]
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pr[RK], sr[RK];
        if constexpr (RK == 4) {
          const float4 pv = *reinterpret_cast<const float4*>(sP + i * LDP + RK * ty);
          const float4 sv = *reinterpret_cast<const float4*>(sdS + i * LDP + RK * ty);
          pr[0] = pv.x, pr[1] = pv.y, pr[2] = pv.z, pr[3] = pv.w;
          sr[0] = sv.x, sr[1] = sv.y, sr[2] = sv.z, sr[3] = sv.w;
        } else {  // RK == 2 (D = 256)
          const float2 pv = *reinterpret_cast<const float2*>(sP + i * LDP + RK * ty);
          const float2 sv = *reinterpret_cast<const float2*>(sdS + i * LDP + RK * ty);
          pr[0] = pv.x, pr[1] = pv.y;
          sr[0] = sv.x, sr[1] = sv.y;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (D % 64 != 0 && 64 * c + 4 * tx >= D) continue;  // columns past D
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
    for (int c = 0; c < NC; ++c) {
      if (D % 64 != 0 && 64 * c + 4 * tx >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkrow[64 * c + 4 * tx + e] = from_float<T>(dk_acc[kk][4 * c + e] * scale);
        dvrow[64 * c + 4 * tx + e] = from_float<T>(dv_acc[kk][4 * c + e]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, DQ_BLOCKS_PER_SM(D))
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Sq, int Sk,
          int causal, int window, float scale) {
  constexpr int BQ = Fma<D>::BQ, BK = Fma<D>::BK, RQ = Fma<D>::RQ, LDP = Fma<D>::LDP;
  constexpr int LD = D + 4;
  constexpr int NC = (D + 63) / 64;  // groups of 4 columns a thread owns in dQ
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
  load_rows<BQ>(sLse, lse + bh * Sq, q0, Sq, tid);
  load_rows<BQ>(sDelta, delta + bh * Sq, q0, Sq, tid);

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
          if (D % 64 != 0 && 64 * c + 4 * tx >= D) continue;  // columns past D
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
    for (int c = 0; c < NC; ++c) {
      if (D % 64 != 0 && 64 * c + 4 * tx >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dqrow[64 * c + 4 * tx + e] = from_float<T>(acc[i][4 * c + e] * scale);
    }
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
  constexpr int BQ = Fma<D>::BQ, BK = Fma<D>::BK;
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
  if (D == 32)
    return launch<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                         window, stream);
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                         window, stream);
  if (D == 80)
    return launch<T, 80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                         window, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                          window, stream);
  if (D == 256)
    return launch<T, 256>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, causal,
                          window, stream);
  return cudaErrorInvalidValue;
}

// wgmma tiling.

namespace wg {
constexpr int BN = 64;   // rows of a streamed tile: queries (dk/dv) or keys (dq)
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr float LOG2E = 1.4426950408889634f;


// How a block's two consumer warpgroups share its work.  At D = 64 and 128
// the block owns 128 keys (dk/dv) or query rows (dq), 64 a consumer, and
// each consumer keeps all D columns of its accumulators.  At D = 256 that
// would take 256 accumulator registers a thread and 256 KB of shared
// memory, so the block owns 64 rows, both consumers compute S and dP for
// all 64 (the same products, twice), and each keeps D / 2 = 128 of the
// accumulators' columns: 128 registers, 194 KB.
template <int D> struct Cfg {
  static constexpr bool SPLIT = D == 256;
  static constexpr int BM = SPLIT ? 64 : 128;  // the block's keys (dk/dv) or query rows (dq)
  static constexpr int NW = SPLIT ? D / 2 : D;  // accumulator columns a consumer owns
};

template <int D> struct Smem {
  static constexpr int BIG = Cfg<D>::BM * D * 2;  // the block's operand: D / 64 boxes of BM x 128
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
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  float* __restrict__ part, int H, int KV, int Sq, int Sk, int causal, int window,
                  int heads_per, float scale, float scale_log2) {
  using wg::BN;
  using wg::STAGES;
  using S = wg::Smem<D>;
  using C = wg::Cfg<D>;
  constexpr int BM = C::BM;
  constexpr int NW = C::NW;
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
  // blockIdx.y: the kv head and the group's query heads [r_begin, r_end) this
  // block sums, in order (all g but at D = 256, where the launch may split
  // them into partials that dkdv_sum_kernel adds in a fixed order).
  const int g = H / KV;
  const int splits = (g + heads_per - 1) / heads_per;
  const int kvh = blockIdx.y / splits;
  const int split = blockIdx.y % splits;
  const int r_begin = split * heads_per;
  const int r_end = min(g, r_begin + heads_per);
  const int b = blockIdx.z;
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
      for (int r = r_begin; r < r_end; ++r) {  // the group's query heads, in order
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
    const int wk0 = k0 + (C::SPLIT ? 0 : 64 * warpgroup);  // this warpgroup's first key
    const int wk_last = min(wk0 + 63, Sk - 1);    // and its last real one (< wk0 if none)
    const int row0 = wk0 + 16 * warp + lane / 4;  // this thread's keys: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and queries col0, col0 + 1 of each 8
    const int wcol = C::SPLIT ? NW * warpgroup : 0;  // the first dK, dV column it owns

    // [4j + 2i + c]: key row0 + 8i, column wcol + 8j + col0 + c
    float dk_acc[NW / 2], dv_acc[NW / 2];
#pragma unroll
    for (int n = 0; n < NW / 2; ++n) dk_acc[n] = dv_acc[n] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    if (warpgroup == 1) wg::pass_turn(1);  // warpgroup 0 takes the first turn
    int i = 0;
    for (int r = r_begin; r < r_end; ++r) {
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
          const uint32_t wrow = C::SPLIT ? 0 : warpgroup * 64 * 128;  // its keys' first row
          const uint32_t kw = hopper::opaque(hopper::smem_u32(sk) + wrow);
          const uint32_t vw = hopper::opaque(hopper::smem_u32(sv) + wrow);
          const uint32_t qs = hopper::opaque(hopper::smem_u32(sq) + s * S::TILE);
          const uint32_t dos = hopper::opaque(hopper::smem_u32(sdo) + s * S::TILE);
          const uint32_t wbox = (wcol / 64) * BN * 128;  // its columns' first box of a tile
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
            hopper::Wgmma<NW, T>::template rs<1>(dv_acc, pa[kk], wg::mnmajor(dos + wbox, kk), 1);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            hopper::Wgmma<NW, T>::template rs<1>(dk_acc, da[kk], wg::mnmajor(qs + wbox, kk), 1);
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
      if (part != nullptr) {  // this block's heads' partial sums, fp32 and unscaled
        const size_t n = (size_t)gridDim.z * KV * Sk * D;  // one partial of dk
        const size_t at = split * n + ((size_t)bkv * Sk + kpos) * D + wcol;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          *reinterpret_cast<float2*>(part + at + 8 * j + col0) =
              make_float2(dk_acc[4 * j + 2 * rr], dk_acc[4 * j + 2 * rr + 1]);
          *reinterpret_cast<float2*>(part + splits * n + at + 8 * j + col0) =
              make_float2(dv_acc[4 * j + 2 * rr], dv_acc[4 * j + 2 * rr + 1]);
        }
        continue;
      }
      T* dkrow = dk + ((size_t)bkv * Sk + kpos) * D + wcol;
      T* dvrow = dv + ((size_t)bkv * Sk + kpos) * D + wcol;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j + col0) =
            hopper::pack2<T>(dk_acc[4 * j + 2 * rr] * scale, dk_acc[4 * j + 2 * rr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j + col0) =
            hopper::pack2<T>(dv_acc[4 * j + 2 * rr], dv_acc[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// dk and dv from dkdv_wgmma_kernel's partials (`splits` of them, each the
// sum over its block's query heads): added in order, dk scaled, rounded
// once to T.  n is the elements of dk (and of dv).
template <typename T>
__global__ void __launch_bounds__(256)
dkdv_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                int splits, size_t n, float scale) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= n) return;
  float sk = 0.f, sv = 0.f;
  for (int p = 0; p < splits; ++p) {
    sk += part[p * n + idx];
    sv += part[(splits + p) * n + idx];
  }
  dk[idx] = from_float<T>(sk * scale);
  dv[idx] = from_float<T>(sv);
}

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Sq, int Sk,
                int causal, int window, float scale, float scale_log2) {
  using wg::BN;
  using wg::STAGES;
  using S = wg::Smem<D>;
  using C = wg::Cfg<D>;
  constexpr int BM = C::BM;
  constexpr int NW = C::NW;
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
    const int wq0 = q0 + (C::SPLIT ? 0 : 64 * warpgroup);  // this warpgroup's first query row
    const int wq_last = min(wq0 + 63, Sq - 1);    // and its last real one (< wq0 if none)
    const int row0 = wq0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and keys col0, col0 + 1 of each 8
    const int wcol = C::SPLIT ? NW * warpgroup : 0;  // the first dQ column it owns
    float lse2[2], dl[2];                         // rows past Sq: 0 (never stored)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < Sq ? lse[(size_t)bh * Sq + row] * wg::LOG2E : 0.f;
      dl[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }

    float acc[NW / 2];  // dQ: acc[4j + 2i + c] is row row0 + 8i, column wcol + 8j + col0 + c
#pragma unroll
    for (int n = 0; n < NW / 2; ++n) acc[n] = 0.f;

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
        const uint32_t wrow = C::SPLIT ? 0 : warpgroup * 64 * 128;  // its rows' first
        const uint32_t qw = hopper::opaque(hopper::smem_u32(sq) + wrow);
        const uint32_t dow = hopper::opaque(hopper::smem_u32(sdo) + wrow);
        const uint32_t ks = hopper::opaque(hopper::smem_u32(sk) + s * S::TILE);
        const uint32_t vs = hopper::opaque(hopper::smem_u32(sv) + s * S::TILE);
        const uint32_t wbox = (wcol / 64) * BN * 128;  // its columns' first box of a tile
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
          hopper::Wgmma<NW, T>::template rs<1>(acc, da[kk], wg::mnmajor(ks + wbox, kk), 1);
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
      T* dqrow = dqp + (size_t)qpos * D + wcol;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqrow + 8 * j + col0) =
            hopper::pack2<T>(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ------------------------------------------------------------ head dim 80
//
// Products at the true width (hopper.cuh's d80 layout: a 64-column box with
// the 128-byte swizzle beside a 16-column box with the 32-byte one), and S
// and dP computed once: the dk/dv blocks also form dQ's partial dS K for
// each query tile and add it, in fp32, into a (B*H, M*64, 80) buffer (M =
// ceil(Sq / 64) query tiles a head), the key blocks of a query tile taking
// turns in a fixed order; a last pass scales and casts it (dq_d80_cast_kernel).
// That takes one block an SM at most.
namespace wg80 {
constexpr int BM = 128;  // keys of an item
constexpr int STAGES = 2;  // (Q, dO) tiles in the ring
constexpr int BIG = BM * hopper::d80::ROW_BYTES;      // K or V of an item
constexpr int TILE = wg::BN * hopper::d80::ROW_BYTES;  // a streamed 64-row tile
constexpr int ROWS = 2 * wg::BN * 4;                 // a query tile's lse and delta
constexpr int DS = BM * 128;                          // dS^T of a step: 128 keys x 64 queries
constexpr int DQP = wg::BN * 80 * 4;                 // dQ's fp32 partial of a step
// Shared memory of the dk/dv kernel.
constexpr int DKDV_BYTES = 2 * BIG + STAGES * (2 * TILE + ROWS) + 2 * (DS + DQP) +
                           8 * (2 + 2 * STAGES + 8) + 1024;

// The query tiles a key item sees and the order it walks them in: tiles
// [lo, lo + len) (none above its keys under the causal mask, none past the
// window of its last key), starting at lo + rot and wrapping.  Without a
// causal mask every item would start at tile 0 and queue behind the others
// at every tile's turn, so the items of a kv head start at staggered tiles
// (stagger: when every item of a kv head is in flight at once, below).
struct Walk {
  int lo, len, rot;
};
__device__ __forceinline__ Walk walk_of(int n, int N, int M, int Sk, int causal, int window,
                                        bool stagger) {
  const int k0 = n * BM, k_last = min(k0 + BM, Sk) - 1;
  const int lo = causal ? min(M, k0 / wg::BN) : 0;
  const int hi = window > 0 ? min(M, (k_last + window - 1) / wg::BN + 1) : M;
  const int len = max(0, hi - lo);
  const int rot = stagger && !causal && len > 0 ? n * len / N : 0;  // n * len < 2^31
  return Walk{lo, len, rot};
}

// Item n's turn at query tile m of query head r of its group: how many of
// the N items of its kv head add their partial of that tile before it.
// The items that see the tile add in the order of the step at which their
// walks reach it (ties: n), which is the order they reach it in when their
// walks are staggered; else in the order of n, so that an item only waits
// for items of lower index, taken before it.  Computed by a warp.
__device__ __forceinline__ int turn_of(int n, int r, int m, int N, int M, int Sk, int causal,
                                       int window, bool stagger, int lane) {
  const Walk w = walk_of(n, N, M, Sk, causal, window, stagger);
  const int step = r * w.len + (m - w.lo - w.rot + 2 * w.len) % max(w.len, 1);
  int before = 0;
  for (int n2 = lane; n2 < N; n2 += 32) {
    if (n2 == n) continue;
    const Walk w2 = walk_of(n2, N, M, Sk, causal, window, stagger);
    if (m < w2.lo || m >= w2.lo + w2.len) continue;
    if (!stagger) {
      before += n2 < n;
    } else {
      const int step2 = r * w2.len + (m - w2.lo - w2.rot + 2 * w2.len) % w2.len;
      before += step2 < step || (step2 == step && n2 < n);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xffffffffu, before, off);
  return before;
}
// What a consumer reads to form dQ's partials.
struct DqArgs {
  uint8_t *sds, *sk, *sdq;
  uint64_t *ds_full, *ds_empty, *dq_empty, *dq_full;
  int warp, lane, col0;
};

// dQ's partial of step k, by consumer k % 2: dS (both halves of dS^T in
// buffer k % 2) times the item's K, 128 keys, stored as fp32 rows of 80
// (the layout of dq_acc's tile) for writer warp 1 + k % 2.
template <typename T>
__device__ __forceinline__ void dq_partial(const DqArgs& a, int k) {
  const int buf = k % 2;
  float dq[40];
  hopper::mbar_wait(&a.ds_full[buf], (k / 2) & 1);
  hopper::mbar_wait(&a.dq_empty[buf], ((k / 2) & 1) ^ 1);
  const uint32_t dsa = hopper::opaque(hopper::smem_u32(a.sds + buf * DS));
  const uint32_t kb = hopper::opaque(hopper::smem_u32(a.sk));
  hopper::fence_regs(dq);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)  // 16 keys, 16 rows of dS^T and K, a step
    hopper::d80::ss<T, BM, 1>(dq, hopper::desc_sw128(dsa + kk * 2048, DS, 1024), kb, kk, kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  __syncwarp();
  if (a.lane == 0) hopper::mbar_arrive(&a.ds_empty[buf]);  // dS^T read
  float* part = reinterpret_cast<float*>(a.sdq + buf * DQP);
  const int qr = 16 * a.warp + a.lane / 4;
#pragma unroll
  for (int jj = 0; jj < 10; ++jj)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(part + (qr + 8 * rr) * 80 + 8 * jj + a.col0) =
          make_float2(dq[4 * jj + 2 * rr], dq[4 * jj + 2 * rr + 1]);
  hopper::fence_async_shared();
  __syncwarp();
  if (a.lane == 0) hopper::mbar_arrive(&a.dq_full[buf]);
}
}  // namespace wg80

// One item is a key block of BM = 128 keys of one kv head and batch row; the
// grid is persistent (at most one block an SM), block x taking items x,
// x + gridDim.x, ..., so that with every item of a kv head in flight the
// turns below cannot wait on an item that has not started.  Warpgroups as
// dkdv_wgmma_kernel's (two consumers of 64 keys, a producer); the producer's
// warp 0 streams (Q, dO) tiles and their lse and delta, and its warps 1
// and 2 write dQ: each consumer step also stores dS^T (16-bit, the
// 128-byte swizzle) into shared memory, and at step i consumer i % 2 forms
// dQ's partial dS K (wgmma, A = dS MN-major, B = K MN-major, 128 keys) and
// stores it as fp32 for writer warp 1 + i % 2, which waits for its item's
// turn at the tile (a counter a tile in `turns`, acquire), copies the
// partial into dq_acc (the first turn) or adds it there (cp.reduce.async.bulk
// .add.f32, in L2), waits for the write to complete and passes the turn
// (release).
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
dkdv_d80_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_q16,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_k16,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_v16,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_do16, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dq_acc, int* __restrict__ turns, int B, int H, int KV,
                      int Sq, int Sk, int causal, int window, float scale, float scale_log2) {
  using wg::BN;
  using wg80::BM;
  using wg80::STAGES;
  namespace d80 = hopper::d80;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sk = smem;                          // K: the item's 128 keys
  uint8_t* sv = sk + wg80::BIG;                // V
  uint8_t* sq = sv + wg80::BIG;                // Q tile of stage s at sq + s * TILE
  uint8_t* sdo = sq + STAGES * wg80::TILE;     // dO tile of stage s
  uint8_t* sds = sdo + STAGES * wg80::TILE;    // dS^T of step i at sds + (i % 2) * DS
  uint8_t* sdq = sds + 2 * wg80::DS;           // dQ's partial of step i at sdq + (i % 2) * DQP
  float* srows = reinterpret_cast<float*>(sdq + 2 * wg80::DQP);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(srows + STAGES * 2 * BN);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dq_full = empty + STAGES;  // [2]
  uint64_t* dq_empty = dq_full + 2;    // [2]
  uint64_t* ds_full = dq_empty + 2;    // [2]
  uint64_t* ds_empty = ds_full + 2;    // [2]

  const int g = H / KV;
  const int N = (Sk + BM - 1) / BM;  // items of a kv head
  const int M = (Sq + BN - 1) / BN;  // query tiles of a head
  const int items = N * KV * B;
  const bool stagger = N <= (int)gridDim.x;
  const int warpgroup = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, 8);  // one arrive per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's 32 lanes, one with the TMA bytes
      hopper::mbar_init(&empty[s], 8);
    }
    for (int b2 = 0; b2 < 2; ++b2) {
      hopper::mbar_init(&dq_full[b2], 4);  // the warps of the consumer that formed the partial
      hopper::mbar_init(&dq_empty[b2], 1);
      hopper::mbar_init(&ds_full[b2], 8);   // both consumers' warps, their halves of dS^T stored
      hopper::mbar_init(&ds_empty[b2], 4);  // the warps of the consumer whose dQ product read it
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer: 56 registers (the writers' turn arithmetic), 224 a consumer
    hopper::regs_dealloc<56>();
    const int pwarp = (threadIdx.x / 32) % 4;
    if (pwarp == 0) {  // loads
      int i = 0, ic = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++ic) {
        const int n = it % N, kvh = (it / N) % KV, b = it / (N * KV);
        const int bkv = b * KV + kvh;
        const wg80::Walk w = wg80::walk_of(n, N, M, Sk, causal, window, stagger);
        hopper::mbar_wait(kv_empty, (ic & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(kv_full, 2 * wg80::BIG);
          d80::load<BM>(sk, &map_k, &map_k16, kv_full, n * BM, bkv);
          d80::load<BM>(sv, &map_v, &map_v16, kv_full, n * BM, bkv);
        }
        for (int j = 0; j < g * w.len; ++j, ++i) {
          const int bh = bkv * g + j / w.len;
          const int q0 = (w.lo + (j % w.len + w.rot) % w.len) * BN;
          const int s = i % STAGES;
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
            hopper::mbar_arrive_expect_tx(&full[s], 2 * wg80::TILE);
            d80::load<BN>(sq + s * wg80::TILE, &map_q, &map_q16, &full[s], q0, bh);
            d80::load<BN>(sdo + s * wg80::TILE, &map_do, &map_do16, &full[s], q0, bh);
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    } else if (pwarp <= 2) {  // dQ's writers: warp 1 the even steps, warp 2 the odd
      const int mine = pwarp - 1;
      int i = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int n = it % N, kvh = (it / N) % KV, b = it / (N * KV);
        const wg80::Walk w = wg80::walk_of(n, N, M, Sk, causal, window, stagger);
        for (int j = 0; j < g * w.len; ++j, ++i) {
          if (i % 2 != mine) continue;
          const int r = j / w.len;
          const int m = w.lo + (j % w.len + w.rot) % w.len;
          const int bh = (b * KV + kvh) * g + r;
          const int turn = wg80::turn_of(n, r, m, N, M, Sk, causal, window, stagger, lane);
          int* counter = turns + (size_t)bh * M + m;
          hopper::mbar_wait(&dq_full[mine], (i / 2) & 1);
          if (lane == 0) {
            while (hopper::ld_acquire(counter) != turn) {
            }
            hopper::fence_async_global();
            float* dst = dq_acc + ((size_t)bh * M + m) * BN * 80;
            if (turn == 0)
              hopper::bulk_store(dst, sdq + mine * wg80::DQP, wg80::DQP);
            else
              hopper::bulk_add_f32(dst, sdq + mine * wg80::DQP, wg80::DQP);
            hopper::bulk_commit();
            hopper::bulk_wait<0>();
            hopper::fence_async_global();
            hopper::red_release_add(counter, 1);
            hopper::mbar_arrive(&dq_empty[mine]);
          }
          __syncwarp();
        }
      }
    }
  } else {  // consumers
    hopper::regs_alloc<224>();
    const int warp = (threadIdx.x / 32) % 4;
    const int col0 = 2 * (lane % 4);  // this thread's queries col0, col0 + 1 of each 8
    const wg80::DqArgs dqa{sds,      sk,       sdq,  ds_full, ds_empty,
                           dq_empty, dq_full,  warp, lane,    col0};
    if (warpgroup == 1) wg::pass_turn(1);  // warpgroup 0 takes the first turn
    int i = 0, ic = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++ic) {
      const int n = it % N, kvh = (it / N) % KV, b = it / (N * KV);
      const int bkv = b * KV + kvh;
      const wg80::Walk w = wg80::walk_of(n, N, M, Sk, causal, window, stagger);
      const int i0 = i;                              // the item's first step
      const int wk0 = n * BM + 64 * warpgroup;      // this warpgroup's first key
      const int wk_last = min(wk0 + 63, Sk - 1);    // and its last real one (< wk0 if none)
      const int row0 = wk0 + 16 * warp + lane / 4;  // this thread's keys: row0 and row0 + 8
      // [4j + 2i + c]: key row0 + 8i, column 8j + col0 + c
      float dk_acc[40], dv_acc[40];
#pragma unroll
      for (int e = 0; e < 40; ++e) dk_acc[e] = dv_acc[e] = 0.f;
      hopper::mbar_wait(kv_full, ic & 1);
      for (int j = 0; j < g * w.len; ++j, ++i) {
        const int s = i % STAGES;
        const int q0 = (w.lo + (j % w.len + w.rot) % w.len) * BN;
        hopper::mbar_wait(&full[s], (i / STAGES) & 1);
        // A tile wholly masked for this warpgroup's keys (or a warpgroup
        // past Sk) computes nothing; its rows of dS^T are 0.
        const bool skip = wk_last < wk0 || (causal && q0 + BN - 1 < wk0) ||
                          (window > 0 && q0 >= wk_last + window);
        const uint32_t qs = hopper::opaque(hopper::smem_u32(sq) + s * wg80::TILE);
        const uint32_t dos = hopper::opaque(hopper::smem_u32(sdo) + s * wg80::TILE);
        uint8_t* ds_tile = sds + (i % 2) * wg80::DS;  // this step's dS^T
        wg::take_turn(warpgroup);
        if (skip) {
          wg::pass_turn(warpgroup);
          hopper::mbar_wait(&ds_empty[i % 2], ((i / 2) & 1) ^ 1);  // its 64 rows of dS^T are 0
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint4*>(ds_tile + warpgroup * 64 * 128 + (threadIdx.x % 128) * 64 +
                                      16 * e) = make_uint4(0, 0, 0, 0);
        } else {
          const uint32_t kw = hopper::opaque(hopper::smem_u32(sk));
          const uint32_t vw = hopper::opaque(hopper::smem_u32(sv));
          // S^T and dP^T: [4j + 2i + c] is key row0 + 8i, query q0 + 8j + col0 + c.
          float st[BN / 2], dpt[BN / 2];
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 5; ++kk)
            hopper::Wgmma<BN, T>::template ss<0>(st, d80::kmajor<BM>(kw, 64 * warpgroup, kk),
                                                 d80::kmajor<BN>(qs, 0, kk), kk > 0);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < 5; ++kk)
            hopper::Wgmma<BN, T>::template ss<0>(dpt, d80::kmajor<BM>(vw, 64 * warpgroup, kk),
                                                 d80::kmajor<BN>(dos, 0, kk), kk > 0);
          hopper::wgmma_commit();
          wg::pass_turn(warpgroup);
          hopper::wgmma_wait<1>();  // S^T is in: P^T is computed while dP^T runs
          hopper::fence_regs(st);

          const bool masked = (causal && q0 < wk_last) ||
                              (window > 0 && q0 + BN - 1 >= wk0 + window) || q0 + BN > Sq;
          const float* rows = srows + s * 2 * BN;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
            const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * jj + col0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int nn = 4 * jj + e;
              float p = hopper::exp2_approx(st[nn] * scale_log2 - (e % 2 ? l2.y : l2.x));
              if (masked) {
                const int kpos = row0 + 8 * (e / 2);
                const int qpos = q0 + 8 * jj + col0 + e % 2;
                bool keep = qpos < Sq;
                if (causal) keep = keep && kpos <= qpos;
                if (window > 0) keep = keep && kpos > qpos - window;
                if (!keep) p = 0.f;
              }
              st[nn] = p;
            }
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dpt);
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
            const float2 dl = *reinterpret_cast<const float2*>(rows + BN + 8 * jj + col0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e % 2 ? dl.y : dl.x));
          }
          uint32_t pa[BN / 16][4], da[BN / 16][4];
          hopper::to_a_frags<T>(pa, st);
          hopper::to_a_frags<T>(da, dpt);
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)  // 16 queries, 16 rows of the tiles, a step
            d80::rs<T, BN>(dv_acc, pa[kk], dos, kk, 1);
          // While dV runs, dS^T into shared memory (before dK's product
          // reads da): key row kr of the item's 128, 64 queries in 128 bytes
          // with the 128-byte swizzle (16-byte chunk c at c ^ (kr % 8)), the
          // MN-major A operand of dQ = dS K, once the dQ product of two steps
          // back has read the buffer.
          hopper::mbar_wait(&ds_empty[i % 2], ((i / 2) & 1) ^ 1);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kr = 64 * warpgroup + 16 * warp + lane / 4 + 8 * (e % 2);
              const int chunk = 2 * kk + e / 2;  // the queries' 8-column group
              *reinterpret_cast<uint32_t*>(ds_tile + kr * 128 + ((chunk ^ (kr % 8)) * 16) +
                                           col0 * 2) = da[kk][e];
            }
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) d80::rs<T, BN>(dk_acc, da[kk], qs, kk, 1);
          hopper::wgmma_commit();
        }
        // This warpgroup's half of dS^T is in.  dQ's partial of step k is
        // formed by consumer k % 2 at step k + 1: a step late, when the other
        // consumer's half has long been stored, so that neither waits for the
        // other.
        hopper::fence_async_shared();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&ds_full[i % 2]);
        if (i > i0 && (i - 1) % 2 == warpgroup) wg80::dq_partial<T>(dqa, i - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      if (i > i0 && (i - 1) % 2 == warpgroup)
        wg80::dq_partial<T>(dqa, i - 1);  // the item's last step, before K is released
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(kv_empty);  // K and V read for the last time
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kpos = row0 + 8 * rr;
        if (kpos > wk_last) continue;
        T* dkrow = dk + ((size_t)bkv * Sk + kpos) * 80;
        T* dvrow = dv + ((size_t)bkv * Sk + kpos) * 80;
#pragma unroll
        for (int jj = 0; jj < 10; ++jj) {
          *reinterpret_cast<uint32_t*>(dkrow + 8 * jj + col0) = hopper::pack2<T>(
              dk_acc[4 * jj + 2 * rr] * scale, dk_acc[4 * jj + 2 * rr + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvrow + 8 * jj + col0) =
              hopper::pack2<T>(dv_acc[4 * jj + 2 * rr], dv_acc[4 * jj + 2 * rr + 1]);
        }
      }
    }
    if (warpgroup == 0) wg::take_turn(0);  // the turn warpgroup 1 passed last
  }
}

// dq from dq_acc's fp32 sums: scaled once and rounded to T, 8 values a thread.
template <typename T>
__global__ void __launch_bounds__(256)
dq_d80_cast_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq, long rows, int Sq, int M,
                   float scale) {
  const long idx = (long)blockIdx.x * 256 + threadIdx.x;  // 8 values of row idx / 10
  if (idx >= rows * 10) return;
  const long row = idx / 10, bh = row / Sq;
  const float* src = dq_acc + ((bh * M * wg::BN + row % Sq) * 80 + (idx % 10) * 8);
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 c = *reinterpret_cast<const float4*>(src + 4);
  uint4 out;
  out.x = hopper::pack2<T>(a.x * scale, a.y * scale);
  out.y = hopper::pack2<T>(a.z * scale, a.w * scale);
  out.z = hopper::pack2<T>(c.x * scale, c.y * scale);
  out.w = hopper::pack2<T>(c.z * scale, c.w * scale);
  *reinterpret_cast<uint4*>(dq + idx * 8) = out;
}

// Scratch of the D = 80 wgmma backward: a turn counter a query tile
// (rounded up to 256 bytes), then dq_acc, (B*H, M*64, 80) fp32.
long long d80_workspace(int B, int H, int Sq) {
  const long long tiles = (long long)B * H * ((Sq + wg::BN - 1) / wg::BN);
  return (tiles * 4 + 255) / 256 * 256 + tiles * wg::BN * 80 * 4;
}

template <typename T>
cudaError_t launch_wgmma80(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, void* dq, void* dk, void* dv,
                           float* delta, float* work, int B, int H, int KV, int Sq, int Sk,
                           int causal, int window, int sms, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const uint64_t bh = (uint64_t)B * H, bkv = (uint64_t)B * KV;
  // The dk/dv items stream 64-row tiles of q and dO past 128 keys of k and v.
  CUtensorMap q64, q64n, do64, do64n, k_big, k_bign, v_big, v_bign;
  cudaError_t err = hopper::make_maps_d80(&q64, &q64n, q, bf16, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_maps_d80(&do64, &do64n, dout, bf16, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_maps_d80(&k_big, &k_bign, k, bf16, Sk, bkv, wg80::BM);
  if (err == cudaSuccess) err = hopper::make_maps_d80(&v_big, &v_bign, v, bf16, Sk, bkv, wg80::BM);
  if (err != cudaSuccess) return err;
  if (work == nullptr) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(80.f);
  const float scale_log2 = scale * wg::LOG2E;
  const int M = (Sq + wg::BN - 1) / wg::BN;
  // At most one block an SM (the card's, whatever `sms` says), so that every
  // block is resident and the turns cannot wait on one that is not.
  int device, card_sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&card_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long items = (long)((Sk + wg80::BM - 1) / wg80::BM) * KV * B;
  const int grid = (int)std::min<long>(items, std::min(sms, card_sms));

  err = launch_delta<T, 80>(o, dout, delta, (long)B * H * Sq, stream);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * H * M;
  int* turns = reinterpret_cast<int*>(work);
  float* dq_acc =
      reinterpret_cast<float*>(reinterpret_cast<char*>(work) + (tiles * 4 + 255) / 256 * 256);
  err = cudaMemsetAsync(turns, 0, tiles * 4, stream);  // every call: the turns start at 0
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_d80_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, wg80::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  dkdv_d80_wgmma_kernel<T><<<grid, wg::THREADS, wg80::DKDV_BYTES, stream>>>(
      q64, q64n, k_big, k_bign, v_big, v_bign, do64, do64n, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), dq_acc, turns, B, H, KV, Sq, Sk, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long rows = (long)B * H * Sq;
  dq_d80_cast_kernel<T><<<(unsigned)((rows * 10 + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), rows, Sq, M, scale);
  return cudaGetLastError();
}

// The query-head splits of the dk/dv launch (its blockIdx.y), as heads per
// split: all g heads in one block but at D = 256, where a block a key tile
// and kv head may leave SMs idle (recurrentgemma-9b at B = 1, KV = 1, S =
// 4096: 64 blocks on 132 SMs); there the g heads are cut into as many
// splits as fill the SMs, whose fp32 partials dkdv_sum_kernel adds in
// order.  The bits depend on the split, and so on `sms`.
template <int D>
int heads_per_split(int B, int H, int KV, int Sk, int sms) {
  const int g = H / KV;
  using C = wg::Cfg<D>;
  const long blocks = (long)((Sk + C::BM - 1) / C::BM) * KV * B;
  if (!C::SPLIT || blocks >= sms) return g;
  const int splits = (int)std::min<long>(g, sms / blocks);
  return (g + splits - 1) / splits;
}

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv,
                         float* delta, float* work, int B, int H, int KV, int Sq, int Sk,
                         int causal, int window, int sms, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = wg::Smem<D>::BYTES;
  constexpr int BM = wg::Cfg<D>::BM;
  const uint64_t bh = (uint64_t)B * H, bkv = (uint64_t)B * KV;
  // dk/dv streams 64-row tiles of q and dO past BM-key blocks of k and v;
  // dq the other way round.
  CUtensorMap q64, do64, k_big, v_big, q_big, do_big, k64, v64;
  cudaError_t err = hopper::make_map_3d(&q64, q, bf16, D, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_map_3d(&do64, dout, bf16, D, Sq, bh, wg::BN);
  if (err == cudaSuccess) err = hopper::make_map_3d(&k_big, k, bf16, D, Sk, bkv, BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&v_big, v, bf16, D, Sk, bkv, BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&q_big, q, bf16, D, Sq, bh, BM);
  if (err == cudaSuccess) err = hopper::make_map_3d(&do_big, dout, bf16, D, Sq, bh, BM);
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
  const int g = H / KV;
  const int heads_per = heads_per_split<D>(B, H, KV, Sk, sms);
  const int splits = (g + heads_per - 1) / heads_per;
  if (splits > 1 && work == nullptr) return cudaErrorInvalidValue;

  err = launch_delta<T, D>(o, dout, delta, (long)B * H * Sq, stream);
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<T, D><<<dim3((Sk + BM - 1) / BM, KV * splits, B), wg::THREADS, bytes,
                            stream>>>(
      q64, k_big, v_big, do64, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      splits > 1 ? work : nullptr, H, KV, Sq, Sk, causal, window, heads_per, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t n = (size_t)B * KV * Sk * D;
    dkdv_sum_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        work, static_cast<T*>(dk), static_cast<T*>(dv), splits, n, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_wgmma_kernel<T, D><<<dim3((Sq + BM - 1) / BM, H, B), wg::THREADS, bytes, stream>>>(
      q_big, k64, v64, do_big, lse, delta, static_cast<T*>(dq), H, KV, Sq, Sk, causal, window,
      scale, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, void* dq, void* dk, void* dv,
                           float* delta, float* work, int B, int H, int KV, int Sq, int Sk, int D,
                           int causal, int window, int sms, cudaStream_t stream) {
  if (D == 64)
    return launch_wgmma<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B, H, KV, Sq, Sk,
                               causal, window, sms, stream);
  if (D == 80)
    return launch_wgmma80<T>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B, H, KV, Sq, Sk,
                             causal, window, sms, stream);
  if (D == 128)
    return launch_wgmma<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B, H, KV, Sq,
                                Sk, causal, window, sms, stream);
  if (D == 256)
    return launch_wgmma<T, 256>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B, H, KV, Sq,
                                Sk, causal, window, sms, stream);
  return cudaErrorInvalidValue;
}

bool valid(int B, int H, int KV, int Sq, int Sk, int window) {
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && Sq >= 1 && Sk >= 1 && B <= 65535 &&
         H <= 65535 && window >= 0;
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D); lse, delta:
// (B, H, Sq) fp32, delta scratch the call overwrites.  Contiguous device
// arrays, 16-byte aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.  D: 64,
// 80, 128 or 256, and 32 on the fma tiling.  work: repro_flash_attention_bwd_workspace(B, H, KV, Sq, Sk,
// D, sms) bytes of scratch (the wgmma tiling's partials of dk and dv at
// D = 256, its turn counters and fp32 dq sums at D = 80; may be null where
// that is 0); sms: the card's SMs.  Each entry
// point launches one tiling's kernels on `stream` and returns a cudaError_t
// (0 on success); a shape or dtype its tiling does not take returns
// cudaErrorInvalidValue.

// Bytes of scratch the wgmma tiling needs (the fma tiling needs none): at
// D = 256 two fp32 partials of dk and dv for each query-head split, or 0
// without splits; at D = 80 a turn counter a 64-row query tile and dq's
// fp32 sums, (B*H, ceil(Sq / 64)*64, 80).
extern "C" long long repro_flash_attention_bwd_workspace(int B, int H, int KV, int Sq, int Sk,
                                                         int D, int sms) {
  if (!valid(B, H, KV, Sq, Sk, 0) || sms < 1) return 0;
  if (D == 80) return d80_workspace(B, H, Sq);
  const int g = H / KV;
  const int per = D == 256 ? heads_per_split<256>(B, H, KV, Sk, sms) : g;
  const long long splits = (g + per - 1) / per;
  return splits > 1 ? 2LL * splits * B * KV * Sk * D * (long long)sizeof(float) : 0;
}

// Tensor cores; float16 or bfloat16.
extern "C" int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               void* dq, void* dk, void* dv, float* delta,
                                               float* work, int B, int H, int KV, int Sq, int Sk,
                                               int D, int causal, int window, int sms, int dtype,
                                               void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window) || sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)launch_wgmma_d<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B, H, KV,
                                         Sq, Sk, D, causal, window, sms, s);
    case 2:
      return (int)launch_wgmma_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, work, B,
                                                H, KV, Sq, Sk, D, causal, window, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any of the three dtypes.  `work` and `sms`
// are not read (the same arguments as the wgmma entry).
extern "C" int repro_flash_attention_bwd_fma(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             void* dq, void* dk, void* dv, float* delta,
                                             float* work, int B, int H, int KV, int Sq, int Sk,
                                             int D, int causal, int window, int sms, int dtype,
                                             void* stream) {
  (void)work;
  (void)sms;
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
