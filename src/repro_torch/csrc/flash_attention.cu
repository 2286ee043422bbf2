// Flash attention forward (GQA; causal, sliding-window or full) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel` in
// src/repro/kernels/flash_attention.py.  It computes the same function:
// q (B, H, Sq, D), k/v (B, KV, Sk, D), kv head h / (H / KV); query and key
// positions both count from 0; scores scaled by 1/sqrt(D); masked scores
// set to -1e30; online softmax with m, l and the output accumulator in fp32;
// l floored at 1e-30; output in q's dtype.  The TPU kernel's sequential kv
// grid axis becomes a loop over k/v tiles inside the block, carrying m, l
// and the accumulator in registers; k tiles wholly above the diagonal
// (causal) or wholly before the window are skipped, and q tiles are
// launched longest first.  The block masks the ragged tails of Sq and Sk
// itself, so the wrapper pads nothing.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at granite-8b's
// prefill (B = 4, H = 32, KV = 8, S = 1000, D = 128, causal, bf16) the work
// is 4*B*H*D flops a kept (query, key) pair, 32.8 GFLOP, 0.033 ms on the
// tensor cores, against 82 MB of q, k, v and output, 0.024 ms: bound by
// operations.  At recurrentgemma-9b's (B = 4, H = 16, KV = 1, S = 2048,
// D = 256, window 2048) 0.139 ms, at hubert-xlarge's (B = 4, H = KV = 16,
// S = 1000, D = 80, both ways) 0.021 ms and at llama-3.2-vision-11b's
// cross-attention (B = 4, H = 32, KV = 8, Sq = 1000, Sk = 1601, D = 128,
// unmasked) 0.106 ms, all by operations.
//
// Two tilings, one C entry point each; kernels/flash_attention.py's
// `attention_tiling` chooses among them.  Every head dim D from 1 to 256
// runs, as the TPU kernel takes any D: a block computes at a width W >= D
// that its instances are built for and reads the columns past D as zeros
// (TMA's out-of-bounds fill on wgmma, masked loads on fma), which add exact
// zeros to S = Q K^T and give zero columns of O that are not stored; the
// scale is 1/sqrt(D) of the true D.  wgmma takes D % 8 == 0 (TMA's 16-byte
// row strides) at W = 64 (D 8-64: the smoke configs' 16), 80 (72, 80), 128
// (88-128) or 256 (136-256); fma takes any D, at W = D for 32, 64, 80, 128
// and 256 and in a ragged instance at the next of 32, 64, 128 and 256 for
// the rest (one block an SM: at the default 128 registers its masked loads
// and stores spill).  The widths cost what D = W costs.
//
// * wgmma (bf16/fp16; W = 64, 128 or 256; every prefill of the served
//   models but hubert-xlarge's).  An FA3-style forward on the tensor
//   cores.  A block of three warpgroups owns 128 query rows of one (batch,
//   head).  The producer
//   warpgroup gives its registers to the consumers (setmaxnreg); one of its
//   threads loads the q tile once by TMA and then k and v tiles of 64 rows
//   into a 2-stage ring (3-D tensor maps over (D, S, B*heads), one head a
//   box row, zeros past Sq and Sk).  Each consumer warpgroup owns 64 query
//   rows: S = Q K^T by wgmma m64n64k16 with both operands K-major in shared
//   memory; the online softmax runs on the accumulator fragment in
//   registers (row max and sum over the 4 threads of a row, exp2 with
//   scale * log2 e folded in, the mask applied only on tiles that straddle
//   the diagonal, the window's edge or Sk's tail, and tiles wholly masked
//   for the warpgroup's rows skipped); P is rounded to the input's 16-bit
//   type in registers, as the JAX model's `_sdpa` rounds its probabilities,
//   and is wgmma's A operand from registers for O += P V, with v the
//   MN-major B operand (the transpose bit), O in D/2 fp32 registers a
//   thread; l sums the fp32 p.  Shared memory: q 128 x D, k and v 2 x 64 x D
//   each: 96 KB at D = 128, 192 KB at D = 256.  What this does about the
//   operation bound: every product runs on the tensor cores, and the work
//   the mask discards is skipped at 64-key granularity per warpgroup.
// * wgmma at D = 80 (hubert-xlarge; flash_attention_d80_wgmma_kernel).  A
//   row of 80 16-bit values fills no whole 128-byte box, so every tile is a
//   64-column box with the 128-byte swizzle beside a 16-column box with the
//   32-byte one (hopper.cuh's d80 layout): TMA moves the real 160 bytes a
//   row, Q K^T takes 5 k16 steps (4 in the wide box, 1 in the narrow) and
//   P V runs at N = 64 + 16, so no product runs on zero columns (at a
//   padded width of 128, 3/8 of P V's work and 24 of 64 accumulator
//   registers were zeros).  At this width the exps cost nearly as much as
//   the products (about 0.28 ms of the SFU's time against 0.35 on the
//   tensor cores at hubert's training shape), so the kernel overlaps them:
//   k and v tiles of 128 keys arrive in rings of their own (a k tile is
//   freed once S is in, a v tile after P V), and each consumer warpgroup's
//   round t issues S of tile t and then O += P V of tile t - 1, computing
//   tile t's softmax while that P V runs; the two warpgroups issue their
//   rounds in turns (named barriers, as the backward's), so one's softmax
//   runs under the other's products.  The rounds' commits and waits are
//   fixed at compile time (a first round, the steady ones, a last one):
//   with them chosen at run time ptxas cannot tell which products are in
//   flight and serialises every wgmma.  Scores stay raw until the exp,
//   exp2(s scale log2 e - m scale log2 e) in one FFMA, and a row whose
//   keys are all masked so far gets p = 0.  Shared memory: q 20 KB, a
//   ring of 2 k and 2 v tiles of 20 KB.
// * fma (fp32, and bf16/fp16 at a D TMA cannot stride; exact fp32 for the
//   narrow fp32 models).  One block of 256 threads per (BQ-row q tile, q head, batch),
//   tiles staged in shared memory as fp32 (Q: BQ x (D + 4), K, V: BK x
//   (D + 4), P: BQ x (BK + 4)); thread (ty, tx) of a 16 x 16 grid owns
//   query rows RQ*ty .. RQ*ty+RQ-1 (RQ = BQ / 16), scores against keys
//   tx + 16*j and output columns 64*g + 4*tx .. +3 (g < ceil(D / 64);
//   at D = 80 only threads tx < 4 own columns in group 1, at D = 32 only
//   threads tx < 8), with fp32 FMAs on the CUDA cores.  BQ = BK = 64 at
//   D = 32, 64, 80 and 128, 32 at D = 256.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3,
// CUDA-event means over 20 launches; PERF.md section 6, row 1): wgmma
// 0.123 ms at granite-8b's shape (SDPA 0.085 ms, bound 0.033 ms) and
// 0.318 ms at recurrentgemma-9b's (SDPA 0.250 ms, bound 0.139 ms); the fma
// tiling takes 1.31 and 6.87 ms on the same bf16 inputs, 1.40 and 6.93 ms
// in fp32; at hubert-xlarge's shape fma 0.99; at the VLM's cross shape
// 0.277 ms (SDPA 0.192, bound 0.106), fma 3.74.  The D = 80 kernel
// (tools/attn80_variants.py, medians of 5 rounds in turns, same card): at
// hubert-xlarge's training shape (B = 4, H = KV = 16, S = 4096) 0.699-0.725
// ms, 48-50% of its 0.347 ms bound (SDPA 0.83 ms; the kernel at a padded
// width of 128, 1.17 ms), and 0.064-0.066 ms at its serving shape (4 x
// 1000; SDPA 0.066, the padded kernel 0.088).  Its rings of 3 and 4 tiles,
// 64-key tiles, the five-box 32-byte layout and the consumers without
// turns all ran slower or level (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows of a q tile and of a k/v tile for each head dim.
template <int D> struct Tiles { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

template <int D, int BQ, int BK>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4)) * (int)sizeof(float);
}

// Copies rows [row0, row0 + ROWS) of a contiguous (rows, D) matrix into
// shared memory as fp32, W columns a row with row stride W + 4; rows at or
// past `rows` are zero, so padded keys add nothing before the mask removes
// them.  D is W but in RAGGED instances (any D < W), whose columns at or
// past D are zero too, so they add exact zeros to every product: 16-byte
// loads where a row of D values is a whole number of them, else one value
// a thread at a time.
template <typename T, int W, int ROWS, bool RAGGED>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int D, int tid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load: 4 or 8
  constexpr int VPR = W / VEC;         // 16-byte loads per row
  constexpr int LD = W + 4;
  const int d = RAGGED ? D : W;
  if (!RAGGED || d % VEC == 0) {
    for (int i = tid; i < ROWS * VPR; i += THREADS) {
      const int r = i / VPR;
      const int c = (i % VPR) * VEC;
      float* dp = dst + r * LD + c;
      const int row = row0 + r;
      float f[VEC];
      if (row < rows && (!RAGGED || c < d)) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * d + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = to_float<T>(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(dp + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  } else {
    for (int i = tid; i < ROWS * W; i += THREADS) {
      const int r = i / W, c = i % W, row = row0 + r;
      dst[r * LD + c] = row < rows && c < d ? to_float<T>(src[(size_t)row * d + c]) : 0.f;
    }
  }
}

// The fma block's work.  W: the width it computes at, D (RAGGED) or W
// itself: the head dim.
template <typename T, int W, int BQ, int BK, bool RAGGED>
__device__ __forceinline__ void fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, T* __restrict__ o,
                                        float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                                        int D, int causal, int window, float scale) {
  constexpr int LD = W + 4;
  constexpr int LDP = BK + 4;  // row stride of the P tile, in floats
  constexpr int NG = (W + 63) / 64;  // groups of 4 output columns per thread
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int KJ = BK / 16;  // keys per thread in a k/v tile
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // Causal q tiles late in the sequence do the most work: start them first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int d = RAGGED ? D : W;

  const T* qp = q + (size_t)(b * H + h) * Sq * d;
  const T* kp = k + (size_t)(b * KV + kvh) * Sk * d;
  const T* vp = v + (size_t)(b * KV + kvh) * Sk * d;
  T* op = o + (size_t)(b * H + h) * Sq * d;

  load_tile<T, W, BQ, RAGGED>(sQ, qp, q0, Sq, d, tid);

  // k tiles this q tile can see: none above the diagonal, none before the window.
  const int nk = (Sk + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  float m[RQ], l[RQ], acc[RQ][4 * NG];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of sK, sV and sP are done
    load_tile<T, W, BK, RAGGED>(sK, kp, k0, Sk, d, tid);
    load_tile<T, W, BK, RAGGED>(sV, vp, k0, Sk, d, tid);
    __syncthreads();

    // s[i][j] = q[RQ*ty + i] . k[tx + 16*j]
    float s[RQ][KJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < W; c += 4) {
      float4 qv[RQ], kv[KJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (RQ * ty + i) * LD + c);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + RQ * ty + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(RQ * ty + i) * LDP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][4g + c] += sum_j p[RQ*ty + i][j] * v[j][64g + 4tx + c]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (RQ * ty + i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (W % 64 != 0 && 64 * g + 4 * tx >= W) continue;  // columns past W
          const float4 vv =
              *reinterpret_cast<const float4*>(sV + (j + jj) * LD + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + RQ * ty + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is in the natural-log domain of the scaled scores here: lse = m + ln l.
    if (lse != nullptr && tx == 0) lse[(size_t)(b * H + h) * Sq + qpos] = m[i] + logf(denom);
    T* orow = op + (size_t)qpos * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (W % 64 != 0 && 64 * g + 4 * tx >= W) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!RAGGED || 64 * g + 4 * tx + c < d)
          orow[64 * g + 4 * tx + c] = from_float<T>(acc[i][4 * g + c] / denom);
    }
  }
}

// Head dims 32, 64, 80, 128 and 256: the kernel at the head dim itself.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int H, int KV, int Sq, int Sk, int causal,
                           int window, float scale) {
  fwd_fma<T, D, BQ, BK, false>(q, k, v, o, lse, H, KV, Sq, Sk, D, causal, window, scale);
}

// Any other head dim D < W: loads and stores masked to D.  One block an SM
// lets ptxas give a thread up to 255 registers: within the 128 that the
// launch bounds alone leave it, the masked loads and stores spill.
template <typename T, int W, int BQ, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_fwd_ragged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, T* __restrict__ o,
                                  float* __restrict__ lse, int H, int KV, int Sq, int Sk, int D,
                                  int causal, int window, float scale) {
  fwd_fma<T, W, BQ, BK, true>(q, k, v, o, lse, H, KV, Sq, Sk, D, causal, window, scale);
}

template <typename T, int W, bool RAGGED>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int KV, int Sq, int Sk, int D, int causal, int window, cudaStream_t stream) {
  constexpr int BQ = Tiles<W>::BQ, BK = Tiles<W>::BK;
  constexpr int bytes = smem_bytes<W, BQ, BK>();
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (RAGGED) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_ragged_kernel<T, W, BQ, BK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_ragged_kernel<T, W, BQ, BK><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, H, KV, Sq, Sk, D, causal, window, scale);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T, W, BQ, BK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_kernel<T, W, BQ, BK><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, H, KV, Sq, Sk, causal, window, scale);
  }
  return cudaGetLastError();
}

// Head dims 32, 64, 80, 128 and 256 have instances of their own; any other
// D from 1 to 256 runs a RAGGED instance at the next of the widths 32, 64,
// 128 and 256.
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int KV, int Sq, int Sk, int D, int causal, int window,
                     cudaStream_t stream) {
#define REPRO_FMA_FWD(W, RAGGED) \
  launch<T, W, RAGGED>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, stream)
  if (D == 32) return REPRO_FMA_FWD(32, false);
  if (D == 64) return REPRO_FMA_FWD(64, false);
  if (D == 80) return REPRO_FMA_FWD(80, false);
  if (D == 128) return REPRO_FMA_FWD(128, false);
  if (D == 256) return REPRO_FMA_FWD(256, false);
  if (D < 1 || D > 256) return cudaErrorInvalidValue;
  if (D < 32) return REPRO_FMA_FWD(32, true);
  if (D < 64) return REPRO_FMA_FWD(64, true);
  if (D < 128) return REPRO_FMA_FWD(128, true);
  return REPRO_FMA_FWD(256, true);
#undef REPRO_FMA_FWD
}

// wgmma kernel.

namespace wg {
constexpr int BQ = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int BK = 64;   // keys per k/v tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2


template <int D> struct Smem {
  static constexpr int Q = BQ * D * 2;   // D / 64 boxes of BQ x 128 bytes
  static constexpr int KV = BK * D * 2;  // one k or v tile: D / 64 boxes of 64 x 128 bytes
  static constexpr int BYTES = Q + 2 * STAGES * KV + 8 * (1 + 3 * STAGES) + 1024;
};
}  // namespace wg

// W: the width the block computes at; the head dim D is W but in RAGGED
// instances (D < W).  The maps' rows hold D values, so TMA fills the columns
// past D of every box with zeros, which add exact zeros to S and give zero
// columns of O that are not stored.
template <typename T, int W, bool RAGGED>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, T* __restrict__ o,
                             float* __restrict__ lse, int H, int KV, int Sq, int Sk, int D,
                             int causal, int window, float scale_log2) {
  using wg::BK;
  using wg::BQ;
  using wg::STAGES;
  static_assert(W % 64 == 0, "whole 64-column boxes (width 80 has a kernel of its own)");
  using S = wg::Smem<W>;
  constexpr int CH = W / 64;  // 64-wide column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sk = sq + S::Q;               // stage s at sk + s * S::KV
  uint8_t* sv = sk + STAGES * S::KV;     // stage s at sv + s * S::KV
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * S::KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // Causal q tiles late in the sequence do the most work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int bkv = b * KV + h / (H / KV);
  const int q_last = min(q0 + BQ, Sq) - 1;

  // k tiles this q tile can see: none above the diagonal, none before the window.
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_full, S::Q);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        hopper::tma_load_3d(sq + c * BQ * 128, &map_q, q_full, 64 * c, q0, bh);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin, s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* ks = sk + s * S::KV;
        uint8_t* vs = sv + s * S::KV;
        hopper::mbar_arrive_expect_tx(&k_full[s], S::KV);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_3d(ks + c * BK * 128, &map_k, &k_full[s], 64 * c, kt * BK, bkv);
        hopper::mbar_arrive_expect_tx(&v_full[s], S::KV);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          hopper::tma_load_3d(vs + c * BK * 128, &map_v, &v_full[s], 64 * c, kt * BK, bkv);
      }
    }
  } else {  // consumers
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) % 4;
    const int wq0 = q0 + 64 * warpgroup;        // this warpgroup's first query row
    const int wq_last = min(wq0 + 63, Sq - 1);  // and its last real one (< wq0 if none)
    const int row0 = wq0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and columns col0, col0 + 1 of each 8

    float acc[W / 2];  // O: acc[4j + 2i + c] is row row0 + 8i, column 8j + col0 + c
#pragma unroll
    for (int n = 0; n < W / 2; ++n) acc[n] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int i = kt - kt_begin, s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = kt * BK;
      // Shared-memory addresses of this warpgroup's q rows and of the stage.
      const uint32_t qw = hopper::opaque(hopper::smem_u32(sq) + warpgroup * 64 * 128);
      const uint32_t ks = hopper::opaque(hopper::smem_u32(sk) + s * S::KV);
      const uint32_t vs = hopper::opaque(hopper::smem_u32(sv) + s * S::KV);
      hopper::mbar_wait(&k_full[s], parity);
      // A tile wholly masked for this warpgroup's rows (or a warpgroup past
      // Sq) only waits for its loads and frees the stage.
      const bool skip = wq_last < wq0 || (causal && k0 > wq_last) ||
                        (window > 0 && k0 + BK - 1 <= wq0 - window);
      if (!skip) {
        float sc[BK / 2];  // S: sc[4j + 2i + c] is row row0 + 8i, key k0 + 8j + col0 + c
#pragma unroll
        for (int n = 0; n < BK / 2; ++n) sc[n] = 0.f;
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {  // box kk / 4, 32 bytes a k16 step in it
          const int step = (kk % 4) * 32;
          hopper::Wgmma<BK, T>::template ss<0>(
              sc, hopper::desc_sw128(qw + (kk / 4) * BQ * 128 + step, 16, 1024),
              hopper::desc_sw128(ks + (kk / 4) * BK * 128 + step, 16, 1024), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);

        const bool masked = (causal && k0 + BK - 1 > wq0) ||
                            (window > 0 && k0 <= wq_last - window) || k0 + BK > Sk;
#pragma unroll
        for (int n = 0; n < BK / 2; ++n) {
          float x = sc[n] * scale_log2;  // log2-domain score
          if (masked) {
            const int qpos = row0 + 8 * ((n / 2) % 2);
            const int kpos = k0 + 8 * (n / 4) + col0 + n % 2;
            bool keep = kpos < Sk;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (!keep) x = NEG_INF;
          }
          sc[n] = x;
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          alpha[r] = hopper::exp2_approx(m[r] - mx);
          m[r] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const float p0 = hopper::exp2_approx(sc[4 * j + 2 * r] - mx);
            const float p1 = hopper::exp2_approx(sc[4 * j + 2 * r + 1] - mx);
            sc[4 * j + 2 * r] = p0;
            sc[4 * j + 2 * r + 1] = p1;
            sum += p0 + p1;
          }
          l[r] = alpha[r] * l[r] + sum;  // this thread's share; summed over the row at the end
        }
        // P as wgmma A fragments, one per 16 keys: the accumulator layout of
        // keys 16kk .. 16kk+15 is the A fragment's.
        uint32_t pa[BK / 16][4];
        hopper::to_a_frags<T>(pa, sc);
#pragma unroll
        for (int n = 0; n < W / 2; ++n) acc[n] *= alpha[(n / 2) % 2];

        hopper::mbar_wait(&v_full[s], parity);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys, 16 rows of v's boxes, a step
          hopper::Wgmma<W, T>::template rs<1>(
              acc, pa[kk], hopper::desc_sw128(vs + kk * 2048, BK * 128, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      } else {
        hopper::mbar_wait(&v_full[s], parity);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int d = RAGGED ? D : W;
    T* op = o + (size_t)bh * Sq * d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos > wq_last) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / denom;
      // m is in the log2 domain of the scaled scores here (scale_log2):
      // the natural-log lse is (m + log2 l) * ln 2.
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * Sq + qpos] = (m[r] + log2f(denom)) * 0.6931471805599453f;
      T* orow = op + (size_t)qpos * d;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (!RAGGED || 8 * j < d)  // D % 8 == 0: a pair of columns lies before D or past it
          *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
              hopper::pack2<T>(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename T, int W>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int KV, int Sq, int Sk, int D, int causal, int window,
                         cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = wg::Smem<W>::BYTES;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = hopper::make_map_3d(&map_q, q, bf16, D, Sq, (uint64_t)B * H, wg::BQ);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&map_k, k, bf16, D, Sk, (uint64_t)B * KV, wg::BK);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&map_v, v, bf16, D, Sk, (uint64_t)B * KV, wg::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(D == W ? flash_attention_wgmma_kernel<T, W, false>
                                      : flash_attention_wgmma_kernel<T, W, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + wg::BQ - 1) / wg::BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  if (D == W)  // the head dims with widths of their own: stores unmasked, as before
    flash_attention_wgmma_kernel<T, W, false><<<grid, wg::THREADS, bytes, stream>>>(
        map_q, map_k, map_v, static_cast<T*>(o), lse, H, KV, Sq, Sk, D, causal, window,
        scale_log2);
  else
    flash_attention_wgmma_kernel<T, W, true><<<grid, wg::THREADS, bytes, stream>>>(
        map_q, map_k, map_v, static_cast<T*>(o), lse, H, KV, Sq, Sk, D, causal, window,
        scale_log2);
  return cudaGetLastError();
}

// wgmma kernel at head dim 80: products at the true width (hopper.cuh's
// d80 layout), each consumer's softmax overlapped with its own next S and
// with the other consumer's products.

namespace wg80 {
constexpr int BQ = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;       // keys per k/v tile
constexpr int STAGES = 2;     // k and v tiles in the ring
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int Q_BYTES = BQ * hopper::d80::ROW_BYTES;
constexpr int KV_BYTES = BK * hopper::d80::ROW_BYTES;  // one k or v tile
constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES) + 1024;

// Ping-pong between the two consumer warpgroups (as the backward's): each
// issues its products only in its turn, named barrier 1 + its index, at
// which the other arrives once it has issued its own.
__device__ __forceinline__ void take_turn(int warpgroup) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + warpgroup) : "memory");
}
__device__ __forceinline__ void pass_turn(int warpgroup) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - warpgroup) : "memory");
}
}  // namespace wg80

// What a consumer warpgroup of the D = 80 kernel carries from tile to tile.
struct Fwd80 {
  float acc[40];  // O: acc[4j + 2i + c] is row row0 + 8i, column 8j + col0 + c
  float m[2], l[2], alpha[2];  // the row max of the raw scores, this thread's share of l
  float sc[wg80::BK / 2];  // S: sc[4j + 2i + c] is row row0 + 8i, key k0 + 8j + col0 + c
  uint32_t pa[wg80::BK / 16][4];  // P of the previous tile as wgmma A fragments
};

// What a consumer warpgroup's rounds read.
struct Fwd80Args {
  uint8_t *sk, *sv;
  uint64_t *k_full, *v_full, *k_empty, *v_empty;
  uint32_t qw;
  int warpgroup, lane, row0, col0, wq0, wq_last, kt_begin, Sk, causal, window;
  float scale_log2;
};

// Round t of a consumer warpgroup: issues S of tile t (HAS_S) and O += P V
// of tile t - 1 (HAS_PV) in its turn, then the softmax of tile t while
// P V runs.  Each round's commits and waits are fixed at compile time, so
// ptxas sees which products are in flight wherever a register is read, and
// keeps them asynchronous.
template <typename T, bool HAS_S, bool HAS_PV>
__device__ __forceinline__ void fwd80_round(Fwd80& st, const Fwd80Args& a, int t) {
  using wg80::BK;
  using wg80::STAGES;
  namespace d80 = hopper::d80;
  const int s = t % STAGES, sp = (t + STAGES - 1) % STAGES;
  const int k0 = (a.kt_begin + t) * BK;
  if (HAS_S) hopper::mbar_wait(&a.k_full[s], (t / STAGES) & 1);
  wg80::take_turn(a.warpgroup);
  if (HAS_S) {
    const uint32_t ks = hopper::opaque(hopper::smem_u32(a.sk) + s * wg80::KV_BYTES);
    hopper::fence_regs(st.sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 5; ++kk)
      hopper::Wgmma<BK, T>::template ss<0>(
          st.sc, d80::kmajor<wg80::BQ>(a.qw, 64 * a.warpgroup, kk), d80::kmajor<BK>(ks, 0, kk),
          kk > 0);
    hopper::wgmma_commit();
  }
  if (HAS_PV) {
    const uint32_t vs = hopper::opaque(hopper::smem_u32(a.sv) + sp * wg80::KV_BYTES);
#pragma unroll
    for (int j = 0; j < 40; ++j) st.acc[j] *= st.alpha[(j / 2) % 2];
    hopper::mbar_wait(&a.v_full[sp], ((t - 1) / STAGES) & 1);
    hopper::fence_regs(st.acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys, 16 rows of v's boxes, a step
      d80::rs<T, BK>(st.acc, st.pa[kk], vs, kk, 1);
    hopper::wgmma_commit();
  }
  wg80::pass_turn(a.warpgroup);
  if (HAS_S) {
    if (HAS_PV)
      hopper::wgmma_wait<1>();  // S is in; P V runs on
    else
      hopper::wgmma_wait<0>();
    hopper::fence_regs(st.sc);
    __syncwarp();
    if (a.lane == 0) hopper::mbar_arrive(&a.k_empty[s]);
    const int causal = a.causal, window = a.window;
    const bool masked = (causal && k0 + BK - 1 > a.wq0) ||
                        (window > 0 && k0 <= a.wq_last - window) || k0 + BK > a.Sk;
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int qpos = a.row0 + 8 * ((j / 2) % 2);
        const int kpos = k0 + 8 * (j / 4) + a.col0 + j % 2;
        bool keep = kpos < a.Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        if (!keep) st.sc[j] = NEG_INF;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = st.m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(st.sc[4 * j + 2 * r], st.sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // In the log2 domain, exp2(s scale_log2 - m scale_log2); a row with
      // every key masked so far gets p = 0 (NEG_INF is finite).
      const float ms = mx == NEG_INF ? 0.f : mx * a.scale_log2;
      st.alpha[r] = hopper::exp2_approx(fmaf(st.m[r], a.scale_log2, -ms));
      st.m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = hopper::exp2_approx(fmaf(st.sc[4 * j + 2 * r], a.scale_log2, -ms));
        const float p1 = hopper::exp2_approx(fmaf(st.sc[4 * j + 2 * r + 1], a.scale_log2, -ms));
        st.sc[4 * j + 2 * r] = p0;
        st.sc[4 * j + 2 * r + 1] = p1;
        sum += p0 + p1;
      }
      st.l[r] = st.alpha[r] * st.l[r] + sum;  // this thread's share, summed over the row at the end
    }
  }
  if (HAS_PV) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st.acc);
    __syncwarp();
    if (a.lane == 0) hopper::mbar_arrive(&a.v_empty[sp]);
  }
  // P rounded to T as the A fragments of the next round's P V.
  if (HAS_S) hopper::to_a_frags<T>(st.pa, st.sc);
}

template <typename T>
__global__ void __launch_bounds__(wg80::THREADS, 1)
flash_attention_d80_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_q16,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_k16,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_v16, T* __restrict__ o,
                               float* __restrict__ lse, int H, int KV, int Sq, int Sk, int D,
                               int causal, int window, float scale_log2) {
  using wg80::BK;
  using wg80::BQ;
  using wg80::STAGES;
  namespace d80 = hopper::d80;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sk = sq + wg80::Q_BYTES;             // stage s at sk + s * KV_BYTES
  uint8_t* sv = sk + STAGES * wg80::KV_BYTES;   // stage s at sv + s * KV_BYTES
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * wg80::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  // Causal q tiles late in the sequence do the most work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int bkv = b * KV + h / (H / KV);
  const int q_last = min(q0 + BQ, Sq) - 1;

  // k tiles this q tile can see: none above the diagonal, none before the window.
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_last / BK + 1) : nk;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int n = max(0, kt_end - kt_begin);
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);  // one arrive per consumer warp
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_full, wg80::Q_BYTES);
      d80::load<BQ>(sq, &map_q, &map_q16, q_full, q0, bh);
      // K and V have rings of their own: K of a tile is released once S is
      // in, V only after P V, a tile later.
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, kt = kt_begin + i;
        const uint32_t phase = ((i / STAGES) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[s], phase);
        hopper::mbar_arrive_expect_tx(&k_full[s], wg80::KV_BYTES);
        d80::load<BK>(sk + s * wg80::KV_BYTES, &map_k, &map_k16, &k_full[s], kt * BK, bkv);
        hopper::mbar_wait(&v_empty[s], phase);
        hopper::mbar_arrive_expect_tx(&v_full[s], wg80::KV_BYTES);
        d80::load<BK>(sv + s * wg80::KV_BYTES, &map_v, &map_v16, &v_full[s], kt * BK, bkv);
      }
    }
  } else {  // consumers
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) % 4;
    const int wq0 = q0 + 64 * warpgroup;        // this warpgroup's first query row
    const int wq_last = min(wq0 + 63, Sq - 1);  // and its last real one (< wq0 if none)
    const int row0 = wq0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);              // and columns col0, col0 + 1 of each 8

    Fwd80 st;
#pragma unroll
    for (int j = 0; j < 40; ++j) st.acc[j] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;
    hopper::mbar_wait(q_full, 0);
    const Fwd80Args args{sk,  sv,   k_full,  v_full,  k_empty,  v_empty, hopper::smem_u32(sq),
                         warpgroup, lane, row0, col0, wq0, wq_last, kt_begin, Sk, causal,
                         window, scale_log2};
    if (warpgroup == 1) wg80::pass_turn(1);  // warpgroup 0 takes the first turn
    // Round t issues S of tile t and O += P V of tile t - 1: this tile's
    // softmax runs while the previous tile's P V does, and, by the turns,
    // while the other warpgroup's products do.
    if (n > 0) {
      fwd80_round<T, true, false>(st, args, 0);
      for (int t = 1; t < n; ++t) fwd80_round<T, true, true>(st, args, t);
      fwd80_round<T, false, true>(st, args, n);
    }
    if (warpgroup == 0) wg80::take_turn(0);  // the turn warpgroup 1 passed last

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    }
    T* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos > wq_last) continue;
      const float denom = fmaxf(st.l[r], 1e-30f);
      const float inv = 1.f / denom;
      // The natural-log lse of the scaled scores: (m scale_log2 + log2 l) ln 2.
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * Sq + qpos] = (st.m[r] * scale_log2 + log2f(denom)) * 0.6931471805599453f;
      T* orow = op + (size_t)qpos * D;
#pragma unroll
      for (int j = 0; j < 10; ++j)
        if (8 * j < D)  // D 72: the narrow box's last 8 columns are TMA's zeros
          *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
              hopper::pack2<T>(st.acc[4 * j + 2 * r] * inv, st.acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename T>
cudaError_t launch_wgmma80(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int KV, int Sq, int Sk, int D, int causal, int window,
                           cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mq16, mk, mk16, mv, mv16;
  cudaError_t err = hopper::make_maps_d80(&mq, &mq16, q, bf16, D, Sq, (uint64_t)B * H, wg80::BQ);
  if (err == cudaSuccess)
    err = hopper::make_maps_d80(&mk, &mk16, k, bf16, D, Sk, (uint64_t)B * KV, wg80::BK);
  if (err == cudaSuccess)
    err = hopper::make_maps_d80(&mv, &mv16, v, bf16, D, Sk, (uint64_t)B * KV, wg80::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_d80_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, wg80::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + wg80::BQ - 1) / wg80::BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_attention_d80_wgmma_kernel<T><<<grid, wg80::THREADS, wg80::SMEM_BYTES, stream>>>(
      mq, mq16, mk, mk16, mv, mv16, static_cast<T*>(o), lse, H, KV, Sq, Sk, D, causal, window,
      scale_log2);
  return cudaGetLastError();
}

// Any D that is a multiple of 8 (TMA's 16-byte row stride) up to 256, at
// the next of the widths 64, 80, 128 and 256.
template <typename T>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int KV, int Sq, int Sk, int D, int causal, int window,
                           cudaStream_t stream) {
  if (D < 8 || D > 256 || D % 8) return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_wgmma<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, stream);
  if (D <= 80)
    return launch_wgmma80<T>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, stream);
  if (D <= 128)
    return launch_wgmma<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, stream);
  return launch_wgmma<T, 256>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, stream);
}

bool valid(int B, int H, int KV, int Sq, int Sk, int window) {
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && Sq >= 1 && Sk >= 1 && B <= 65535 &&
         H <= 65535 && window >= 0;
}

}  // namespace

// q, k, v, o: contiguous device arrays, 16-byte aligned; q and o are
// (B, H, Sq, D), k and v (B, KV, Sk, D).  lse: null (serving: nothing more
// is stored), or a (B, H, Sq) fp32 array that gets each query row's
// log-sum-exp of its scaled, masked scores, in natural log on both tilings
// (the backward, csrc/flash_attention_bwd.cu, recomputes P from it).
// dtype: 0 float32, 1 float16, 2 bfloat16.  D: 1 to 256 (a multiple of 8
// on the wgmma tiling).  Each
// entry point launches one tiling on `stream` and returns a cudaError_t (0
// on success); a shape or dtype its tiling does not take returns
// cudaErrorInvalidValue.

// Tensor cores; float16 or bfloat16.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int B, int H, int KV, int Sq, int Sk,
                                           int D, int causal, int window, int dtype,
                                           void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)launch_wgmma_d<__half>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, s);
    case 2:
      return (int)launch_wgmma_d<__nv_bfloat16>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal,
                                                window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any of the three dtypes.
extern "C" int repro_flash_attention_fma(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int B, int H, int KV, int Sq, int Sk, int D,
                                         int causal, int window, int dtype, void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, s);
    case 1: return (int)launch_d<__half>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window, s);
    case 2:
      return (int)launch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, causal, window,
                                          s);
    default: return (int)cudaErrorInvalidValue;
  }
}
