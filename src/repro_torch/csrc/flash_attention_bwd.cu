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
// same bits from run to run:
//
// * delta: one warp a row, delta = rowsum(dO o O).
// * dk/dv: one block per (64-key tile, kv head, batch).  K and V stay in
//   shared memory; the block walks the g query heads of its group in order
//   and, for each, the 64-row query tiles that can see the key tile (none
//   below the diagonal, none past the window).  For each query tile it
//   recomputes S and dP (thread (ty, tx) of a 16 x 16 grid owns query rows
//   4ty .. 4ty+3 and keys tx + 16j), stores P and dS in shared memory, then
//   accumulates dV += P^T dO and dK += dS^T Q in registers (key rows
//   4ty .. 4ty+3, columns 64c + 4tx .. +3).  Keys past Sk and rows past Sq
//   get P = 0; key rows past Sk are not stored.
// * dq: one block per (64-row query tile, head, batch), longest causal
//   tiles first, walking the key tiles the forward visits: recomputes S, dP
//   and dS, stores dS in shared memory and accumulates dQ += dS K.
//
// So S and dP are computed twice (5 products of the math become 7), which
// is the price of no atomics and no (Sq, Sk) buffer in device memory.  All
// products are fp32 FMAs on the CUDA cores (tiles staged as fp32 with row
// stride D + 4): a simple kernel, right first; tensor cores are a later
// redesign.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 5 products of
// 2 * D flops a kept (query, key) pair.  At minicpm-2b's training shape
// (B = 4, H = KV = 36, S = 4096, D = 64, causal, bf16) that is 773 GFLOP a
// layer, 0.78 ms on the tensor cores against 0.45 GB of q, k, v, o, dO,
// lse, dq, dk, dv (0.13 ms): bound by operations.  The FMA pipes' own peak
// is 67 TFLOP/s, 15x below it; chip_smoke.py phase 3 prints the time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

  const long rows = (long)B * H * Sq;
  delta_kernel<T, D><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0,
                       stream>>>(static_cast<const T*>(o), dot, delta, rows);
  err = cudaGetLastError();
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

}  // namespace

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, KV, Sk, D); lse, delta:
// (B, H, Sq) fp32, delta scratch the call overwrites.  Contiguous device
// arrays, 16-byte aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.  D: 64
// or 128.  Launches the three kernels on `stream` and returns a cudaError_t
// (0 on success); a shape or dtype they do not take returns
// cudaErrorInvalidValue.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         void* dq, void* dk, void* dv, float* delta, int B, int H,
                                         int KV, int Sq, int Sk, int D, int causal, int window,
                                         int dtype, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
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
