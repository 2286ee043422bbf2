// Flash attention forward (GQA; causal, sliding-window or full) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel` in
// src/repro/kernels/flash_attention.py.  It computes the same function:
// q (B, H, Sq, D), k/v (B, KV, Sk, D), kv head h / (H / KV); query and key
// positions both count from 0; scores scaled by 1/sqrt(D); masked scores
// set to -1e30; online softmax with m, l and the output accumulator in fp32;
// l floored at 1e-30; output in q's dtype.
//
// Design.  One thread block of 256 threads per (BQ-row q tile, q head,
// batch).  A loop over BK-row k/v tiles inside the block takes the place of
// the TPU's sequential kv grid axis, carrying m, l and the accumulator in
// registers.  With `causal`, k tiles wholly above the diagonal are skipped
// (the TPU kernel keeps them as grid steps); with a window, k tiles wholly
// before it are skipped the same way.  The block computes its own offsets
// for contiguous inputs and masks the ragged tails of Sq and Sk itself, so
// the wrapper pads nothing.  Tiles are staged in shared memory as fp32
// (Q: BQ x (D + 4), K, V: BK x (D + 4), P: BQ x (BK + 4)), which is above
// the 48 KB static limit and so is dynamic shared memory.  The +4 padding
// keeps 16-byte rows while spreading rows across banks.  Thread (ty, tx) of
// a 16 x 16 grid owns query rows RQ*ty .. RQ*ty+RQ-1 (RQ = BQ / 16): it
// computes the scores of those rows against keys tx + 16*j (j < BK / 16),
// and the output columns 64*g + 4*tx .. +3 (g < D / 64).  Row maxima and
// sums are reduced over the 16 threads of a row with warp shuffles.
//
// Tiles by head dim: BQ = BK = 64 at D = 64 and 128 (116 KB of shared
// memory and 32 accumulators a thread at D = 128).  At D = 256
// (recurrentgemma-9b) 64-row tiles would need 212 KB of shared memory and
// 64 accumulators a thread, so D = 256 takes 32-row q and k/v tiles: 102 KB
// (two blocks on an SM) and again 32 accumulators a thread.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): for the serving
// slice's prefill (B = 4, H = 32, KV = 8, S = 1000, D = 128, causal, bf16)
// the work is 2*B*H*S^2*D = 32.8 GFLOP, 33 us on the tensor cores, against
// (2*B*H*S*D + 2*B*KV*S*D) * 2 bytes = 82 MB, 24 us of memory traffic: the
// kernel is bound by operations.  This first version does its products as
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so it cannot come within
// 15x of that bound; what it does about the bound is to do no work that the
// mask discards at tile granularity (the causal and window skips halve the
// work at long S).  Tensor-core products (mma.sync / wgmma) and TMA loads
// are the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// shared memory as fp32 with row stride D + 4; rows at or past `rows` are
// zero, so padded keys add nothing before the mask removes them.
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

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                           int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 4;  // row stride of the P tile, in floats
  constexpr int NG = D / 64;   // groups of 4 output columns per thread
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

  const T* qp = q + (size_t)(b * H + h) * Sq * D;
  const T* kp = k + (size_t)(b * KV + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KV + kvh) * Sk * D;
  T* op = o + (size_t)(b * H + h) * Sq * D;

  load_tile<T, D, BQ>(sQ, qp, q0, Sq, tid);

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
    load_tile<T, D, BK>(sK, kp, k0, Sk, tid);
    load_tile<T, D, BK>(sV, vp, k0, Sk, tid);
    __syncthreads();

    // s[i][j] = q[RQ*ty + i] . k[tx + 16*j]
    float s[RQ][KJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ], kv[KJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (RQ * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
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
    T* orow = op + (size_t)qpos * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = from_float<T>(acc[i][4 * g + c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr int bytes = smem_bytes<D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  flash_attention_fwd_kernel<T, D, BQ, BK><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int KV, int Sq, int Sk, int D, int causal, int window,
                     cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 128) return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 256) return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous device arrays, 16-byte aligned; q and o are
// (B, H, Sq, D), k and v (B, KV, Sk, D).  dtype: 0 float32, 1 float16,
// 2 bfloat16.  D: 64, 128 or 256.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int KV, int Sq, int Sk, int D,
                                         int causal, int window, int dtype, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || B > 65535 ||
      H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    case 1: return (int)launch_d<__half>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    case 2:
      return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
