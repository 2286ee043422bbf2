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
// `attention_tiling` chooses among them:
//
// * wgmma (bf16/fp16; D = 64, 80, 128 or 256; every prefill of the served
//   models).  An FA3-style forward on the tensor cores.  A block of three
//   warpgroups owns 128 query rows of one (batch, head).  The producer
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
//   A head dim that is no multiple of 64 (hubert-xlarge's 80) runs at the
//   compute width DP = D rounded up to 64: the tensor maps keep the real
//   inner extent D (row stride 2D bytes), so TMA fills columns D .. DP-1
//   of the last box with zeros; Q K^T issues only ceil(D / 16) k16 steps,
//   P V produces DP columns of which the epilogue stores the first D, and
//   the scale is 1/sqrt(D).
// * fma (fp32, any of the four head dims; exact fp32 for the narrow fp32
//   models).  One block of 256 threads per (BQ-row q tile, q head, batch),
//   tiles staged in shared memory as fp32 (Q: BQ x (D + 4), K, V: BK x
//   (D + 4), P: BQ x (BK + 4)); thread (ty, tx) of a 16 x 16 grid owns
//   query rows RQ*ty .. RQ*ty+RQ-1 (RQ = BQ / 16), scores against keys
//   tx + 16*j and output columns 64*g + 4*tx .. +3 (g < ceil(D / 64);
//   at D = 80 only threads tx < 4 own columns in group 1), with fp32 FMAs
//   on the CUDA cores.  BQ = BK = 64 at D = 64, 80 and 128, 32 at D = 256.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3,
// CUDA-event means over 20 launches; PERF.md section 6, row 1): wgmma
// 0.123 ms at granite-8b's shape (SDPA 0.085 ms, bound 0.033 ms) and
// 0.318 ms at recurrentgemma-9b's (SDPA 0.250 ms, bound 0.139 ms); the fma
// tiling takes 1.31 and 6.87 ms on the same bf16 inputs, 1.40 and 6.93 ms
// in fp32; at hubert-xlarge's shape wgmma 0.088 ms (SDPA 0.066, bound
// 0.021), fma 0.99; at the VLM's cross shape 0.277 ms (SDPA 0.192, bound
// 0.106), fma 3.74.

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
  constexpr int NG = (D + 63) / 64;  // groups of 4 output columns per thread
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
          if (D % 64 != 0 && 64 * g + 4 * tx >= D) continue;  // columns past D
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
    for (int g = 0; g < NG; ++g) {
      if (D % 64 != 0 && 64 * g + 4 * tx >= D) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = from_float<T>(acc[i][4 * g + c] / denom);
    }
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
  if (D == 80) return launch<T, 80>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 128) return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 256) return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  return cudaErrorInvalidValue;
}

// wgmma kernel.

// The value of x, hidden from the optimiser: descriptors computed from it
// inside the kv loop stay there, instead of being hoisted out of it and
// held in registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

namespace wg {
constexpr int BQ = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int BK = 64;   // keys per k/v tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2

// The compute width of head dim D: whole 64-wide boxes (80 -> 128).
template <int D> struct Width { static constexpr int value = (D + 63) / 64 * 64; };

template <int D> struct Smem {
  static constexpr int Q = BQ * D * 2;   // D / 64 boxes of BQ x 128 bytes
  static constexpr int KV = BK * D * 2;  // one k or v tile: D / 64 boxes of 64 x 128 bytes
  static constexpr int BYTES = Q + 2 * STAGES * KV + 8 * (1 + 3 * STAGES) + 1024;
};
}  // namespace wg

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, T* __restrict__ o,
                             int H, int KV, int Sq, int Sk, int causal, int window,
                             float scale_log2) {
  using wg::BK;
  using wg::BQ;
  using wg::STAGES;
  constexpr int DP = wg::Width<D>::value;
  using S = wg::Smem<DP>;
  constexpr int CH = DP / 64;  // 64-wide column boxes of a row
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

    float acc[DP / 2];  // O: acc[4j + 2i + c] is row row0 + 8i, column 8j + col0 + c
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) acc[n] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int i = kt - kt_begin, s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = kt * BK;
      // Shared-memory addresses of this warpgroup's q rows and of the stage.
      const uint32_t qw = opaque(hopper::smem_u32(sq) + warpgroup * 64 * 128);
      const uint32_t ks = opaque(hopper::smem_u32(sk) + s * S::KV);
      const uint32_t vs = opaque(hopper::smem_u32(sv) + s * S::KV);
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
        for (int kk = 0; kk < (D + 15) / 16; ++kk) {  // box kk / 4, 32 bytes a k16 step in it
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
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = hopper::pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = hopper::pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = hopper::pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = hopper::pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int n = 0; n < DP / 2; ++n) acc[n] *= alpha[(n / 2) % 2];

        hopper::mbar_wait(&v_full[s], parity);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys, 16 rows of v's boxes, a step
          hopper::Wgmma<DP, T>::template rs<1>(
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
    T* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos > wq_last) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* orow = op + (size_t)qpos * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
            hopper::pack2<T>(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int KV, int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = wg::Smem<wg::Width<D>::value>::BYTES;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = hopper::make_map_3d(&map_q, q, bf16, D, Sq, (uint64_t)B * H, wg::BQ);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&map_k, k, bf16, D, Sk, (uint64_t)B * KV, wg::BK);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&map_v, v, bf16, D, Sk, (uint64_t)B * KV, wg::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + wg::BQ - 1) / wg::BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_attention_wgmma_kernel<T, D><<<grid, wg::THREADS, bytes, stream>>>(
      map_q, map_k, map_v, static_cast<T*>(o), H, KV, Sq, Sk, causal, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                           int KV, int Sq, int Sk, int D, int causal, int window,
                           cudaStream_t stream) {
  if (D == 64) return launch_wgmma<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 80) return launch_wgmma<T, 80>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 128) return launch_wgmma<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  if (D == 256) return launch_wgmma<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, stream);
  return cudaErrorInvalidValue;
}

bool valid(int B, int H, int KV, int Sq, int Sk, int window) {
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && Sq >= 1 && Sk >= 1 && B <= 65535 &&
         H <= 65535 && window >= 0;
}

}  // namespace

// q, k, v, o: contiguous device arrays, 16-byte aligned; q and o are
// (B, H, Sq, D), k and v (B, KV, Sk, D).  dtype: 0 float32, 1 float16,
// 2 bfloat16.  D: 64, 80, 128 or 256.  Each entry point launches one tiling on
// `stream` and returns a cudaError_t (0 on success); a shape or dtype its
// tiling does not take returns cudaErrorInvalidValue.

// Tensor cores; float16 or bfloat16.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int KV, int Sq, int Sk, int D,
                                           int causal, int window, int dtype, void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)launch_wgmma_d<__half>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    case 2:
      return (int)launch_wgmma_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window,
                                                s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any of the three dtypes.
extern "C" int repro_flash_attention_fma(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int KV, int Sq, int Sk, int D, int causal,
                                         int window, int dtype, void* stream) {
  if (!valid(B, H, KV, Sq, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    case 1: return (int)launch_d<__half>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    case 2:
      return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
