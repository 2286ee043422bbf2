// Backward of the grouped (per-expert) matmul, for Hopper.
//
// The forward (moe_gmm.cu) computes out[e] = x[e] @ w[e] with x (E, C, D),
// w (E, D, F) and out (E, C, F).  Given dy = d loss / d out (E, C, F), this
// computes
//   dx[e] = dy[e] @ w[e]^T   (E, C, D), a sum over F, and
//   dw[e] = x[e]^T @ dy[e]   (E, D, F), a sum over C,
// each summed in an fp32 accumulator and cast once to x's (w's) dtype, as
// the plain version kernels/ref.py ref_moe_gmm_bwd does.  Either or both
// are computed (need_dx, need_dw), one kernel launch each.
//
// It replaces no TPU kernel: the Pallas moe_gmm (src/repro/kernels/
// moe_gmm.py) has no backward, and the JAX package's models compute the
// expert products with XLA einsums (src/repro/models/layers.py:346-348)
// differentiated by jax.grad, which is the oracle the tests hold this to.
// It exists so that the MoE family trains on the card with every expert
// product, forward and backward, on a kernel of this repo.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// training shapes of qwen3-moe-30b-a3b (E = 128, top 8, batch 4 x 4096,
// capacity C = int(1.25 * 16384 * 8 / 128) = 1280, bf16): each of dx and dw
// is 2*E*C*D*F = 515.4 GFLOP, 0.521 ms, so a call computing both is bound
// at 1.042 ms by operations; its bytes (x, w, dy read once, dx, dw written
// once: 2.40 GB at gate/up D = 2048, F = 768) take 0.72 ms.
//
// Two tilings, one C entry point each; kernels/moe_gmm.py's
// `gmm_bwd_tiling` chooses between them:
//
// * wgmma (bf16/fp16, D and F multiples of 8, any C).  The forward's
//   warp-specialised structure: a block of three warpgroups owns one
//   128 x 256 output tile of one expert; the producer warpgroup gives its
//   registers to the two consumers (setmaxnreg 24 / 240) and one of its
//   threads keeps TMA loads of 64-deep reduction tiles in flight through a
//   4-stage ring (48 KB a stage); each consumer multiplies 64 rows by 256
//   columns with wgmma m64n256k16 into 128 fp32 registers a thread.  Every
//   operand is read in place, through wgmma's transpose bits, with no
//   transposed copy (one would move 2.15 GB a call, 0.64 ms):
//   - dx = dy . w^T (M = C, N = D, K = F).  A is dy, whose fastest axis F is
//     the reduction: K-major, one 64 (F) x 128 (C) box a stage.  B is w^T,
//     read from w (E, D, F), whose fastest axis is F too: K-major
//     (TRANS_B = 0), one 64 (F) x 256 (D) box.
//   - dw = x^T . dy (M = D, N = F, K = C).  A is x^T, read from x (E, C, D),
//     whose fastest axis D is the output's row: MN-major (TRANS_A = 1), two
//     64 (D) x 64 (C) boxes.  B is dy, F fastest: MN-major (TRANS_B = 1),
//     four 64 (F) x 64 (C) boxes, as the forward reads w.
//   There is no split of the reduction and no float atomic: a block walks
//   all of its K in its own loop, so the result does not depend on block
//   order and two launches are equal to the bit.  dw has 16 x 3 tiles an
//   expert at gate/up (6 x 8 at down), 6144 blocks at the training shape.
//   TMA fills zeros past a ragged C, D or F (a reduction past C or F adds
//   zeros); stores past the output's rows and columns are skipped.
// * fma (fp32, or a D or F that TMA cannot stride).  One strided product
//   kernel with fp32 FMAs on the CUDA cores (exact fp32, no TF32): a block
//   of 256 threads computes one 64 x 128 output tile, staging 16-deep tiles
//   of A (transposed) and B in shared memory, each loaded with the thread
//   map that makes a warp's reads consecutive along the operand's fastest
//   axis, the next tile in registers while the current one is multiplied;
//   thread (ty, tx) owns rows 4 ty .. +3 and columns 4 tx .. +3 and
//   64 + 4 tx .. +3.  It serves the narrow fp32 checks and ragged widths.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3,
// CUDA-event means over 20 calls; PERF.md section 6, row 3b): wgmma 2.03 ms
// a call at gate/up (dx 1.17, dw 0.97) and 1.80 ms at down (dx 0.89, dw
// 1.07), 51% and 58% of the 1.042 ms bound; torch.bmm takes 1.43 and
// 1.40 ms for the same dx and dw.  dx at gate/up walks only 12 reduction
// tiles (F = 768) a block against 32 at down, so each block's ring fill and
// its 64 KB epilogue, which nothing overlaps (one block an SM, not
// persistent), are a larger share of its time there.  fma (fp32): 38.0 ms
// at gate/up (torch.bmm 19.9 ms).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// wgmma tiling.
namespace wg {
constexpr int BM = 128;  // output rows a block (two consumer warpgroups of 64)
constexpr int BN = 256;  // output columns a block
constexpr int BK = 64;   // reduction depth of a stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int HALF_A = 64 * 128;                // a consumer's 64 rows of A: 8 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
}  // namespace wg

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N), with (see the note above)
//   DW = false: dx = dy . w^T; map_a over dy (F, C, E) in (64, 128) boxes,
//     map_b over w (F, D, E) in (64, 256) boxes; M = C, N = D, K = F;
//   DW = true: dw = x^T . dy; map_a over x (D, C, E) in (64, 64) boxes,
//     map_b over dy (F, C, E) in (64, 64) boxes; M = D, N = F, K = C.
// Block (M tile, N tile, expert); out is (E, M, N), row-major.
template <typename T, bool DW>
__global__ void __launch_bounds__(wg::THREADS, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, T* __restrict__ out, int M,
                     int N, int K) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int nk = (K + BK - 1) / BK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      hopper::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const int k0 = kt * BK;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        if constexpr (DW) {  // 64-wide chunks of the output's rows and columns, K rows each
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
            hopper::tma_load_3d(a + h * HALF_A, &map_a, &full[s], m0 + 64 * h, k0, e);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_3d(b + c * BK * 128, &map_b, &full[s], n0 + 64 * c, k0, e);
        } else {  // BM and BN rows of 64 reduction values
          hopper::tma_load_3d(a, &map_a, &full[s], k0, m0, e);
          hopper::tma_load_3d(b, &map_b, &full[s], k0, n0, e);
        }
      }
    }
  } else {  // consumers: output rows 64 * warpgroup .. +63 of the tile
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
      // Either way a consumer's 64 rows of A are the stage's 8 KB at
      // warpgroup * 8 KB: 64 K-major rows of 128 bytes, or one MN-major box.
      const uint32_t a = hopper::smem_u32(smem + s * STAGE_BYTES + warpgroup * HALF_A);
      const uint32_t b = a - warpgroup * HALF_A + A_BYTES;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (DW)  // MN-major A and B: a k16 step is 16 rows, 2048 bytes
          hopper::Wgmma<BN, T>::template ss<1, 1>(
              acc, hopper::desc_sw128(a + kk * 2048, BK * 128, 1024),
              hopper::desc_sw128(b + kk * 2048, BK * 128, 1024), 1);
        else  // K-major A and B: a k16 step is 32 bytes within each 128-byte row
          hopper::Wgmma<BN, T>::template ss<0, 0>(
              acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
              hopper::desc_sw128(b + kk * 32, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();  // the products of tile kt - 1 are done: free its stage
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // acc[4j + 2i + c]: row 16 * warp + lane / 4 + 8i, column 8j + 2 (lane % 4) + c.
    const int warp = (threadIdx.x / 32) % 4;
    T* oe = out + (size_t)e * M * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 64 * warpgroup + 16 * warp + lane / 4 + 8 * i;
      if (row >= M) continue;
      T* orow = oe + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col < N)  // N is even, so col + 1 < N too
          *reinterpret_cast<uint32_t*>(orow + col) =
              hopper::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
                         int C, int D, int F, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap map_a, map_b;
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    err = hopper::make_map_3d(&map_a, dy, bf16, F, C, E, wg::BM);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_b, w, bf16, F, D, E, wg::BN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gmm_bwd_wgmma_kernel<T, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid((C + wg::BM - 1) / wg::BM, (D + wg::BN - 1) / wg::BN, E);
    gmm_bwd_wgmma_kernel<T, false><<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(
        map_a, map_b, static_cast<T*>(dx), C, D, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    err = hopper::make_map_3d(&map_a, x, bf16, D, C, E, 64);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_b, dy, bf16, F, C, E, 64);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gmm_bwd_wgmma_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid((D + wg::BM - 1) / wg::BM, (F + wg::BN - 1) / wg::BN, E);
    gmm_bwd_wgmma_kernel<T, true><<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(
        map_a, map_b, static_cast<T*>(dw), D, F, C);
    err = cudaGetLastError();
  }
  return err;
}

// fma tiling.
namespace fm {
constexpr int BM = 64;   // output rows a block
constexpr int BN = 128;  // output columns a block
constexpr int BK = 16;   // reduction depth of a tile
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // padded rows: a warp's stores spread over the banks
constexpr int LDB = BN + 4;
constexpr int A_LOADS = BM * BK / THREADS;  // 4
constexpr int B_LOADS = BK * BN / THREADS;  // 8
}  // namespace fm

// out[e] (M x N) = A[e] . B[e], A(m, k) = a[e sa_e + m sa_m + k sa_k] and
// B(k, n) = b[e sb_e + k sb_k + n sb_n] (strides in elements).  A_K: A's
// fastest axis is k (else m); B_K: B's is k (else n).  Block (N tile,
// M tile, expert); out is (E, M, N), row-major.
template <typename T, bool A_K, bool B_K>
__global__ void __launch_bounds__(fm::THREADS)
gmm_bwd_fma_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int M,
                   int N, int K, int64_t sa_e, int64_t sa_m, int64_t sa_k, int64_t sb_e,
                   int64_t sb_k, int64_t sb_n) {
  using namespace fm;
  __shared__ __align__(16) float sA[BK][LDA];  // A's tile, transposed: sA[k][m]
  __shared__ __align__(16) float sB[BK][LDB];  // B's tile: sB[k][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const T* ae = a + e * sa_e;
  const T* be = b + e * sb_e;

  // This thread's elements of each tile, consecutive along the fastest axis
  // from thread to thread.
  int am[A_LOADS], ak[A_LOADS], bk[B_LOADS], bn[B_LOADS];
#pragma unroll
  for (int j = 0; j < A_LOADS; ++j) {
    const int i = tid + j * THREADS;
    am[j] = A_K ? i / BK : i % BM;
    ak[j] = A_K ? i % BK : i / BM;
  }
#pragma unroll
  for (int j = 0; j < B_LOADS; ++j) {
    const int i = tid + j * THREADS;
    bk[j] = B_K ? i % BK : i / BN;
    bn[j] = B_K ? i / BK : i % BN;
  }

  float areg[A_LOADS], breg[B_LOADS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) {
      const int m = m0 + am[j], k = k0 + ak[j];
      areg[j] = m < M && k < K ? to_float<T>(ae[m * sa_m + k * sa_k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < B_LOADS; ++j) {
      const int k = k0 + bk[j], n = n0 + bn[j];
      breg[j] = k < K && n < N ? to_float<T>(be[k * sb_k + n * sb_n]) : 0.f;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j) sA[ak[j]][am[j]] = areg[j];
#pragma unroll
    for (int j = 0; j < B_LOADS; ++j) sB[bk[j]][bn[j]] = breg[j];
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) * BK);  // in flight while this tile is multiplied
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sA[k][4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[k][64 + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (kt + 1 < nk) {
      __syncthreads();  // every thread is done reading this tile
      store_tile();
      __syncthreads();
    }
  }

  T* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
    T* orow = oe + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) orow[n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
                       int C, int D, int F, cudaStream_t stream) {
  const int64_t c = C, d = D, f = F;
  if (dx != nullptr) {  // A(c, f) = dy[e, c, f], B(f, d) = w[e, d, f]: both k-fastest
    const dim3 grid((D + fm::BN - 1) / fm::BN, (C + fm::BM - 1) / fm::BM, E);
    gmm_bwd_fma_kernel<T, true, true><<<grid, fm::THREADS, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<T*>(dx), C, D, F,
        c * f, f, 1, d * f, 1, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {  // A(d, c) = x[e, c, d], B(c, f) = dy[e, c, f]: m- and n-fastest
    const dim3 grid((F + fm::BN - 1) / fm::BN, (D + fm::BM - 1) / fm::BM, E);
    gmm_bwd_fma_kernel<T, false, false><<<grid, fm::THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dw), D, F, C,
        c * d, 1, d, c * f, f, 1);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

bool valid(int E, int C, int D, int F) {
  return E >= 1 && C >= 1 && D >= 1 && F >= 1 && E <= 65535 && (C + 63) / 64 <= 65535 &&
         (D + 63) / 64 <= 65535 && (F + 255) / 256 <= 65535;
}

}  // namespace

// x (E, C, D), w (E, D, F), dy (E, C, F), and the outputs dx (E, C, D) and
// dw (E, D, F): contiguous device arrays of one dtype, each 16-byte
// aligned.  need_dx / need_dw: which outputs to compute (the other pointer
// may be null).  dtype: 0 float32, 1 float16, 2 bfloat16.  Each entry point
// launches its tiling's kernels (one for dx, one for dw) on `stream` and
// returns a cudaError_t (0 on success); a shape or dtype its tiling does not
// take returns cudaErrorInvalidValue.

// Tensor cores; float16 or bfloat16, D and F multiples of 8, any C.
extern "C" int repro_moe_gmm_bwd_wgmma(const void* x, const void* w, const void* dy, void* dx,
                                       void* dw, int E, int C, int D, int F, int need_dx,
                                       int need_dw, int dtype, void* stream) {
  if (!valid(E, C, D, F) || D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* dxp = need_dx ? dx : nullptr;
  void* dwp = need_dw ? dw : nullptr;
  switch (dtype) {
    case 1: return (int)launch_wgmma<__half>(x, w, dy, dxp, dwp, E, C, D, F, s);
    case 2: return (int)launch_wgmma<__nv_bfloat16>(x, w, dy, dxp, dwp, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any C, D, F and dtype.
extern "C" int repro_moe_gmm_bwd_fma(const void* x, const void* w, const void* dy, void* dx,
                                     void* dw, int E, int C, int D, int F, int need_dx,
                                     int need_dw, int dtype, void* stream) {
  if (!valid(E, C, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* dxp = need_dx ? dx : nullptr;
  void* dwp = need_dw ? dw : nullptr;
  switch (dtype) {
    case 0: return (int)launch_fma<float>(x, w, dy, dxp, dwp, E, C, D, F, s);
    case 1: return (int)launch_fma<__half>(x, w, dy, dxp, dwp, E, C, D, F, s);
    case 2: return (int)launch_fma<__nv_bfloat16>(x, w, dy, dxp, dwp, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
