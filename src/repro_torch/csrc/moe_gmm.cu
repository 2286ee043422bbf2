// Grouped (per-expert) matmul for the MoE expert products, for Hopper.
//
// Replaces the Pallas TPU kernel `moe_gmm` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm.py.  It computes the same function: for each
// expert e, out[e] = x[e] @ w[e] with x (E, C, D), w (E, D, F) and out
// (E, C, F), products summed in an fp32 accumulator and the result cast to
// x's dtype.  The TPU kernel's innermost sequential D grid axis, whose
// accumulator lives in VMEM scratch, becomes a loop over D tiles inside one
// thread block with the accumulator in registers.  The TPU wrapper requires
// C, D and F to be multiples of its blocks; every tiling here takes ragged
// C, D and F (loads past an edge read zero, stores past it are skipped), so
// the wrapper pads nothing.  x and w are contiguous and row-major, so F is
// the fastest axis of w.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the MoE
// serving shapes of qwen3-moe-30b-a3b (E = 128, bf16):
//   prefill gate/up, C = 312, D = 2048, F = 768: 2*E*C*D*F = 125.6 GFLOP,
//     0.127 ms; (E*C*D + E*D*F + E*C*F) * 2 bytes = 628 MB, 0.187 ms:
//     bound by bytes, because the capacity buffer multiplies every expert's
//     full weights;
//   decode, C = 1, every expert holding a row: 403 MB of weights, 0.120 ms:
//     bound by bytes.  The bound depends on the data: an expert whose rows
//     of x are all zero needs none of its weights (for finite weights
//     0 * w = 0), so the least time counts only the weights of experts that
//     hold a non-zero row, plus x and out.  At the served decode (4 tokens,
//     top 8, C = max(1, int(1.25 * 32 / 128)) = 1) at most 32 of the 128
//     experts hold a row: about 100 MB for gate or up, 0.030 ms.
//
// Three tilings, one C entry point each; kernels/moe_gmm.py's `gmm_tiling`
// chooses among them:
//
// * wgmma (C > 16, bf16/fp16, D and F multiples of 8; every prefill product
//   of the served model).  A warp-specialised tensor-core GEMM.  A block of
//   three warpgroups owns one 128 (C) x 256 (F) output tile of one expert;
//   the grid is (C tiles, F tiles, E), so one expert's tiles are neighbours
//   in launch order, C tiles fastest: the three C tiles that read one w tile
//   and the F tiles that read one x tile meet in L2, and each expert's
//   x (1.28 MB) and w (3.1 MB) come from device memory about once.  The
//   producer warpgroup gives its registers to the consumers (setmaxnreg) and
//   one of its threads starts TMA loads of 64-deep D tiles into a 4-stage
//   ring (x 128 x 64 and w 64 x 256 a stage, 48 KB; 192 KB in all).  TMA
//   fills zeros past C (312 = 2 x 128 + 56) and past a ragged D, so no load
//   is masked.  Each of the two consumer warpgroups multiplies 64 rows by
//   256 columns with wgmma m64n256k16, x as a K-major A operand and w as an
//   MN-major B operand (F is its fastest axis: the transpose bit), keeping
//   128 fp32 accumulators a thread in registers.  A consumer releases a stage
//   once the products that read it have finished (one wgmma group stays in
//   flight).  The epilogue casts to x's dtype and stores rows < C and
//   columns < F.  What this does about the byte bound: every x and w byte is
//   read from device memory about once, and the tensor cores take the
//   operations below the time those bytes need.
// * fma (C > 16, fp32, or a D or F that TMA cannot stride).  The grid is
//   (F tiles, C tiles, E).  A block of 256 threads computes one 64 (C) x 128
//   (F) output tile with fp32 FMAs on the CUDA cores; it walks D in tiles of
//   16, staging x's 64 x 16 tile transposed and w's 16 x 128 tile in shared
//   memory as fp32, loading the next D tile into registers while the
//   current one is multiplied.  Thread (ty, tx) of a 16 x 16 grid owns rows
//   4*ty .. 4*ty+3 and columns 4*tx .. +3 and 64+4*tx .. +3.  Exact fp32.
// * skinny (C <= 16; decode, C = 1).  A weight stream that skips experts
//   holding no row.  The grid is (C / R row groups, F / BF slabs, E), R = 1
//   (C = 1) or 4 rows of x a block, BF = 256 bytes of columns (128 bf16 /
//   fp16, 64 fp32): 6 slabs at F = 768, so the 30-odd live experts of a
//   decode step still give about 190 working blocks for 132 SMs.  A block
//   first loads its R rows of x (all D of them, as fp32 in shared memory);
//   if every value is 0 it writes zeros and returns before any weight load
//   is issued (`__syncthreads_or`), so an empty expert costs a few KB of x.
//   Otherwise one producer warp streams the slab of w[e] through a ring of
//   6 stages of 32 rows (8 KB each, 48 KB in flight a block, three blocks
//   an SM: Little's law at 3.35 TB/s and about 1 us asks for 25 KB an SM):
//   one thread issues one TMA box (256 bytes x 32 rows) a stage, completing
//   on the stage's mbarrier.  (A bulk copy a row instead, 32 a stage, was
//   bound by the rate at which the copies are issued, not by HBM.)  Eight
//   consumer warps wait on it; thread (cg, rl)
//   reads 16 bytes (one column group) of rows rl and rl + 16 from the stage
//   and multiplies them by x's values in fp32, and each warp frees the
//   stage with one arrive.  The 16 partial sums of each output are then
//   added in the ring in a fixed order (no atomics: the result does not
//   depend on block order).  TMA fills zeros past D and F; columns past F
//   are never stored.  When w's rows are not 16-byte aligned (ragged F) the
//   producer's lanes load and store the rows instead of TMA.  What this
//   does about the byte bound: weights of empty experts are never read, and
//   the rest are read once with enough bytes in flight to keep HBM busy.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3,
// CUDA-event means over 20 launches; PERF.md section 6, row 3): wgmma
// 0.297 ms at the prefill gate/up shape and 0.326 ms at the down shape
// (torch.bmm 0.240 and 0.222 ms; bound 0.187 ms by bytes); the fma tiling
// takes 3.57 ms on the same bf16 inputs and 3.39 ms in fp32.  Skinny:
// 0.139 ms with every expert filled (torch.bmm 0.137 ms, bound 0.120 ms;
// the first version took 0.164 ms), and 0.043 ms on a decode step's own
// buffers with 29 live experts (bound 0.027 ms; bmm, which reads every
// expert, 0.137 ms).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SKINNY_MAX_C = 16;

// Tiled kernel.
constexpr int BC = 64;   // rows of x per block
constexpr int BF = 128;  // columns of w per block
constexpr int BD = 16;   // depth of one D tile
constexpr int LDA = BC + 4;


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

// N consecutive values of a row, as fp32: one vector load when `vec` (the
// run is in bounds and 8- or 16-byte aligned), else element by element with
// zeros past `limit`.
template <typename T, int N>
__device__ __forceinline__ void load_run(float* f, const T* __restrict__ p, int start, int limit,
                                         bool vec) {
  static_assert(N * sizeof(T) == 8 || N * sizeof(T) == 16, "8- or 16-byte runs");
  if (vec && start + N <= limit) {
    if constexpr (N * sizeof(T) == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + start);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = to_float<T>(e[j]);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + start);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = to_float<T>(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = start + j < limit ? to_float<T>(p[start + j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gmm_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int C,
                 int D, int F, int vec_x, int vec_w) {
  constexpr int VW = 16 / sizeof(T);            // w values per 16-byte load
  constexpr int W_LOADS = BD * BF / VW / THREADS;  // 1 (16-bit types) or 2 (fp32)
  constexpr int X_RUN = 4;                      // x values per thread and tile
  static_assert(BC * BD == X_RUN * THREADS, "one run of x per thread");

  __shared__ __align__(16) float sA[BD][LDA];  // x tile, transposed: sA[d][c]
  __shared__ __align__(16) float sB[BD][BF];   // w tile: sB[d][f]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int f0 = blockIdx.x * BF;
  const int c0 = blockIdx.y * BC;
  const int e = blockIdx.z;

  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;

  // This thread's share of each tile: x row xc, columns xd .. xd+3 of the
  // D tile; w rows wr[j], columns wf[j] .. wf[j]+VW-1 of the F tile.
  const int xc = tid / (BD / X_RUN);
  const int xd = (tid % (BD / X_RUN)) * X_RUN;
  const bool x_row_in = c0 + xc < C;
  const T* xrow = xe + (size_t)(x_row_in ? c0 + xc : 0) * D;
  int wr[W_LOADS], wf[W_LOADS];
#pragma unroll
  for (int j = 0; j < W_LOADS; ++j) {
    const int i = tid + j * THREADS;
    wr[j] = i / (BF / VW);
    wf[j] = (i % (BF / VW)) * VW;
  }

  float xreg[X_RUN], wreg[W_LOADS][VW];
  auto load_tile = [&](int d0) {
    if (x_row_in) {
      load_run<T, X_RUN>(xreg, xrow, d0 + xd, D, vec_x);
    } else {
#pragma unroll
      for (int j = 0; j < X_RUN; ++j) xreg[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j) {
      const int d = d0 + wr[j];
      if (d < D) {
        load_run<T, VW>(wreg[j], we + (size_t)d * F, f0 + wf[j], F, vec_w);
      } else {
#pragma unroll
        for (int v = 0; v < VW; ++v) wreg[j][v] = 0.f;
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < X_RUN; ++j) sA[xd + j][xc] = xreg[j];
#pragma unroll
    for (int j = 0; j < W_LOADS; ++j)
#pragma unroll
      for (int v = 0; v < VW; v += 4)
        *reinterpret_cast<float4*>(&sB[wr[j]][wf[j] + v]) =
            make_float4(wreg[j][v], wreg[j][v + 1], wreg[j][v + 2], wreg[j][v + 3]);
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nd = (D + BD - 1) / BD;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < nd; ++kt) {
    if (kt + 1 < nd) load_tile((kt + 1) * BD);  // in flight while this tile is multiplied
#pragma unroll
    for (int k = 0; k < BD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[k][4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[k][64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nd) {
      __syncthreads();  // every thread is done reading this tile
      store_tile();
      __syncthreads();
    }
  }

  T* oe = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c >= C) continue;
    T* orow = oe + (size_t)c * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (f < F) orow[f] = from_float<T>(acc[i][j]);
    }
  }
}

// Skinny kernel: a weight stream through a ring of TMA boxes.
namespace sk {
constexpr int ROW_BYTES = 256;                 // bytes of one w row in a block's F slab
constexpr int CG = ROW_BYTES / 16;             // 16-byte column groups of a slab row
constexpr int CONSUMERS = 256;                 // 8 consumer warps
constexpr int RL = CONSUMERS / CG;             // consumers that share a column group
constexpr int BLOCK = CONSUMERS + 32;          // and one producer warp
constexpr int DS = 32;                         // w rows a stage holds: one a producer lane
constexpr int STAGES = 6;
constexpr int STAGE_BYTES = DS * ROW_BYTES;    // 8 KB
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BAR_BYTES = 256;                 // 2 * STAGES mbarriers, padded
constexpr int MAX_SMEM = 232448;               // what a block may use on the H100
static_assert(DS % RL == 0 && DS <= 256, "whole rows a consumer; a TMA box is <= 256 rows");
static_assert(2 * STAGES * 8 <= BAR_BYTES, "the mbarriers fit");

// Dynamic shared memory: the ring (1024-byte aligned, hence the 1024 more),
// the mbarriers and R rows of x over D as fp32.
inline size_t smem_bytes(int R, int D) {
  return 1024 + RING_BYTES + BAR_BYTES + (size_t)R * D * sizeof(float);
}
}  // namespace sk

// Block (row group, F slab, expert): out[e, c0 .. c0+R-1, f0 .. f0+BF-1].
// TMA: w's rows are 16-byte aligned (F * sizeof(T) a multiple of 16), so the
// producer loads each stage as one TMA box through map_w (F, D, E); otherwise
// its lanes load and store the rows (ragged F, off the served path).
template <typename T, int R, bool TMA>
__global__ void __launch_bounds__(sk::BLOCK)
gmm_skinny_kernel(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x,
                  const T* __restrict__ w, T* __restrict__ out, int C, int D, int F) {
  using namespace sk;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BF = ROW_BYTES / sizeof(T);  // columns of w per block
  static_assert(RL * R * BF * sizeof(float) <= RING_BYTES, "the reduction fits in the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
  uint64_t* empty = full + STAGES;
  float* sx = reinterpret_cast<float*>(ring + RING_BYTES + BAR_BYTES);  // sx[r * D + d]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * R;
  const int f0 = blockIdx.y * BF;
  const int e = blockIdx.z;
  const int rows = min(R, C - c0);   // rows of x this block multiplies
  const int cols = min(BF, F - f0);  // columns of its slab inside F
  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;
  T* oe = out + (size_t)e * C * F;

  // x's rows first, as fp32.  A block whose rows are all zero (an expert
  // that no token was routed to) writes zeros and issues no weight load.
  bool nonzero = false;
  if (D * sizeof(T) % 16 == 0) {  // 16-byte loads: one or two a thread at the served shapes
    constexpr int VX = 16 / sizeof(T);
    const int nv = D / VX;
    for (int i = tid; i < R * nv; i += BLOCK) {
      const int r = i / nv, k = i - r * nv;
      float f[VX];
      if (r < rows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xe + (size_t)(c0 + r) * D + k * VX);
        const T* ev = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < VX; ++v) f[v] = to_float<T>(ev[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VX; ++v) f[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < VX; v += 4) {
        *reinterpret_cast<float4*>(&sx[r * D + k * VX + v]) =
            make_float4(f[v], f[v + 1], f[v + 2], f[v + 3]);
        nonzero |= f[v] != 0.f || f[v + 1] != 0.f || f[v + 2] != 0.f || f[v + 3] != 0.f;
      }
    }
  } else {
    for (int r = 0; r < R; ++r)
#pragma unroll 4
      for (int d = tid; d < D; d += BLOCK) {
        const float v = r < rows ? to_float<T>(xe[(size_t)(c0 + r) * D + d]) : 0.f;
        sx[r * D + d] = v;
        nonzero |= v != 0.f;  // NaN counts as non-zero
      }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], TMA ? 1 : 32);  // the expect_tx arrive, or every lane's
      hopper::mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  if (!__syncthreads_or(nonzero)) {
    for (int i = tid; i < R * BF; i += BLOCK) {
      const int r = i / BF, j = i % BF;
      if (r < rows && j < cols) oe[(size_t)(c0 + r) * F + f0 + j] = from_float<T>(0.f);
    }
    return;
  }

  const int nst = (D + DS - 1) / DS;
  if (tid >= CONSUMERS) {  // producer warp: stage i holds w rows i*DS .. i*DS+DS-1
    const int lane = tid - CONSUMERS;
    for (int i = 0; i < nst; ++i) {
      const int s = i % STAGES;
      const int d0 = i * DS;
      if constexpr (TMA) {  // one box of DS rows x BF columns; zeros past D and F
        if (lane == 0) {
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          hopper::tma_load_3d(ring + s * STAGE_BYTES, &map_w, &full[s], f0, d0, e);
        }
      } else {
        if (lane == 0) hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        __syncwarp();
        T* st = reinterpret_cast<T*>(ring + s * STAGE_BYTES);
        for (int r = 0; r < min(DS, D - d0); ++r)
          for (int j = lane; j < BF; j += 32)
            st[r * BF + j] = j < cols ? we[(size_t)(d0 + r) * F + f0 + j] : from_float<T>(0.f);
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: column group cg (VEC columns), rows rl, rl + RL, ... of each
  // stage.  Rows past D are never read; columns past F are never stored.
  const int lane = tid & 31;
  const int cg = tid % CG;
  const int rl = tid / CG;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int i = 0; i < nst; ++i) {
    const int s = i % STAGES;
    const int d0 = i * DS;
    const int nrows = min(DS, D - d0);
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* src = ring + s * STAGE_BYTES + cg * 16;
#pragma unroll
    for (int k = 0; k < DS / RL; ++k) {
      const int r = rl + k * RL;
      if (r < nrows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ROW_BYTES);
        const T* ev = reinterpret_cast<const T*>(&raw);
        float wv[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = to_float<T>(ev[v]);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float xv = sx[rr * D + d0 + r];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[rr][v] = fmaf(xv, wv[v], acc[rr][v]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // The RL partial sums of each output, added in a fixed order in the ring
  // (every stage has been read: named barrier 1 over the consumers alone).
  float* red = reinterpret_cast<float*>(ring);  // red[(k * R + r) * BF + j]
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(&red[(rl * R + r) * BF + cg * VEC + v]) =
          make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int i = tid; i < R * BF; i += CONSUMERS) {
    const int r = i / BF, j = i % BF;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < RL; ++k) sum += red[(k * R + r) * BF + j];
    if (r < rows && j < cols) oe[(size_t)(c0 + r) * F + f0 + j] = from_float<T>(sum);
  }
}

// wgmma kernel.
namespace wg {
constexpr int BM = 128;  // rows of x per block (two consumer warpgroups of 64)
constexpr int BN = 256;  // columns of w per block (four 64-wide TMA boxes)
constexpr int BK = 64;   // depth of one D tile (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
}  // namespace wg

template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, T* __restrict__ out, int C, int D,
                 int F) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int c0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int nk = (D + BK - 1) / BK;
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
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_3d(a, &map_x, &full[s], kt * BK, c0, e);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          hopper::tma_load_3d(b + c * BK * 128, &map_w, &full[s], f0 + 64 * c, kt * BK, e);
      }
    }
  } else {  // consumers: rows 64 * warpgroup .. +63 of the tile
    hopper::regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = hopper::smem_u32(smem + s * STAGE_BYTES + warpgroup * (64 * 128));
      const uint32_t b = a - warpgroup * (64 * 128) + A_BYTES;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::Wgmma<BN, T>::template ss<1>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                                             hopper::desc_sw128(b + kk * 2048, BK * 128, 1024),
                                             1);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();  // the products of tile kt - 1 are done: free its stage
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // acc[4j + 2i + c]: row 16 * warp + lane / 4 + 8i, column 8j + 2 (lane % 4) + c.
    const int warp = (threadIdx.x / 32) % 4;
    T* oe = out + (size_t)e * C * F;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = c0 + 64 * warpgroup + 16 * warp + lane / 4 + 8 * i;
      if (row >= C) continue;
      T* orow = oe + (size_t)row * F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = f0 + 8 * j + 2 * (lane % 4);
        if (col < F)  // F is even, so col + 1 < F too
          *reinterpret_cast<uint32_t*>(orow + col) =
              hopper::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                         cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap map_x, map_w;
  cudaError_t err = hopper::make_map_3d(&map_x, x, bf16, D, C, E, wg::BM);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_3d(&map_w, w, bf16, F, D, E, wg::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gmm_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + wg::BM - 1) / wg::BM, (F + wg::BN - 1) / wg::BN, E);
  gmm_wgmma_kernel<T><<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(map_x, map_w,
                                                                     static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // Vector loads need every row to start on a vector boundary (the base
  // pointers are 16-byte aligned by the caller).
  const dim3 grid((F + BF - 1) / BF, (C + BC - 1) / BC, E);
  gmm_tiled_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, D, F,
      D % 4 == 0, F % VEC == 0);
  return cudaGetLastError();
}

template <typename T, int R, bool TMA>
cudaError_t launch_skinny_r(const void* x, const void* w, void* out, int E, int C, int D, int F,
                            cudaStream_t stream) {
  constexpr int BF = sk::ROW_BYTES / sizeof(T);
  CUtensorMap map_w = {};
  cudaError_t err = cudaSuccess;
  if (TMA)
    err = hopper::make_map_3d_plain(&map_w, w, sizeof(T), std::is_same<T, __nv_bfloat16>::value,
                                    F, D, E, (uint64_t)F * sizeof(T),
                                    (uint64_t)D * F * sizeof(T), BF, sk::DS);
  if (err != cudaSuccess) return err;
  const size_t smem = sk::smem_bytes(R, D);
  err = cudaFuncSetAttribute(gmm_skinny_kernel<T, R, TMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + R - 1) / R, (F + BF - 1) / BF, E);
  gmm_skinny_kernel<T, R, TMA><<<grid, sk::BLOCK, smem, stream>>>(
      map_w, static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

// R = 4 rows of x a block for C > 1 where they fit in shared memory, else 1.
// TMA where w's rows are 16-byte aligned (F * sizeof(T) a multiple of 16).
template <typename T>
cudaError_t launch_skinny(const void* x, const void* w, void* out, int E, int C, int D, int F,
                          cudaStream_t stream) {
  if (sk::smem_bytes(1, D) > sk::MAX_SMEM) return cudaErrorInvalidValue;
  const bool r4 = C > 1 && sk::smem_bytes(4, D) <= sk::MAX_SMEM;
  const bool tma = (size_t)F * sizeof(T) % 16 == 0;
  if (r4)
    return tma ? launch_skinny_r<T, 4, true>(x, w, out, E, C, D, F, stream)
               : launch_skinny_r<T, 4, false>(x, w, out, E, C, D, F, stream);
  return tma ? launch_skinny_r<T, 1, true>(x, w, out, E, C, D, F, stream)
             : launch_skinny_r<T, 1, false>(x, w, out, E, C, D, F, stream);
}

bool valid(int E, int C, int D, int F) {
  return E >= 1 && C >= 1 && D >= 1 && F >= 1 && E <= 65535 && (C + 63) / 64 <= 65535 &&
         (F + 127) / 128 <= 65535;
}

}  // namespace

// x (E, C, D), w (E, D, F), out (E, C, F): contiguous device arrays of one
// dtype, each 16-byte aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.
// Each entry point launches one tiling on `stream` and returns a
// cudaError_t (0 on success); a shape or dtype its tiling does not take
// returns cudaErrorInvalidValue.

// Tensor cores; C > 16, float16 or bfloat16, D and F multiples of 8.
extern "C" int repro_moe_gmm_wgmma(const void* x, const void* w, void* out, int E, int C, int D,
                                   int F, int dtype, void* stream) {
  if (!valid(E, C, D, F) || C <= SKINNY_MAX_C || D % 8 != 0 || F % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)launch_wgmma<__half>(x, w, out, E, C, D, F, s);
    case 2: return (int)launch_wgmma<__nv_bfloat16>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 FMAs on the CUDA cores; any C, D, F and dtype.
extern "C" int repro_moe_gmm_fma(const void* x, const void* w, void* out, int E, int C, int D,
                                 int F, int dtype, void* stream) {
  if (!valid(E, C, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fma<float>(x, w, out, E, C, D, F, s);
    case 1: return (int)launch_fma<__half>(x, w, out, E, C, D, F, s);
    case 2: return (int)launch_fma<__nv_bfloat16>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The weight stream for C <= 16 and D <= 49,000 or so (x's rows, in fp32,
// must fit in shared memory beside the ring); any F and dtype.
extern "C" int repro_moe_gmm_skinny(const void* x, const void* w, void* out, int E, int C, int D,
                                    int F, int dtype, void* stream) {
  if (!valid(E, C, D, F) || C > SKINNY_MAX_C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_skinny<float>(x, w, out, E, C, D, F, s);
    case 1: return (int)launch_skinny<__half>(x, w, out, E, C, D, F, s);
    case 2: return (int)launch_skinny<__nv_bfloat16>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
