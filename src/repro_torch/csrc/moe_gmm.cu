// Grouped (per-expert) matmul for the MoE expert products, for Hopper.
//
// Replaces the Pallas TPU kernel `moe_gmm` / `_gmm_kernel` in
// src/repro/kernels/moe_gmm.py.  It computes the same function: for each
// expert e, out[e] = x[e] @ w[e] with x (E, C, D), w (E, D, F) and out
// (E, C, F), products summed in an fp32 accumulator and the result cast to
// x's dtype.  The TPU kernel's innermost sequential D grid axis, whose
// accumulator lives in VMEM scratch, becomes a loop over D tiles inside one
// thread block with the accumulator in registers.  The TPU wrapper requires
// C, D and F to be multiples of its blocks; this kernel takes any C, D, F
// >= 1 and masks rows c >= C and the tails of D and F itself (loads past an
// edge read zero, stores past it are skipped), so its wrapper pads nothing.
// x and w are contiguous and row-major, so F is the fastest axis of w.
//
// Two tilings of the same function, chosen by C:
//
// * Tiled (C > SKINNY_MAX_C; prefill, C = 312 at the serving shape).  The
//   grid is (F tiles, C tiles, E).  A block of 256 threads computes one
//   64 (C) x 128 (F) output tile; it walks D in tiles of 16, staging x's
//   64 x 16 tile transposed and w's 16 x 128 tile in shared memory as fp32.
//   The next D tile is loaded into registers while the current one is
//   multiplied.  Thread (ty, tx) of a 16 x 16 grid owns rows 4*ty .. 4*ty+3
//   and columns 4*tx .. 4*tx+3 and 64+4*tx .. 64+4*tx+3 (a 4 x 8 register
//   tile), so a half-warp reads 256 contiguous bytes of each w row in shared
//   memory.  w's tile is read from device memory as 16-byte vectors along F
//   by consecutive threads.  C = 312 is 4 full row tiles and one of 56 rows.
//
// * Skinny (C <= SKINNY_MAX_C; decode, C = 1).  Here each launch is a
//   stream of the experts' weights (403 MB at E = 128, D = 2048, F = 768 in
//   bf16) with R = 1 (C = 1) or R = 4 rows of x to multiply them by.  The
//   grid is (C / R row groups, F / (32 * VEC), E); the row groups of one w
//   tile are neighbours in the launch order, so they share it through L2.
//   A block of 8 warps owns 32 * VEC columns of F (VEC = 8 bf16/fp16 or 4
//   fp32 values, one 16-byte load); lane l reads columns l*VEC .. l*VEC+VEC-1
//   of a w row, so a warp reads 512 contiguous bytes of that row, and warp
//   i reads rows d = i, i + 8, i + 16, ...  x's rows are staged in shared
//   memory 256 columns at a time.  The 8 warps' partial sums are added in
//   shared memory at the end, in a fixed order.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the MoE
// serving shapes of qwen3-moe-30b-a3b (E = 128, bf16):
//   prefill gate/up, C = 312, D = 2048, F = 768: 2*E*C*D*F = 125.6 GFLOP,
//     0.127 ms; (E*C*D + E*D*F + E*C*F) * 2 bytes = 628 MB, 0.187 ms:
//     bound by bytes, because the capacity buffer multiplies every expert's
//     full weights;
//   decode, C = 1: 403 MB of weights, 0.120 ms: bound by bytes.
// This first version does its products as fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak), so at prefill it is bound by those operations and sits
// far above the byte bound; at decode the skinny tiling reads each weight
// once, in coalesced 16-byte vectors, which is all a byte bound asks.
// Tensor-core products (mma.sync, then wgmma with TMA) are the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SKINNY_MAX_C = 16;

// Tiled kernel.
constexpr int BC = 64;   // rows of x per block
constexpr int BF = 128;  // columns of w per block
constexpr int BD = 16;   // depth of one D tile
constexpr int LDA = BC + 4;

// Skinny kernel.
constexpr int WARPS = THREADS / 32;
constexpr int DK = 256;  // columns of x staged at a time

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

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
gmm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int C,
                  int D, int F, int vec_w) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BFS = 32 * VEC;  // columns of w per block
  __shared__ __align__(16) float sX[R][DK];
  __shared__ __align__(16) float sRed[WARPS][R][BFS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.x * R;
  const int f0 = blockIdx.y * BFS;
  const int e = blockIdx.z;
  const int f = f0 + lane * VEC;

  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;

  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int dk = 0; dk < D; dk += DK) {
    const int dlen = min(DK, D - dk);
    __syncthreads();  // the previous chunk's readers of sX are done
    for (int i = tid; i < R * DK; i += THREADS) {
      const int r = i / DK, d = i % DK;
      sX[r][d] = (c0 + r < C && d < dlen) ? to_float<T>(xe[(size_t)(c0 + r) * D + dk + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = warp; dd < dlen; dd += WARPS) {
      float wv[VEC];
      load_run<T, VEC>(wv, we + (size_t)(dk + dd) * F, f, F, vec_w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = sX[r][dd];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(&sRed[warp][r][lane * VEC + v]) =
          make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
  __syncthreads();
  T* oe = out + (size_t)e * C * F;
  for (int i = tid; i < R * BFS; i += THREADS) {
    const int r = i / BFS, j = i % BFS;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += sRed[k][r][j];
    if (c0 + r < C && f0 + j < F) oe[(size_t)(c0 + r) * F + f0 + j] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  constexpr int VEC = 16 / sizeof(T);
  // Vector loads need every row to start on a vector boundary (the base
  // pointers are 16-byte aligned by the caller).
  const int vec_w = F % VEC == 0;
  if (C <= SKINNY_MAX_C) {
    constexpr int BFS = 32 * VEC;
    const unsigned groups_f = (F + BFS - 1) / BFS;
    if (C == 1) {
      gmm_skinny_kernel<T, 1><<<dim3(1, groups_f, E), THREADS, 0, stream>>>(xp, wp, op, C, D, F,
                                                                            vec_w);
    } else {
      gmm_skinny_kernel<T, 4><<<dim3((C + 3) / 4, groups_f, E), THREADS, 0, stream>>>(
          xp, wp, op, C, D, F, vec_w);
    }
  } else {
    const int vec_x = D % 4 == 0;
    const dim3 grid((F + BF - 1) / BF, (C + BC - 1) / BC, E);
    gmm_tiled_kernel<T><<<grid, THREADS, 0, stream>>>(xp, wp, op, C, D, F, vec_x, vec_w);
  }
  return cudaGetLastError();
}

}  // namespace

// x (E, C, D), w (E, D, F), out (E, C, F): contiguous device arrays of one
// dtype, each 16-byte aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.
// Launches on `stream` and returns a cudaError_t (0 on success).
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int E, int C, int D, int F,
                             int dtype, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 || (C + BC - 1) / BC > 65535 ||
      (F + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w, out, E, C, D, F, s);
    case 1: return (int)launch<__half>(x, w, out, E, C, D, F, s);
    case 2: return (int)launch<__nv_bfloat16>(x, w, out, E, C, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
