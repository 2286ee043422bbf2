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
// * wgmma (bf16/fp16, D and F multiples of 8, any C).  A warp-specialised
//   block of three warpgroups: the producer gives its registers to the two
//   consumers (setmaxnreg 40 / 232) and one of its threads keeps TMA loads
//   of 64-deep reduction tiles in flight through a 4-stage ring (48 KB a
//   stage); each consumer multiplies 64 rows by 256 columns of a 128 x 256
//   output tile with wgmma m64n256k16 into 128 fp32 registers a thread.
//   Every operand is read in place, through wgmma's transpose bits, with no
//   transposed copy (one would move 2.15 GB a call, 0.64 ms):
//   - dx = dy . w^T (M = C, N = D, K = F).  A is dy, whose fastest axis F is
//     the reduction: K-major, one 64 (F) x 128 (C) box a stage.  B is w^T,
//     read from w (E, D, F), whose fastest axis is F too: K-major
//     (TRANS_B = 0), two 64 (F) x 128 (D) boxes.
//   - dw = x^T . dy (M = D, N = F, K = C).  A is x^T, read from x (E, C, D),
//     whose fastest axis D is the output's row: MN-major (TRANS_A = 1), two
//     64 (D) x 64 (C) boxes.  B is dy, F fastest: MN-major (TRANS_B = 1),
//     four 64 (F) x 64 (C) boxes, as the forward reads w.
//   The launch is persistent and in pairs (`launch_product`, from the
//   card's SM count):
//   - One block an SM walks many tiles, expert-major so that the tiles that
//     read one expert's operands run side by side in L2, as the forward's
//     grid order does.  The barriers are set up once, and the ring runs on
//     across tiles: the producer loads the next tile's stages while the
//     consumers finish a tile.
//   - Two blocks of a cluster take adjacent M tiles of one expert and one N
//     tile, so they read the same B boxes; each loads its own copy, and a
//     stage is free once the consumers of both blocks have released it
//     (remote mbarrier arrives), which keeps the pair in step.  With an odd
//     count of M tiles the last pair's second block computes zeros and
//     stores nothing; an expert of one M tile launches blocks alone.
//   - The epilogue rounds each 64 x 64 box into one of two 8 KB buffers a
//     consumer warpgroup (the 128-byte swizzle: conflict-free 4-byte
//     writes) and one thread stores it by TMA, whole lines, clipped at
//     ragged edges, while the next box is written; the consumers go on to
//     the next tile's products while the stores drain.  Shared memory: 4 x
//     48 KB + 32 KB.  A 64 KB staging of the whole tile would leave room
//     for 3 stages only, and a ring of 3 made the kernel 7-9% slower
//     called back to back (tools/gmm_bwd_variants.py).
//   There is no split of the reduction and no float atomic: a block walks
//   all of its K in its own loop, with the same m64n256k16 steps from k = 0
//   as the first (non-persistent) design, so the bits do not depend on the
//   schedule, two launches are equal, and both designs agree to the bit.
//   TMA fills zeros past a ragged C, D or F (a reduction past C or F adds
//   zeros).
// * fma (fp32, or a D or F that TMA cannot stride).  One strided product
//   kernel with fp32 FMAs on the CUDA cores (exact fp32, no TF32): a block
//   of 256 threads computes one 64 x 128 output tile, staging 16-deep tiles
//   of A (transposed) and B in shared memory, each loaded with the thread
//   map that makes a warp's reads consecutive along the operand's fastest
//   axis, the next tile in registers while the current one is multiplied;
//   thread (ty, tx) owns rows 4 ty .. +3 and columns 4 tx .. +3 and
//   64 + 4 tx .. +3.  It serves the narrow fp32 checks and ragged widths.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6, row 3b):
// - in turns with the first, non-persistent design on one card
//   (tools/time_bag_checks.py --gmm-moe), dx + dw a call: 1.497 ms at
//   gate/up and 1.473 at down, against 1.981 and 1.780, torch.bmm 1.43 and
//   1.41 for the same dx and dw;
// - called back to back for 1.5 s (tools/gmm_bwd_variants.py): 1.734 and
//   1.747 ms, bmm 1.661 and 1.680, both at the card's 700 W limit and an SM
//   clock of 1335-1418 MHz (its maximum is 1980).  Blocks alone walking the
//   same tiles: 1.823 and 1.835, so the pairs stay.  Pairs sharing B by a
//   TMA multicast: 1.719 and 1.736, under the run-to-run spread, so each
//   block loads its own B.
// fma (fp32): 38.0 ms at gate/up (torch.bmm 19.9 ms).
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
constexpr int BM = 128;  // output rows a tile (two consumer warpgroups of 64)
constexpr int BN = 256;  // output columns a tile
constexpr int BK = 64;   // reduction depth of a stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int HALF_A = 64 * 128;                // a consumer's 64 rows of A: 8 KB
constexpr int HALF_B = B_BYTES / 2;             // 128 columns of B
constexpr int OUT_BOX = 64 * 128;               // 64 x 64 output values: one TMA store, 8 KB
constexpr int OUT_BYTES = 2 * 2 * OUT_BOX;      // two boxes a consumer warpgroup, in turns
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
}  // namespace wg

// out[e] (M x N) = A[e] (M x K) . B[e] (K x N), with (see the note above)
//   DW = false: dx = dy . w^T; map_a over dy (F, C, E) in (64, 128) boxes,
//     map_b over w (F, D, E) in (64, 128) boxes; M = C, N = D, K = F;
//   DW = true: dw = x^T . dy; map_a over x (D, C, E) in (64, 64) boxes,
//     map_b over dy (F, C, E) in (64, 64) boxes; M = D, N = F, K = C;
// map_out over out (N, M, E), row-major, in (64, 64) boxes.
//
// Persistent: a block walks units (e, m pair, n tile), expert-major with m
// fastest, from its cluster's index in steps of the number of clusters, and
// computes the M tile 2 * (m pair) + rank of each.  Launched in clusters of
// two, the pair reads the same B boxes at the same time: a stage is free
// only once the consumers of both blocks have released it, which keeps the
// two in step.  A block whose M tile lies past M (an odd count of M tiles)
// computes zeros and stores nothing, so the pair keeps step.
template <typename T, bool DW>
__global__ void __launch_bounds__(wg::THREADS, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_out, int M, int N, int K,
                     int E) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* staged = smem + STAGES * STAGE_BYTES;  // the epilogue's boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int pair = (int)hopper::cluster_nctarank();  // 1 or 2
  const int rank = (int)hopper::cluster_ctarank();
  const int tiles_m = (M + BM - 1) / BM;
  const int pairs_m = (tiles_m + pair - 1) / pair;
  const int per_expert = pairs_m * ((N + BN - 1) / BN);
  const int units = E * per_expert;
  const int first = blockIdx.x / pair, step = gridDim.x / pair;
  const int nk = (K + BK - 1) / BK;
  const int warpgroup = threadIdx.x / 128;
  // The unit's expert and this block's output tile in it.
  auto tile = [&](int u, int& e, int& m0, int& n0) {
    e = u / per_expert;
    const int r = u - e * per_expert;
    m0 = ((r % pairs_m) * pair + rank) * BM;
    n0 = (r / pairs_m) * BN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);  // the producer's arrive, plus the TMA bytes
      hopper::mbar_init(&empty[s], 8 * pair);  // one arrive per consumer warp of the pair
    }
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();

  if (warpgroup == 2) {  // producer
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      // The ring runs on across tiles: stage it % STAGES, round it / STAGES.
      int it = 0;
      for (int u = first; u < units; u += step) {
        int e, m0, n0;
        tile(u, e, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          const int k0 = kt * BK;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* a = smem + s * STAGE_BYTES;
          uint8_t* b = a + A_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          if constexpr (DW) {  // 64-wide chunks of the output's rows, K rows each
#pragma unroll
            for (int h = 0; h < BM / 64; ++h)
              hopper::tma_load_3d(a + h * HALF_A, &map_a, &full[s], m0 + 64 * h, k0, e);
          } else {  // BM rows of 64 reduction values
            hopper::tma_load_3d(a, &map_a, &full[s], k0, m0, e);
          }
          // B's two 128-column halves, each block of a pair its own copy.
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < (DW ? 2 : 1); ++c) {  // dw: two 64-column boxes a half
              const int c0 = DW ? n0 + 128 * h + 64 * c : k0;
              const int c1 = DW ? k0 : n0 + 128 * h;
              hopper::tma_load_3d(b + h * HALF_B + c * BK * 128, &map_b, &full[s], c0, c1, e);
            }
          }
        }
      }
    }
  } else {  // consumers: output rows 64 * warpgroup .. +63 of each tile
    hopper::regs_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) % 4;
    const bool leader = threadIdx.x % 128 == 0;  // issues this warpgroup's TMA stores
    uint8_t* boxes = staged + warpgroup * 2 * OUT_BOX;  // this warpgroup's two buffers
    // A warp's release of a stage, on both blocks of a pair.
    auto release = [&](int s) {
      if (lane != 0) return;
      if (pair == 2) {
        hopper::mbar_arrive_cluster(&empty[s], 0);
        hopper::mbar_arrive_cluster(&empty[s], 1);
      } else {
        hopper::mbar_arrive(&empty[s]);
      }
    };
    float acc[BN / 2];
    int it = 0, stores = 0;
    for (int u = first; u < units; u += step) {
      int e, m0, n0;
      tile(u, e, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
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
        hopper::wgmma_wait<1>();  // the products of the previous stage are done: free it
        if (kt > 0) release((it - 1) % STAGES);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release((it - 1) % STAGES);  // the producer is already filling the next tile's stages

      // acc[4j + 2i + c]: row 16 * warp + lane / 4 + 8i, column 8j + 2 (lane % 4) + c.
      const int row0 = m0 + 64 * warpgroup;
      if (row0 >= M) continue;  // rows past M (or a pair's tile past the last)
      // Four 64 x 64 boxes, staged in turns in this warpgroup's two 8 KB
      // buffers with the 128-byte swizzle (row r's 16-byte chunk c at chunk
      // c ^ (r % 8): a warp's 4-byte writes fall on 32 banks) and stored by
      // TMA; the consumers go on to the next tile while the stores drain.
#pragma unroll
      for (int bx = 0; bx < BN / 64; ++bx, ++stores) {
        if (n0 + 64 * bx >= N) break;
        uint8_t* box = boxes + (stores & 1) * OUT_BOX;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint8_t* row = box + (16 * warp + lane / 4 + 8 * i) * 128 + 4 * (lane % 4);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * bx + jj;
            *reinterpret_cast<uint32_t*>(row + ((jj ^ (lane / 4)) << 4)) =
                hopper::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
        }
        hopper::fence_async_shared();
        // Every earlier store has read its box: after this barrier the next
        // box may be written into the other buffer.
        if (leader) hopper::bulk_wait_read<0>();
        hopper::named_barrier_sync(1 + warpgroup, 128);
        if (leader) {
          hopper::tma_store_3d(&map_out, box, n0 + 64 * bx, row0, e);
          hopper::bulk_commit();
        }
      }
    }
    if (leader) hopper::bulk_wait<0>();
  }
  hopper::cluster_sync();
}

// One product's launch on a card of `sms` SMs: clusters of two blocks where
// an expert has two M tiles or more, else blocks alone; one block an SM in
// whole clusters, fewer where there are fewer units of work.
template <typename T, bool DW>
cudaError_t launch_product(const CUtensorMap& map_a, const CUtensorMap& map_b,
                           const CUtensorMap& map_out, int M, int N, int K, int E, int sms,
                           cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(gmm_bwd_wgmma_kernel<T, DW>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tiles_m = (M + wg::BM - 1) / wg::BM;
  const int pair = tiles_m > 1 ? 2 : 1;
  const int64_t units = (int64_t)E * ((tiles_m + pair - 1) / pair) * ((N + wg::BN - 1) / wg::BN);
  const int64_t clusters = sms / pair > 1 ? sms / pair : 1;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = pair;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((units < clusters ? units : clusters) * pair));
  config.blockDim = dim3(wg::THREADS);
  config.dynamicSmemBytes = wg::SMEM_BYTES;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&map_a), const_cast<CUtensorMap*>(&map_b),
                  const_cast<CUtensorMap*>(&map_out), &M, &N, &K, &E};
  err = cudaLaunchKernelExC(&config, kernel, args);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
                         int C, int D, int F, int sms, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap map_a, map_b, map_out;
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    err = hopper::make_map_3d(&map_a, dy, bf16, F, C, E, wg::BM);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_b, w, bf16, F, D, E, wg::BN / 2);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_out, dx, bf16, D, C, E, 64);
    if (err == cudaSuccess)
      err = launch_product<T, false>(map_a, map_b, map_out, C, D, F, E, sms, stream);
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    err = hopper::make_map_3d(&map_a, x, bf16, D, C, E, 64);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_b, dy, bf16, F, C, E, 64);
    if (err == cudaSuccess) err = hopper::make_map_3d(&map_out, dw, bf16, F, D, E, 64);
    if (err == cudaSuccess)
      err = launch_product<T, true>(map_a, map_b, map_out, D, F, C, E, sms, stream);
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

// Tensor cores; float16 or bfloat16, D and F multiples of 8, any C.  sms:
// the current device's SMs, which size the persistent launch
// (`launch_product`; any size gives the same bits).
extern "C" int repro_moe_gmm_bwd_wgmma(const void* x, const void* w, const void* dy, void* dx,
                                       void* dw, int E, int C, int D, int F, int need_dx,
                                       int need_dw, int dtype, int sms, void* stream) {
  if (!valid(E, C, D, F) || D % 8 != 0 || F % 8 != 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* dxp = need_dx ? dx : nullptr;
  void* dwp = need_dw ? dw : nullptr;
  switch (dtype) {
    case 1: return (int)launch_wgmma<__half>(x, w, dy, dxp, dwp, E, C, D, F, sms, s);
    case 2: return (int)launch_wgmma<__nv_bfloat16>(x, w, dy, dxp, dwp, E, C, D, F, sms, s);
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
