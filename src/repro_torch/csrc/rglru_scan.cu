// RG-LRU linear recurrence (Griffin) for Hopper.
//
// Replaces the Pallas TPU kernel `rglru_scan` / `_lru_kernel` in
// src/repro/kernels/rglru_scan.py.  It computes the same function, from
// h = 0:  h_t = a_t (.) h_{t-1} + b_t  along time, elementwise over the
// channels; a and b (B, L, D) in fp32, fp16 or bf16, arithmetic in fp32,
// h_all (B, L, D) and h_final (B, D) in fp32.
//
// Design.  The TPU kernel walks time chunks as a sequential grid axis and
// carries h in VMEM.  Here a block owns a tile of CPB = 32 channels of one
// batch row (a step's row of the tile is 128 bytes in fp32) and walks all of
// time itself, in rounds of ROUND = WARPS x CH steps: at recurrentgemma-9b's
// training shape (B = 1, D = 4096) that is 128 blocks for 132 SMs, at its
// prefill (B = 4) 512.  A block is warp-specialised:
// * One producer warp stages each round's a and b (one TMA box each, the
//   tile's 32 channels x ROUND steps) in a ring of STAGES stages completing
//   on mbarriers, as soon as the consumers free a stage: loads run up to
//   STAGES - 1 rounds ahead of the walk.  Zeros past L and D come from TMA's
//   out-of-bounds fill.  Where TMA cannot stride a row (D x the element size
//   not a multiple of 16 bytes, or a base off 16 bytes) the producer's lanes
//   load the same layout with plain loads.
// * WARPS consumer warps each take a chunk of CH consecutive steps of the
//   round, one lane a channel, and keep its a and b in registers (the stage
//   is freed as soon as they are read):
//   (a) each walks its chunk from a zero carry: its end value u and the
//       product A of its decays (h_end = A h_in + u);
//   (b) the carries across the round's chunks are composed in one fixed
//       order, x_w = fmaf(A_w, x_{w-1}, u_w) from the carry of the round
//       before: every warp reads the round's (A, u) from shared memory
//       (written before one named barrier) and runs the same fold, so each
//       has its own carry-in and the round's end with the bits one warp
//       would give, and no second barrier is needed;
//   (c) each walks its chunk again from its carry-in and stores h_all, one
//       128-byte row a step, and h_final at step L - 1.
// Every input is read once and every output written once; nothing depends
// on timing, so two launches give the same bits.  The result is the
// sequential walk's up to fp32 rounding (a chunk's product of 16 decays).
//
// Bound on the H100 SXM: a and b read once and h_all written once, 3 x 67.1
// MB = 201 MB at the training shape (B = 1, L = D = 4096, fp32), 0.0601 ms
// at 3.35 TB/s, and 403 MB, 0.1202 ms, at the prefill (B = 4, L = 2048);
// two flops a step and channel are nothing beside that, so the scan is
// bound by bytes.  Measured by tools/time_bag_checks.py --lru on NVIDIA
// H100 80GB HBM3, 700.00 W: 0.0781-0.0801 ms at B = 1 (75-77% of the bound)
// and 0.1479-0.1518 ms at the prefill (79-81%), 2.5-2.7 TB/s.  One thread a
// lane walking all of time (32 of 132 SMs busy at B = 1, bound by latency)
// took 0.2518-0.2562 and 0.1758-0.1796 ms there, in turns with this.
// tools/lru_variants.py: 2 or 3 stages, 8- or 32-step chunks and 16 warps
// ran within 5% of this layout or behind it; the producer's plain loads at
// every shape (no TMA) ran 7x slower.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int CPB = 32;                  // channels a block, one a lane
constexpr int WARPS = 8;                 // consumer warps, one chunk of a round each
constexpr int CH = 16;                   // steps a chunk
constexpr int ROUND = WARPS * CH;        // steps a round (one TMA box a row of channels)
constexpr int STAGES = 4;                // rounds in the ring
constexpr int BLOCK = (WARPS + 1) * 32;  // and one producer warp

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in bytes: the ring (a stage is a's box, then b's, each
// [ROUND steps][CPB channels]), the chunks' (u, A) of two rounds, the
// barriers.
template <typename T> struct Ring {
  static constexpr int IN = ROUND * CPB * sizeof(T);
  static constexpr int STAGE = 2 * IN;
  static constexpr int SUMS = 2 * 2 * WARPS * CPB * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + SUMS + 2 * STAGES * 8;
  static_assert(IN % 128 == 0, "128-byte-aligned TMA destinations");
};

struct Maps {
  CUtensorMap a, b;
};

// Batch row blockIdx.y, channels blockIdx.x * CPB .. + CPB - 1; tma says
// whether the producer stages by TMA (else by plain loads).
template <typename T>
__global__ void __launch_bounds__(BLOCK)
lru_fwd_kernel(const __grid_constant__ Maps maps, const T* __restrict__ a,
               const T* __restrict__ b, float* __restrict__ hall, float* __restrict__ hfin,
               int L, int D, int tma) {
  using S = Ring<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  // The chunks' (u, A): [round & 1][u, A][warp][lane].
  float* sums = reinterpret_cast<float*>(ring + STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE + S::SUMS);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB;
  const int rounds = (L + ROUND - 1) / ROUND;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], tma ? 1 : 32);  // the TMA issuer, or every producer lane
      hopper::mbar_init(&empty[s], WARPS);        // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WARPS) {  // producer
    for (int i = 0; i < rounds; ++i) {
      const int s = i % STAGES, t0 = i * ROUND;
      T* sa = reinterpret_cast<T*>(ring + s * S::STAGE);
      T* sb = reinterpret_cast<T*>(ring + s * S::STAGE + S::IN);
      if (tma) {
        if (lane == 0) {
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], S::STAGE);
          hopper::tma_load_3d(sa, &maps.a, &full[s], d0, t0, bi);
          hopper::tma_load_3d(sb, &maps.b, &full[s], d0, t0, bi);
        }
      } else {  // the same layout by plain loads; zeros past L and D
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const T zero = T(0.f);
        for (int e = lane; e < ROUND * CPB; e += 32) {
          const int t = e / CPB, c = e % CPB;
          const bool ok = t0 + t < L && d0 + c < D;
          const size_t g = ((size_t)bi * L + t0 + t) * D + d0 + c;
          sa[e] = ok ? a[g] : zero;
          sb[e] = ok ? b[g] : zero;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warp `warp` owns steps warp * CH .. + CH - 1 of each round,
  // lane `lane` channel d.
  const int d = d0 + lane;
  const bool live = d < D;
  float* hp = hall + (size_t)bi * L * D + d;
  float carry = 0.f;  // h entering the round
  for (int i = 0; i < rounds; ++i) {
    const int s = i % STAGES;
    const T* sa = reinterpret_cast<const T*>(ring + s * S::STAGE) + warp * CH * CPB + lane;
    const T* sb = reinterpret_cast<const T*>(ring + s * S::STAGE + S::IN) + warp * CH * CPB + lane;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    float ra[CH], rb[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      ra[j] = to_float<T>(sa[j * CPB]);
      rb[j] = to_float<T>(sb[j * CPB]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);

    // (a) The chunk from a zero carry: h_end = A h_in + u.
    float u = 0.f, A = 1.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      u = fmaf(ra[j], u, rb[j]);
      A *= ra[j];
    }
    float* su = sums + (i & 1) * 2 * WARPS * CPB;
    float* sA = su + WARPS * CPB;
    su[warp * CPB + lane] = u;
    sA[warp * CPB + lane] = A;
    hopper::named_barrier_sync(1, WARPS * 32);

    // (b) The carries across the round's chunks, in order.
    float x = carry, xin = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      if (k == warp) xin = x;
      x = fmaf(sA[k * CPB + lane], x, su[k * CPB + lane]);
    }
    carry = x;

    // (c) The chunk again from its carry-in.
    const int t0 = i * ROUND + warp * CH;
    float h = xin;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      h = fmaf(ra[j], h, rb[j]);
      if (live && t0 + j < L) hp[(size_t)(t0 + j) * D] = h;
      if (live && t0 + j == L - 1) hfin[(size_t)bi * D + d] = h;
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* hall, void* hfin, int B, int L, int D,
                   cudaStream_t stream) {
  using S = Ring<T>;
  constexpr uint64_t ES = sizeof(T);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool tma = aligned(a) && aligned(b) && D * ES % 16 == 0;
  Maps maps = {};
  if (tma) {
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const uint64_t row = D * ES;
    cudaError_t err =
        hopper::make_map_3d_plain(&maps.a, a, ES, bf16, D, L, B, row, row * L, CPB, ROUND);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.b, b, ES, bf16, D, L, B, row, row * L, CPB, ROUND);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      lru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + CPB - 1) / CPB, B);
  lru_fwd_kernel<T><<<grid, BLOCK, S::SMEM, stream>>>(
      maps, static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(hall),
      static_cast<float*>(hfin), L, D, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// a, b: contiguous (B, L, D) device arrays of one dtype (0 float32,
// 1 float16, 2 bfloat16); hall (B, L, D) and hfin (B, D) fp32 outputs.
// One launch on `stream`; returns a cudaError_t (0 on success).
extern "C" int repro_rglru_scan(const void* a, const void* b, void* hall, void* hfin, int B,
                                int L, int D, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(a, b, hall, hfin, B, L, D, s);
    case 1: return (int)launch<__half>(a, b, hall, hfin, B, L, D, s);
    case 2: return (int)launch<__nv_bfloat16>(a, b, hall, hfin, B, L, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
