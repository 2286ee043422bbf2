// RG-LRU linear recurrence backward (Griffin) for Hopper.
//
// Replaces no TPU kernel: the JAX package differentiates its RG-LRU scan
// with jax.grad (its Pallas kernel `rglru_scan`, src/repro/kernels/
// rglru_scan.py, has no custom_vjp).  This is the gradient of the forward
// in csrc/rglru_scan.cu, for training.  With h_t = a_t h_{t-1} + b_t from
// h_{-1} = 0, the cotangents dh_t of h_all (B, L, D) and dh_final of
// h_final (B, D):
//
//   g_{L-1} = dh_{L-1} + dh_final,   g_t = dh_t + a_{t+1} g_{t+1},
//   db_t = g_t,                       da_t = g_t h_{t-1}   (h_{-1} = 0),
//
// elementwise over the channels, in fp32: a in fp32, fp16 or bf16; h_all,
// dh_all, dh_final, da and db in fp32 (the wrapper casts da and db).
//
// Design: the forward's (csrc/rglru_scan.cu) mirrored in reverse time, one
// launch.  A block owns a tile of CPB = 32 channels of one batch row and
// walks time back in rounds of ROUND = WARPS x CH steps, the last round
// first: at recurrentgemma-9b's training shape (B = 1, D = 4096) 128 blocks
// for 132 SMs.
// * One producer warp stages each round's a, dh and h (one TMA box each,
//   the tile's 32 channels x ROUND steps; h's box one step earlier, so that
//   row i of the stage holds h_{t-1} for step t of row i) in a ring of
//   STAGES stages on mbarriers, up to STAGES - 1 rounds ahead of the walk.
//   The first round's h box would start at step -1; it is loaded from step
//   0 one row down instead (the stage has a row to spare) and the consumer
//   reads h_{-1} = 0.  Zeros past L and D come from TMA's out-of-bounds
//   fill; where TMA cannot stride a row (D x the element size not a
//   multiple of 16 bytes, or a base off 16 bytes) the producer's lanes load
//   the same layout with plain loads.
// * WARPS consumer warps each take a chunk of CH consecutive steps of the
//   round, one lane a channel, with its a, dh and h_{t-1} in registers
//   (the stage is freed as soon as they are read).  With w = a_t g_t, what
//   a step passes back to the one before:
//   (a) each walks its chunk back from a zero carry (dh_final entering at
//       step L - 1): u = a_start g~_start and A, the product of its decays
//       (w_out = A w_in + u); steps past L have a = dh = 0 and pass 0 on;
//   (b) the carries across the round's chunks are composed in one fixed
//       order from the last chunk, x = fmaf(A_w, x, u_w) from the carry of
//       the round after; every warp runs the same fold on the (A, u) that
//       all wrote before one named barrier, so each has its carry-in, and
//       the round's with the bits one warp would give;
//   (c) each walks its chunk back again from its carry-in and stores
//       db = g and da = g h_{t-1}, one 128-byte row a step each.
// Every input is read once, every output written once, with no workspace
// and no float atomics; nothing depends on timing, so two launches give the
// same bits.  The result is the sequential walk's up to fp32 rounding.
//
// Bound on the H100 SXM at recurrentgemma-9b's training shape (B = 1,
// L = 4096, D = 4096, fp32): a, h_all, dh_all read once and da, db written
// once, 5 x 67.1 MB = 335.5 MB, 0.100 ms at 3.35 TB/s; its FMAs are nothing
// beside that.  Measured by tools/time_bag_checks.py --lru on NVIDIA H100
// 80GB HBM3, 700.00 W: 0.1263-0.1296 ms (77-79% of the bound, 2.6 TB/s); with
// bf16 a 0.1195 ms for the kernel alone (tools/lru_variants.py), 0.187 with
// the wrapper's casts of da and db.  Three launches (a walk a chunk, a
// carry pass of one thread a lane, a fix-up walk; a and dh read twice, 470
// MB) took 0.2252-0.2293 ms, and 0.291 with bf16 a, in turns with this.

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
constexpr int ROUND = WARPS * CH;        // steps a round
constexpr int STAGES = 4;                // rounds in the ring
constexpr int BLOCK = (WARPS + 1) * 32;  // and one producer warp

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in bytes: the ring (a stage is a's box, dh's, then h's with
// one row to spare, each [steps][CPB channels]), the chunks' (u, A) of two
// rounds, the barriers.
template <typename T> struct Ring {
  static constexpr int A_BYTES = ROUND * CPB * sizeof(T);
  static constexpr int F_BYTES = ROUND * CPB * 4;
  static constexpr int OFF_DH = A_BYTES;
  static constexpr int OFF_H = OFF_DH + F_BYTES;
  static constexpr int STAGE = OFF_H + F_BYTES + CPB * 4;
  static constexpr int TX = A_BYTES + 2 * F_BYTES;  // bytes the TMA boxes bring
  static constexpr int SUMS = 2 * 2 * WARPS * CPB * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + SUMS + 2 * STAGES * 8;
  static_assert(A_BYTES % 128 == 0 && STAGE % 128 == 0, "128-byte-aligned TMA destinations");
};

struct Maps {
  CUtensorMap a, dh, h;
};

// Batch row blockIdx.y, channels blockIdx.x * CPB .. + CPB - 1; tma says
// whether the producer stages by TMA (else by plain loads).
template <typename T>
__global__ void __launch_bounds__(BLOCK)
lru_bwd_kernel(const __grid_constant__ Maps maps, const T* __restrict__ a,
               const float* __restrict__ hall, const float* __restrict__ dh,
               const float* __restrict__ dhf, float* __restrict__ da, float* __restrict__ db,
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

  if (warp == WARPS) {  // producer: round i of the walk is round r = rounds - 1 - i of time
    for (int i = 0; i < rounds; ++i) {
      const int s = i % STAGES, t0 = (rounds - 1 - i) * ROUND;
      uint8_t* st = ring + s * S::STAGE;
      T* sa = reinterpret_cast<T*>(st);
      float* sd = reinterpret_cast<float*>(st + S::OFF_DH);
      float* sh = reinterpret_cast<float*>(st + S::OFF_H);
      if (tma) {
        if (lane == 0) {
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], S::TX);
          hopper::tma_load_3d(sa, &maps.a, &full[s], d0, t0, bi);
          hopper::tma_load_3d(sd, &maps.dh, &full[s], d0, t0, bi);
          if (t0 > 0)
            hopper::tma_load_3d(sh, &maps.h, &full[s], d0, t0 - 1, bi);
          else  // h_0 .. into row 1; row 0 (h_{-1}) is never read
            hopper::tma_load_3d(sh + CPB, &maps.h, &full[s], d0, 0, bi);
        }
      } else {  // the same layout by plain loads; zeros past L and D
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const T zero = T(0.f);
        for (int e = lane; e < ROUND * CPB; e += 32) {
          const int t = e / CPB, c = e % CPB;
          const bool col = d0 + c < D;
          const bool ok = col && t0 + t < L;
          const size_t g = ((size_t)bi * L + t0 + t) * D + d0 + c;
          sa[e] = ok ? a[g] : zero;
          sd[e] = ok ? dh[g] : 0.f;
          sh[e] = col && t0 + t >= 1 && t0 + t <= L ? hall[g - D] : 0.f;
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
  const float wf = live && dhf != nullptr ? dhf[(size_t)bi * D + d] : 0.f;  // enters at L - 1
  float* dap = da + (size_t)bi * L * D + d;
  float* dbp = db + (size_t)bi * L * D + d;
  float carry = 0.f;  // w entering the round from the one after
  for (int i = 0; i < rounds; ++i) {
    const int s = i % STAGES;
    const int t0 = (rounds - 1 - i) * ROUND + warp * CH;
    const uint8_t* st = ring + s * S::STAGE;
    const int at = warp * CH * CPB + lane;
    const T* sa = reinterpret_cast<const T*>(st) + at;
    const float* sd = reinterpret_cast<const float*>(st + S::OFF_DH) + at;
    const float* sh = reinterpret_cast<const float*>(st + S::OFF_H) + at;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    float ra[CH], rd[CH], rh[CH];  // rh[j] = h_{t0 + j - 1}
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      ra[j] = to_float<T>(sa[j * CPB]);
      rd[j] = sd[j * CPB];
      rh[j] = sh[j * CPB];
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (t0 == 0) rh[0] = 0.f;  // h_{-1}

    // (a) The chunk back from a zero carry: w_out = A w_in + u.
    float w = 0.f, A = 1.f;
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      if (t0 + j == L - 1) w = wf;
      const float g = rd[j] + w;
      w = ra[j] * g;
      A *= ra[j];
    }
    float* su = sums + (i & 1) * 2 * WARPS * CPB;
    float* sA = su + WARPS * CPB;
    su[warp * CPB + lane] = w;
    sA[warp * CPB + lane] = A;
    hopper::named_barrier_sync(1, WARPS * 32);

    // (b) The carries across the round's chunks, in order from the last.
    float x = carry, xin = 0.f;
#pragma unroll
    for (int k = WARPS - 1; k >= 0; --k) {
      if (k == warp) xin = x;
      x = fmaf(sA[k * CPB + lane], x, su[k * CPB + lane]);
    }
    carry = x;

    // (c) The chunk back again from its carry-in, writing the gradients.
    w = xin;
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t == L - 1) w = wf;
      const float g = rd[j] + w;
      if (live && t < L) {
        dbp[(size_t)t * D] = g;
        dap[(size_t)t * D] = g * rh[j];
      }
      w = ra[j] * g;
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const float* hall, const float* dh, const float* dhf,
                   float* da, float* db, int B, int L, int D, cudaStream_t stream) {
  using S = Ring<T>;
  constexpr uint64_t ES = sizeof(T);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool tma = aligned(a) && aligned(hall) && aligned(dh) && D * ES % 16 == 0 && D % 4 == 0;
  Maps maps = {};
  if (tma) {
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const uint64_t row = D * ES, frow = D * 4ULL;
    cudaError_t err =
        hopper::make_map_3d_plain(&maps.a, a, ES, bf16, D, L, B, row, row * L, CPB, ROUND);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.dh, dh, 4, false, D, L, B, frow, frow * L, CPB,
                                      ROUND);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.h, hall, 4, false, D, L, B, frow, frow * L, CPB,
                                      ROUND);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      lru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + CPB - 1) / CPB, B);
  lru_bwd_kernel<T><<<grid, BLOCK, S::SMEM, stream>>>(maps, static_cast<const T*>(a), hall, dh,
                                                      dhf, da, db, L, D, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// a: contiguous (B, L, D) of dtype (0 float32, 1 float16, 2 bfloat16);
// hall, dh: contiguous (B, L, D) fp32; dhf: (B, D) fp32 or null (0); da, db:
// (B, L, D) fp32 outputs.  One launch on `stream`; returns a cudaError_t
// (0 on success).
extern "C" int repro_rglru_scan_bwd(const void* a, const float* hall, const float* dh,
                                    const float* dhf, float* da, float* db, int B, int L, int D,
                                    int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(a, hall, dh, dhf, da, db, B, L, D, s);
    case 1: return (int)launch<__half>(a, hall, dh, dhf, da, db, B, L, D, s);
    case 2: return (int)launch<__nv_bfloat16>(a, hall, dh, dhf, da, db, B, L, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
