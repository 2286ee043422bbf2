// Mamba-1 selective scan for Hopper.
//
// Replaces the Pallas TPU kernel `mamba_scan` / `_scan_kernel` in
// src/repro/kernels/mamba_scan.py.  It computes the same function, from
// h = 0:
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) (x) b_t      (DI x ST)
//   y_t = h_t . c_t + D (.) x_t
// with xc (B, L, DI), b and c (B, L, ST) in the activation dtype (fp32,
// fp16 or bf16), dt (B, L, DI), A (DI, ST) and D (DI,) in fp32, all
// arithmetic in fp32, y (B, L, DI) and the final state h (B, DI, ST) in fp32.
//
// Bound on the H100 SXM at falcon-mamba-7b's prefill (B = 4, L = 1000,
// DI = 8192, ST = 16, bf16 xc, b and c): the bytes the function must move
// are xc 65.5 MB, dt 131 MB, y 131 MB, h 2.1 MB, b and c 0.26 MB: 330 MB,
// 0.099 ms at 3.35 TB/s.  Its B*L*DI*ST = 524 M exps at the SFUs' 16 a clock
// on each SM take 0.125 ms, so the scan is bound by operations: every
// (channel, step) costs one SFU clock of an SM.  The tensor cores do not
// apply: Mamba-1's decay exp(dt_{t,d} * A_{d,s}) differs for every channel
// and state, so the recurrence has no matrix-product form (Mamba-2's scalar
// decay per head is what gives its scan one).
//
// Design.  The TPU kernel walks time chunks as a sequential grid axis and
// carries h in VMEM.  Here the sequential axis is a loop inside each thread,
// with its slice of h in registers, and decay and drive are computed on the
// fly: (B, L, DI, ST) is never stored.  A block is warp-specialised:
// * One producer warp stages the inputs through a ring of 4 stages of
//   TC = 16 steps: per stage one TMA box each of x and dt (the block's CPB
//   channels x 16 steps; boxes of at most 256 bytes a row) and of b and c
//   (3-D tensor maps over their strided views, so the x_proj slices are
//   read in place), completing on an mbarrier; zeros past L, DI and ST come
//   from TMA's out-of-bounds fill.  Loads run two chunks ahead.  It then
//   converts the stage's b and c to fp32 once (they are shared by all the
//   block's channels) and arrives on the stage's "full" barrier.  Where TMA
//   cannot stride an input (rows of x, dt, b or c that do not start on 16
//   bytes) its lanes load the same layout with plain loads instead.
// * Four consumer warps run the scan.  A thread owns SPT = 16 states of one
//   (batch, channel), so at ST = 16 a channel is one thread and y needs no
//   reduction (ST up to 128 spreads a channel over LPC = 2, 4 or 8 lanes,
//   whose sums are added by shuffles once a chunk).  A chunk's 16 steps are
//   unrolled: only h carries from one step to the next (one FMA), so the
//   loads and exps of later steps overlap earlier ones; y's per-step sums
//   are kept in registers and stored after the chunk, and each warp frees
//   the stage with one arrive.  Steps past L read x = dt = 0 (decay 1,
//   drive 0), so h is kept.  At falcon-mamba-7b's prefill that is 256
//   blocks of 128 + 32 threads (CPB = 128 channels, 256-byte x rows).
// * One SFU instruction an exp: A is scaled by log2(e) when it is loaded,
//   and each decay is ex2.approx.ftz(dt * A * log2 e) (about 2 ulp, like
//   expf's own error; denormal decays flush to 0).  A state and step is then
//   one FMUL, one MUFU.EX2, one FMUL and two FFMA.
// What this does about the bound: the consumers issue nothing but the scan
// (no staging, no block-wide barrier), and no thread waits on device memory.
//
// Checkpoints for training (template flag CKPT, C entry
// repro_mamba_scan_ckpt).  The backward (csrc/mamba_scan_bwd.cu) walks time
// in reverse in chunks of CKPT_STEPS = 8 and needs each chunk's start state.
// Under remat the forward runs again just before its backward, so with CKPT
// it also writes the state after every 8 steps, (B, ceil(L / 8) - 1, DI,
// ST4) fp32 with ST4 = ST rounded up to 4 (padded states are 0), from the
// consumers' registers as the chunk's unrolled steps reach it: 1.07 GB at
// falcon-mamba-7b's training shape (B = 4, L = 4096, DI = 8192, ST = 16),
// 0.32 ms of stores under a scan bound by its exps.  The serving call runs
// the CKPT = false instantiation, the same code as without the flag.
// Measured there (tools/time_bag_checks.py --scan-ssm; NVIDIA H100 80GB
// HBM3, 700.00 W): 0.974 ms with checkpoints against 0.851-0.860 without
// in bf16, 1.069-1.076 against 0.826-0.829 in fp32; the prefill's time and
// its y and h bits unchanged.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3;
// PERF.md section 6, row 4): 0.219 ms at falcon-mamba-7b's prefill with bf16
// inputs and 0.213 ms in fp32, against the 0.125 ms bound.  Splitting a
// channel's states over more threads (4 a thread) gives more threads but
// more shared-memory loads and shuffles for each channel and step, and was
// slower; so was staging done by every thread between block-wide barriers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 128;         // 4 warps run the scan
constexpr int BLOCK = CONSUMERS + 32;  // and one producer warp stages its inputs
constexpr int SPT = 16;                // states a thread
constexpr int TC = 16;                 // time steps a chunk
constexpr int STAGES = 4;              // chunks in the ring
constexpr int BOX_BYTES = 256;         // inner extent of one TMA box
constexpr int CKPT_STEPS = 8;          // steps between checkpoints (the backward's chunk)
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An array of N values a row staged as TMA boxes of W = min(N, 256 bytes)
// values: TC rows of a box, then the next box.  Element (t, i) of the chunk:
template <int N, int ES> struct Boxed {
  static constexpr int W = N * ES < BOX_BYTES ? N : BOX_BYTES / ES;  // values a box row
  static constexpr int BOXES = N / W;
  static constexpr int BYTES = TC * N * ES;
  static __device__ __forceinline__ int at(int t, int i) { return (i / W * TC + t) * W + i % W; }
};

// Shared-memory layout of one stage, in bytes: x, dt, b and c as staged
// (raw), then b and c as fp32 ([t][state]).  Every part is a multiple of
// 128 bytes, so TMA destinations stay 128-byte aligned.
template <typename T, int LPC> struct Stage {
  static constexpr int CPB = CONSUMERS / LPC;  // channels a block
  static constexpr int SP = LPC * SPT;         // states a channel, padded
  using X = Boxed<CPB, sizeof(T)>;
  using DT = Boxed<CPB, 4>;
  using BC = Boxed<SP, sizeof(T)>;
  static constexpr int OFF_DT = X::BYTES;
  static constexpr int OFF_B = OFF_DT + DT::BYTES;
  static constexpr int OFF_C = OFF_B + BC::BYTES;
  static constexpr int OFF_F = OFF_C + BC::BYTES;   // fp32 b, then fp32 c
  static constexpr int BYTES = OFF_F + 2 * TC * SP * 4;
  static constexpr int TX = OFF_F;                  // bytes the TMA boxes bring
  static constexpr int SMEM = 1024 + STAGES * BYTES + 3 * STAGES * 8;
  static_assert(TC % CKPT_STEPS == 0, "checkpoints on chunk steps");
  static_assert(X::BYTES % 128 == 0 && DT::BYTES % 128 == 0 && BC::BYTES % 128 == 0,
                "128-byte-aligned TMA destinations");
};

struct Maps {
  CUtensorMap x, dt, b, c;
};

// One warp-specialised block: batch row blockIdx.y, channels
// blockIdx.x * CPB .. + CPB - 1.  The producer warp stages chunk after chunk
// of x, dt, b and c (TMA boxes, or plain loads where TMA cannot stride the
// input) into a ring of STAGES and converts b and c to fp32; the consumer
// threads each run SPT states of one channel through the chunk; with CKPT
// they also store the state after every CKPT_STEPS steps to ckpt.
template <typename T, int LPC, bool TMA, bool CKPT>
__global__ void __launch_bounds__(BLOCK)
mamba_scan_kernel(const __grid_constant__ Maps maps, const T* __restrict__ xc,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ dskip, float* __restrict__ y,
                  float* __restrict__ hout, float* __restrict__ ckpt, int L, int DI, int ST,
                  long long b_sb, long long b_st, long long c_sb, long long c_st) {
  using S = Stage<T, LPC>;
  constexpr int CPB = S::CPB;
  constexpr int SP = S::SP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* landed = reinterpret_cast<uint64_t*>(ring + STAGES * S::BYTES);  // TMA bytes in
  uint64_t* full = landed + STAGES;   // converted: the consumers may read the stage
  uint64_t* empty = full + STAGES;    // the consumers are done with the stage

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int n_chunks = (L + TC - 1) / TC;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&landed[s], 1);
      hopper::mbar_init(&full[s], 32);               // every producer lane
      hopper::mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp
    const int lane = tid - CONSUMERS;
    const CUtensorMap* map_x = &maps.x;
    const CUtensorMap* map_dt = &maps.dt;
    const CUtensorMap* map_b = &maps.b;
    const CUtensorMap* map_c = &maps.c;
    auto wait_empty = [&](int i) {
      hopper::mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
    };
    auto issue = [&](int i) {  // chunk i's boxes, completing on landed[i % STAGES]
      if (lane == 0) {
        const int s = i % STAGES;
        uint8_t* st = ring + s * S::BYTES;
        wait_empty(i);
        hopper::mbar_arrive_expect_tx(&landed[s], S::TX);
        const int t0 = i * TC;
#pragma unroll
        for (int k = 0; k < S::X::BOXES; ++k)
          hopper::tma_load_3d(st + k * TC * S::X::W * sizeof(T), map_x, &landed[s],
                              d0 + k * S::X::W, t0, bi);
#pragma unroll
        for (int k = 0; k < S::DT::BOXES; ++k)
          hopper::tma_load_3d(st + S::OFF_DT + k * TC * S::DT::W * 4, map_dt, &landed[s],
                              d0 + k * S::DT::W, t0, bi);
#pragma unroll
        for (int k = 0; k < S::BC::BOXES; ++k) {
          hopper::tma_load_3d(st + S::OFF_B + k * TC * S::BC::W * sizeof(T), map_b,
                              &landed[s], k * S::BC::W, t0, bi);
          hopper::tma_load_3d(st + S::OFF_C + k * TC * S::BC::W * sizeof(T), map_c,
                              &landed[s], k * S::BC::W, t0, bi);
        }
      }
      __syncwarp();
    };
    auto load_plain = [&](int i) {  // the same layout by plain loads; zeros past the edges
      uint8_t* st = ring + (i % STAGES) * S::BYTES;
      T* sx = reinterpret_cast<T*>(st);
      float* sdt = reinterpret_cast<float*>(st + S::OFF_DT);
      T* sb = reinterpret_cast<T*>(st + S::OFF_B);
      T* sc = reinterpret_cast<T*>(st + S::OFF_C);
      const int t0 = i * TC;
      const T zero = T(0.f);
      for (int e = lane; e < TC * CPB; e += 32) {
        const int t = e / CPB, ch = e % CPB;
        const bool ok = t0 + t < L && d0 + ch < DI;
        const size_t g = ((size_t)bi * L + t0 + t) * DI + d0 + ch;
        sx[S::X::at(t, ch)] = ok ? xc[g] : zero;
        sdt[S::DT::at(t, ch)] = ok ? dt[g] : 0.f;
      }
      for (int e = lane; e < TC * SP; e += 32) {
        const int t = e / SP, j = e % SP;
        const bool ok = t0 + t < L && j < ST;
        sb[S::BC::at(t, j)] = ok ? bm[bi * b_sb + (t0 + t) * b_st + j] : zero;
        sc[S::BC::at(t, j)] = ok ? cm[bi * c_sb + (t0 + t) * c_st + j] : zero;
      }
    };
    auto convert = [&](int i) {  // b and c to fp32 [t][state]; then the stage is full
      uint8_t* st = ring + (i % STAGES) * S::BYTES;
      const T* rb = reinterpret_cast<const T*>(st + S::OFF_B);
      const T* rc = reinterpret_cast<const T*>(st + S::OFF_C);
      float* fb = reinterpret_cast<float*>(st + S::OFF_F);
      for (int e = lane; e < TC * SP; e += 32) {
        const int t = e / SP, j = e % SP;
        fb[e] = to_float<T>(rb[S::BC::at(t, j)]);
        fb[TC * SP + e] = to_float<T>(rc[S::BC::at(t, j)]);
      }
      hopper::mbar_arrive(&full[i % STAGES]);
    };
    if constexpr (TMA) {
      // Loads run two chunks ahead of the conversion, which runs one ahead
      // of the consumers.
      issue(0);
      if (n_chunks > 1) issue(1);
      for (int i = 0; i < n_chunks; ++i) {
        if (i + 2 < n_chunks) issue(i + 2);
        hopper::mbar_wait(&landed[i % STAGES], (i / STAGES) & 1);
        convert(i);
      }
    } else {
      for (int i = 0; i < n_chunks; ++i) {
        wait_empty(i);
        __syncwarp();
        load_plain(i);
        __syncwarp();
        convert(i);
      }
    }
    return;
  }

  // Consumers: thread (channel ch, lanes lane_c) runs states s0 .. s0+SPT-1.
  const int lane = tid & 31;
  const int lane_c = tid % LPC;
  const int ch = tid / LPC;
  const int d = d0 + ch;
  const int s0 = lane_c * SPT;
  float a2[SPT], h[SPT];  // A scaled by log2(e)
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    a2[j] = (d < DI && s0 + j < ST) ? A[(size_t)d * ST + s0 + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dsk = (d < DI && lane_c == 0) ? dskip[d] : 0.f;  // D * x, added once
  float* yd = y + (size_t)bi * L * DI + d;

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    const uint8_t* st = ring + s * S::BYTES;
    const T* sx = reinterpret_cast<const T*>(st);
    const float* sdt = reinterpret_cast<const float*>(st + S::OFF_DT);
    const float* sb = reinterpret_cast<const float*>(st + S::OFF_F);
    const float* sc = sb + TC * SP;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    // The chunk's steps, unrolled: only h carries from one step to the next
    // (one FMA), so the loads and exps of later steps overlap earlier ones.
    // Steps past L read x = dt = 0: decay 1, drive 0, h kept.
    float p[TC];  // y's partial sums over this thread's states
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const float xv = to_float<T>(sx[S::X::at(t, ch)]);
      const float dv = sdt[S::DT::at(t, ch)];
      const float dx = dv * xv;
      float bv[SPT], cv[SPT];
#pragma unroll
      for (int j = 0; j < SPT; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(sb + t * SP + s0 + j);
        const float4 c4 = *reinterpret_cast<const float4*>(sc + t * SP + s0 + j);
        bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
        cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
      }
      p[t] = dsk * xv;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(hopper::exp2_approx(dv * a2[j]), h[j], dx * bv[j]);
        p[t] = fmaf(h[j], cv[j], p[t]);
      }
      if constexpr (CKPT) {
        // The state after step k * CKPT_STEPS - 1, checkpoint k - 1 (the last
        // chunk's start is the last one written).
        const int next = i * TC + t + 1;
        if (t % CKPT_STEPS == CKPT_STEPS - 1 && next < L && d < DI) {
          const int ST4 = (ST + 3) & ~3, NK = (L + CKPT_STEPS - 1) / CKPT_STEPS - 1;
          float4* dst = reinterpret_cast<float4*>(
              ckpt + (((size_t)bi * NK + next / CKPT_STEPS - 1) * DI + d) * ST4 + s0);
#pragma unroll
          for (int q = 0; q < SPT / 4; ++q)
            if (s0 + 4 * q < ST4)
              dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    // y: the sums over a channel's LPC lanes, off the h chain.
#pragma unroll
    for (int o = LPC / 2; o > 0; o >>= 1)
#pragma unroll
      for (int t = 0; t < TC; ++t) p[t] += __shfl_xor_sync(0xffffffffu, p[t], o);
    if (lane_c == 0 && d < DI) {
      const int t0 = i * TC;
#pragma unroll
      for (int t = 0; t < TC; ++t)
        if (t0 + t < L) yd[(size_t)(t0 + t) * DI] = p[t];
    }
  }

  if (d < DI) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (s0 + j < ST) hout[((size_t)bi * DI + d) * ST + s0 + j] = h[j];
  }
}

template <typename T, int LPC, bool TMA, bool CKPT>
cudaError_t launch_tma(const Maps& maps, const void* xc, const void* dt, const void* A,
                       const void* b, const void* c, const void* dskip, void* y, void* h,
                       void* ckpt, int B, int L, int DI, int ST, long long b_sb, long long b_st,
                       long long c_sb, long long c_st, cudaStream_t stream) {
  using S = Stage<T, LPC>;
  const cudaError_t err = cudaFuncSetAttribute(mamba_scan_kernel<T, LPC, TMA, CKPT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((DI + S::CPB - 1) / S::CPB, B);
  mamba_scan_kernel<T, LPC, TMA, CKPT><<<grid, BLOCK, S::SMEM, stream>>>(
      maps, static_cast<const T*>(xc), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(dskip), static_cast<float*>(y), static_cast<float*>(h),
      static_cast<float*>(ckpt), L, DI, ST, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

// TMA where every row the boxes read starts 16-byte aligned; plain loads
// by the producer warp otherwise (odd DI, or b and c slices off 16 bytes).
template <typename T, int LPC, bool CKPT>
cudaError_t launch(const void* xc, const void* dt, const void* A, const void* b, const void* c,
                   const void* dskip, void* y, void* h, void* ckpt, int B, int L, int DI, int ST,
                   long long b_sb, long long b_st, long long c_sb, long long c_st,
                   cudaStream_t stream) {
  using S = Stage<T, LPC>;
  constexpr uint64_t ES = sizeof(T);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // A batch stride is never read when B = 1; any valid one will do.
  const uint64_t bs = B > 1 ? b_sb * ES : (uint64_t)L * b_st * ES + 16;
  const uint64_t cs = B > 1 ? c_sb * ES : (uint64_t)L * c_st * ES + 16;
  const bool tma = aligned(xc) && aligned(dt) && aligned(b) && aligned(c) && DI * ES % 16 == 0 &&
                   DI % 4 == 0 && b_st * ES % 16 == 0 && c_st * ES % 16 == 0 && bs % 16 == 0 &&
                   cs % 16 == 0;
  Maps maps = {};
  if (tma) {
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const uint64_t row = DI * ES;
    cudaError_t err = hopper::make_map_3d_plain(&maps.x, xc, ES, bf16, DI, L, B, row, row * L,
                                                S::X::W, TC);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.dt, dt, 4, false, DI, L, B, DI * 4ULL,
                                      DI * 4ULL * L, S::DT::W, TC);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.b, b, ES, bf16, ST, L, B, b_st * ES, bs, S::BC::W,
                                      TC);
    if (err == cudaSuccess)
      err = hopper::make_map_3d_plain(&maps.c, c, ES, bf16, ST, L, B, c_st * ES, cs, S::BC::W,
                                      TC);
    if (err != cudaSuccess) return err;
    return launch_tma<T, LPC, true, CKPT>(maps, xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI,
                                          ST, b_sb, b_st, c_sb, c_st, stream);
  }
  return launch_tma<T, LPC, false, CKPT>(maps, xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI, ST,
                                         b_sb, b_st, c_sb, c_st, stream);
}

template <typename T, bool CKPT>
cudaError_t launch_st(const void* xc, const void* dt, const void* A, const void* b,
                      const void* c, const void* dskip, void* y, void* h, void* ckpt, int B,
                      int L, int DI, int ST, long long b_sb, long long b_st, long long c_sb,
                      long long c_st, cudaStream_t s) {
#define REPRO_MAMBA_LAUNCH(LPC)                                                              \
  return launch<T, LPC, CKPT>(xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI, ST, b_sb, b_st,    \
                              c_sb, c_st, s)
  if (ST <= SPT) REPRO_MAMBA_LAUNCH(1);
  if (ST <= 2 * SPT) REPRO_MAMBA_LAUNCH(2);
  if (ST <= 4 * SPT) REPRO_MAMBA_LAUNCH(4);
  if (ST <= 8 * SPT) REPRO_MAMBA_LAUNCH(8);
#undef REPRO_MAMBA_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool CKPT>
int launch_dtype(const void* xc, const void* dt, const void* A, const void* b, const void* c,
                 const void* dskip, void* y, void* h, void* ckpt, int B, int L, int DI, int ST,
                 long long b_sb, long long b_st, long long c_sb, long long c_st, int dtype,
                 void* stream) {
  if (B < 1 || B > 65535 || L < 1 || DI < 1 || ST < 1 || ST > 8 * SPT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_st<float, CKPT>(xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI, ST, b_sb,
                                         b_st, c_sb, c_st, s);
    case 1:
      return (int)launch_st<__half, CKPT>(xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI, ST, b_sb,
                                          b_st, c_sb, c_st, s);
    case 2:
      return (int)launch_st<__nv_bfloat16, CKPT>(xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI,
                                                 ST, b_sb, b_st, c_sb, c_st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xc (B, L, DI) and dt (B, L, DI) contiguous; A (DI, ST), dskip (DI,)
// contiguous fp32; b and c (B, L, ST) with unit state stride and the given
// batch and time strides, in xc's dtype; y (B, L, DI) and h (B, DI, ST) fp32
// outputs.  dtype of xc, b and c: 0 float32, 1 float16, 2 bfloat16.
// 1 <= ST <= 128.  Returns a cudaError_t (0 on success).
extern "C" int repro_mamba_scan(const void* xc, const void* dt, const void* A, const void* b,
                                const void* c, const void* dskip, void* y, void* h, int B,
                                int L, int DI, int ST, long long b_sb, long long b_st,
                                long long c_sb, long long c_st, int dtype, void* stream) {
  return launch_dtype<false>(xc, dt, A, b, c, dskip, y, h, nullptr, B, L, DI, ST, b_sb, b_st,
                             c_sb, c_st, dtype, stream);
}

// repro_mamba_scan, and the state after every CKPT_STEPS steps written to
// ckpt: (B, ceil(L / CKPT_STEPS) - 1, DI, ST4) fp32, contiguous and 16-byte
// aligned, ST4 = ST rounded up to 4 (padded states 0); entry k is the state
// after step (k + 1) * CKPT_STEPS - 1.
extern "C" int repro_mamba_scan_ckpt(const void* xc, const void* dt, const void* A,
                                     const void* b, const void* c, const void* dskip, void* y,
                                     void* h, void* ckpt, int B, int L, int DI, int ST,
                                     long long b_sb, long long b_st, long long c_sb,
                                     long long c_st, int dtype, void* stream) {
  return launch_dtype<true>(xc, dt, A, b, c, dskip, y, h, ckpt, B, L, DI, ST, b_sb, b_st, c_sb,
                            c_st, dtype, stream);
}
