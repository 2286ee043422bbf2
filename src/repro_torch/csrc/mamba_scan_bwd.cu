// Backward of the Mamba-1 selective scan for Hopper.
//
// Replaces no TPU kernel: the JAX package trains through jax.grad of its XLA
// scan (`chunked_linear_scan`, src/repro/models/layers.py:364, in `mamba_ssm`)
// and its Pallas kernel `mamba_scan` (src/repro/kernels/mamba_scan.py:57) has
// no backward.  The port runs its forward kernel (csrc/mamba_scan.cu) in the
// model, so training needs this one.  Given the forward, per (batch, channel
// d, state s), from h = 0:
//   a_t = exp(dt_t A_ds),  h_t = a_t h_{t-1} + dt_t x_t b_ts,
//   y_t = sum_s c_ts h_t + D_d x_t,
// and dy (B, L, DI) fp32 with an optional dh (B, DI, ST) fp32 for h_L, it
// computes, with g_t = dy_t c_ts + a_{t+1} g_{t+1} (g_L = dy_L c_L + dh):
//   dx_t  = D_d dy_t + dt_t sum_s g_t b_ts                     (B, L, DI), xc's dtype
//   ddt_t = sum_s g_t (A_ds a_t h_{t-1} + x_t b_ts)            (B, L, DI), fp32
//   dA_ds = sum_{b,t} g_t dt_t a_t h_{t-1}                      (DI, ST), fp32
//   dD_d  = sum_{b,t} dy_t x_t                                  (DI,), fp32
//   db_ts = sum_d g_t dt_t x_t,  dc_ts = sum_d dy_t h_t         (B, L, ST), b's dtype
// Inputs as the forward takes them: xc (B, L, DI), b and c (B, L, ST) in one
// dtype (fp32, fp16 or bf16; b and c with any batch and time stride, read in
// place), dt (B, L, DI), A (DI, ST) and D (DI,) in fp32, and the forward's
// checkpoints: the state after every TC = 8 steps, (B, ceil(L / 8) - 1, DI,
// ST4) fp32 (csrc/mamba_scan.cu, repro_mamba_scan_ckpt).  All arithmetic is
// fp32 and each output is rounded once.
//
// Bound on the H100 SXM at falcon-mamba-7b's training shape (B = 4,
// L = 4096, DI = 8192, ST = 16, bf16 xc, b and c): xc 268 MB, dt 537 MB and
// dy 537 MB read, dx 268 MB and ddt 537 MB written: 2.15 GB, 0.64 ms at
// 3.35 TB/s; its 2.15 G decays at the SFUs' 16 a clock on each SM take
// 0.51 ms.  So the bound is the bytes.  As in the forward, the tensor cores
// do not apply (the decay differs for every channel and state).
//
// Design.  The backward walks time in reverse and needs h_{t-1} there.  The
// recurrence cannot be run backwards (a_t underflows to 0), so each chunk of
// TC = 8 steps is recomputed from the state at its start, which the forward
// kernel wrote: under remat the forward runs again just before this kernel,
// so no walk of the whole sequence happens here, and no checkpoints go
// through device memory twice.  A block of 128 threads owns a batch row and
// CPB = 64 channels; a thread owns SPL = 4 states of each of CPT = 2
// channels, a channel's ST = 16 states spread over LPC = 4 lanes (up to 32
// lanes at ST = 128).  That is 512 blocks at the training shape, four an SM
// at 128 registers a thread: 16 warps an SM.
// * Per chunk, from its checkpoint: the TC steps forward with the forward's
//   own instructions (ex2.approx.ftz on A scaled by log2 e, then one FMA), so
//   the states are the forward's, each step's h_{t-1} stored to the thread's
//   column of a 32 KB shared history; then the TC steps backwards with g,
//   a_t g_t and the dA sums in registers.  h_t in a reverse step is the later
//   step's h_{t-1}, still in registers, and g_t a_t h_{t-1} is (a_t g_t)
//   h_{t-1}: one FMUL, no product a_t h_{t-1}, no second FMA for h_t.
// * Sums over lanes, each a butterfly that halves the values a lane holds at
//   each exchange.  A lane's share of dx - D dy = dt sum_s g b and of ddt =
//   sum_s g a h_{t-1} A + x sum_s g b for its 2 channels (4 values) over the
//   channel's 4 lanes: each lane ends with one of them and stages it in
//   shared memory.  The thread's db and dc terms, added over its 2 channels
//   in registers (8 values), over the warp's 8 channel groups; then the
//   block's 4 warps in shared memory, written as fp32 partials (DI / CPB, B,
//   L, ST).  dA and dD go out as partials (B, DI, ST) and (B, DI).  A
//   second kernel adds the partials in a fixed order and rounds once: no
//   float atomics, and two launches give the same bits.
// * The next chunk's inputs (x, dt, dy, b, c) and checkpoint are loaded into
//   registers while the current one runs, then staged in shared memory as
//   fp32; zeros past L, DI and ST make those steps and lanes add nothing.
//   After the chunk, its dx (D dy added there) and ddt go out coalesced.
// What bounds it: the sums over lanes, about 40 shuffles, selects and adds
// a thread and step, and the two decays and some twenty FMAs and FMULs an
// (element, state): it is bound by instruction issue, far above both the
// bytes and the SFUs (tools/scan_bwd_variants.py, bf16, the kernel at 2.80
// ms in that run: without the sums over lanes it takes 2.03 ms, without
// either pass's exps 2.70-2.75; keeping the decays beside the states
// halves the occupancy and is slower).
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (tools/time_bag_checks.py
// --scan-ssm, in turns with the design before, which walked the whole
// sequence forward again for its own checkpoints; PERF.md section 6, row
// 4b): 2.83 ms a call at the training shape in bf16 and 2.82-2.83 in fp32,
// against 4.47-4.49 and 4.38 before; 22.7% and 28.4% of the bound; 128
// registers, no spills.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int SPL = 4;              // states a lane
constexpr int CPT = 2;              // channels a thread
constexpr int TC = 8;               // steps a chunk: the forward's checkpoint interval
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CPT == 2, "load_channels reads two channels");

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

// Shapes of a block and its shared memory, in floats: the chunk's h_{t-1}
// ([t][channel][thread][4], each thread its own column), x, dt and dy
// ([t][channel]), b and c
// ([t][state]), the warps' sums of the db and dc terms ([db, dc][warp][t]
// [state]), and dx and ddt as the chunk's steps give them ([t][channel]).
// Staging thread tid moves channel tid % CPB of steps tid / CPB + k * TPX
// of x, dt, dy, dx and ddt, and state tid % SP of steps tid / SP + k * TPB
// of b and c.
template <int LPC> struct Cfg {
  static constexpr int GPB = THREADS / LPC;  // channel groups a block
  static constexpr int CPB = GPB * CPT;      // channels a block
  static constexpr int SP = LPC * SPL;       // states a channel, padded
  static constexpr int TPX = THREADS / CPB;  // steps one pass of the threads stages
  static constexpr int TPB = THREADS / SP;
  static constexpr int NX = (TC + TPX - 1) / TPX;  // x, dt, dy a thread stages
  static constexpr int NB = (TC + TPB - 1) / TPB;  // b, c a thread stages
  static constexpr int NR = (2 * TC * SP + THREADS - 1) / THREADS;  // db, dc sums a thread adds
  static constexpr int HIST = TC * CPT * SPL * THREADS;
  static constexpr int OFF_X = HIST;
  static constexpr int OFF_DT = OFF_X + TC * CPB;
  static constexpr int OFF_DY = OFF_DT + TC * CPB;
  static constexpr int OFF_OX = OFF_DY + TC * CPB;
  static constexpr int OFF_ODT = OFF_OX + TC * CPB;
  static constexpr int OFF_B = OFF_ODT + TC * CPB;
  static constexpr int OFF_C = OFF_B + TC * SP;
  static constexpr int OFF_RED = OFF_C + TC * SP;
  static constexpr int SMEM = (OFF_RED + 2 * WARPS * TC * SP) * 4;
  static_assert(THREADS % CPB == 0 && THREADS % SP == 0, "staging layout");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct Args {
  const void* xc;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const float* dskip;
  const float* dy;
  const float* dh;    // may be null: dh = 0
  const float* ckpt;  // (B, NC - 1, DI, ST4): the state after chunk k
  void* dxc;
  float* ddt;
  float* dbp;  // (G, B, L, ST) partial sums over a block's channels
  float* dcp;
  float* dAp;  // (B, DI, ST)
  float* dDp;  // (B, DI)
  int B, L, DI, ST;
  long long b_sb, b_st, c_sb, c_st;
};

// A chunk's inputs as a thread loads them, raw, before it stages them in
// shared memory as fp32; and where they come from: x, dt and dy at element
// gx + k * TPX * DI of chunk 0, b and c at step tb + k * TPB, state sb.
template <typename T, int LPC> struct Staged {
  using C = Cfg<LPC>;
  T x[C::NX];
  float dt[C::NX], dy[C::NX];
  T b[C::NB], c[C::NB];

  // Element (bi, t0 + tid / CPB, d0 + tid % CPB) of x, dt and dy.
  static __device__ __forceinline__ size_t at(const Args& p, int bi, int t0, int d0, int tid) {
    return ((size_t)bi * p.L + t0 + tid / C::CPB) * p.DI + d0 + tid % C::CPB;
  }

  __device__ __forceinline__ void load(const Args& p, int i, int bi, int d0, int tid) {
    const int t0 = i * TC;
    const size_t g = at(p, bi, t0, d0, tid), step = (size_t)C::TPX * p.DI;
    const bool d_ok = d0 + tid % C::CPB < p.DI;
    const T* xc = static_cast<const T*>(p.xc);
#pragma unroll
    for (int k = 0; k < C::NX; ++k) {
      const int t = tid / C::CPB + k * C::TPX;
      const bool ok = d_ok && t < TC && t0 + t < p.L;
      x[k] = ok ? xc[g + k * step] : T(0.f);
      dt[k] = ok ? p.dt[g + k * step] : 0.f;
      dy[k] = ok ? p.dy[g + k * step] : 0.f;
    }
    const int sb = tid % C::SP;
    const T* bm = static_cast<const T*>(p.b) + bi * p.b_sb + sb;
    const T* cm = static_cast<const T*>(p.c) + bi * p.c_sb + sb;
#pragma unroll
    for (int k = 0; k < C::NB; ++k) {
      const int t = tid / C::SP + k * C::TPB;
      const bool ok = sb < p.ST && t < TC && t0 + t < p.L;
      b[k] = ok ? bm[(t0 + t) * p.b_st] : T(0.f);
      c[k] = ok ? cm[(t0 + t) * p.c_st] : T(0.f);
    }
  }

  __device__ __forceinline__ void store(float* sm, int tid) const {
#pragma unroll
    for (int k = 0; k < C::NX; ++k) {
      const int e = tid + k * THREADS;
      if (C::NX * C::TPX <= TC || e < TC * C::CPB) {
        sm[C::OFF_X + e] = to_float<T>(x[k]);
        sm[C::OFF_DT + e] = dt[k];
        sm[C::OFF_DY + e] = dy[k];
      }
    }
#pragma unroll
    for (int k = 0; k < C::NB; ++k) {
      const int e = tid + k * THREADS;
      if (C::NB * C::TPB <= TC || e < TC * C::SP) {
        sm[C::OFF_B + e] = to_float<T>(b[k]);
        sm[C::OFF_C + e] = to_float<T>(c[k]);
      }
    }
  }

  // The chunk's dx (D dy added here) and ddt, staged by the reverse steps,
  // to device memory.
  static __device__ __forceinline__ void write_out(const Args& p, int i, int bi, int d0,
                                                   const float* sm, int tid) {
    const int t0 = i * TC, ch = tid % C::CPB;
    const size_t g = at(p, bi, t0, d0, tid), step = (size_t)C::TPX * p.DI;
    if (d0 + ch >= p.DI) return;
    const float dsk = p.dskip[d0 + ch];
    T* dxc = static_cast<T*>(p.dxc);
#pragma unroll
    for (int k = 0; k < C::NX; ++k) {
      const int t = tid / C::CPB + k * C::TPX;
      if (t < TC && t0 + t < p.L) {
        const int e = tid + k * THREADS;
        dxc[g + k * step] = from_float<T>(fmaf(dsk, sm[C::OFF_DY + e], sm[C::OFF_OX + e]));
        p.ddt[g + k * step] = sm[C::OFF_ODT + e];
      }
    }
  }
};

// The CPT values of the thread's channels at p (8-byte aligned).
__device__ __forceinline__ void load_channels(float (&v)[CPT], const float* p) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}

// The state at the start of chunk k (zeros for k = 0) of channels d .. d +
// CPT - 1, states s0 .. s0 + 3, from the checkpoints.
__device__ __forceinline__ void load_state(float (&h)[CPT][SPL], const Args& p, int k, int NC,
                                           int bi, int d, int s0) {
  const int ST4 = (p.ST + 3) & ~3;
  const float* ck = p.ckpt + (((size_t)bi * (NC - 1) + k - 1) * p.DI + d) * ST4 + s0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k > 0 && d + c < p.DI && s0 < ST4) v = *reinterpret_cast<const float4*>(ck + c * ST4);
    h[c][0] = v.x; h[c][1] = v.y; h[c][2] = v.z; h[c][3] = v.w;
  }
}

// One exchange of a butterfly over lane bit M on the first N values of v:
// lanes with bit M set keep the upper half of them, the others the lower
// half, each adding its partner's copy of the half it keeps.
template <int N, int CAP>
__device__ __forceinline__ void halve(float (&v)[CAP], int lane, int M) {
  constexpr int H = N / 2;
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

// v[0 .. N - 1] summed over the lanes that differ in the lane bits BIT,
// 2 BIT, .. below END: halved while more than KEEP values are left, then
// the rest added whole.  Afterwards v[0 .. min(N, KEEP) - 1] hold the sums
// of values kept_base<..>(lane) .. of the original order.
template <int N, int KEEP, int BIT, int END, int CAP>
__device__ __forceinline__ void sum_lanes(float (&v)[CAP], int lane) {
  if constexpr (BIT < END) {
    if constexpr (N > KEEP) {
      halve<N>(v, lane, BIT);
      sum_lanes<N / 2, KEEP, 2 * BIT, END>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(FULL, v[i], BIT);
      sum_lanes<N, KEEP, 2 * BIT, END>(v, lane);
    }
  }
}

template <int N, int KEEP, int BIT, int END>
__device__ __forceinline__ int kept_base(int lane) {
  if constexpr (BIT < END && N > KEEP)
    return (lane & BIT ? N / 2 : 0) + kept_base<N / 2, KEEP, 2 * BIT, END>(lane);
  else
    return 0;
}

// One block: batch row blockIdx.y, channels blockIdx.x * CPB .. + CPB - 1;
// thread tid owns states s0 .. s0 + 3 of channels ch0 .. ch0 + CPT - 1.
template <typename T, int LPC>
__global__ void __launch_bounds__(THREADS, LPC == 4 ? 4 : 2)  // 4 blocks an SM at ST <= 16
    mamba_bwd_kernel(const Args p) {
  using C = Cfg<LPC>;
  constexpr int CPB = C::CPB, SP = C::SP, G = 32 / LPC;
  constexpr int KEPT = 2 * SPL / G > 1 ? 2 * SPL / G : 1;  // db, dc sums a lane keeps
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float4* hist = smem4;
  float* red = sm + C::OFF_RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_c = tid % LPC, ch0 = (tid / LPC) * CPT, s0 = lane_c * SPL;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch0;
  const int L = p.L, DI = p.DI, ST = p.ST;
  const int NC = (L + TC - 1) / TC;

  float a2[CPT][SPL];     // A scaled by log2(e), as the forward scales it
  float carry[CPT][SPL];  // a_{t+1} g_{t+1}
  float dA[CPT][SPL], dD[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const bool ok = d + c < DI && s0 + j < ST;
      a2[c][j] = ok ? p.A[(size_t)(d + c) * ST + s0 + j] * LOG2E : 0.f;
      carry[c][j] = (ok && p.dh != nullptr) ? p.dh[((size_t)bi * DI + d + c) * ST + s0 + j] : 0.f;
      dA[c][j] = 0.f;
    }
    dD[c] = 0.f;
  }
  // After the sums over a channel's lanes, a lane holds KO of its channels'
  // dx and ddt (dx of ch0, ddt of ch0, dx of ch0 + 1, ..); after the sums
  // over the warp's groups, the db, dc sums vb .. vb + KEPT - 1 (db's
  // states, then dc's) of its states.
  constexpr int KO = 2 * CPT > LPC ? 2 * CPT / LPC : 1;  // dx, ddt sums a lane keeps
  int ooff[KO];  // where in shared memory they go, at step 0
#pragma unroll
  for (int n = 0; n < KO; ++n) {
    const int e = kept_base<2 * CPT, 1, 1, LPC>(lane) + n;
    ooff[n] = (e % 2 ? C::OFF_ODT : C::OFF_OX) + ch0 + e / 2;
  }
  const int vb = kept_base<2 * SPL, 1, LPC, 32>(lane);
  int roff[KEPT];
#pragma unroll
  for (int i = 0; i < KEPT; ++i)
    roff[i] = ((vb + i) / SPL * WARPS + warp) * TC * SP + s0 + (vb + i) % SPL;
  Staged<T, LPC> stage;
  float hs[CPT][SPL];  // the next chunk's start
  stage.load(p, NC - 1, bi, d0, tid);
  load_state(hs, p, NC - 1, NC, bi, d, s0);
  for (int k = NC - 1; k >= 0; --k) {
    const int t0 = k * TC;
    __syncthreads();
    stage.store(sm, tid);
    __syncthreads();
    float h[CPT][SPL];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < SPL; ++j) h[c][j] = hs[c][j];
    if (k > 0) {
      stage.load(p, k - 1, bi, d0, tid);
      load_state(hs, p, k - 1, NC, bi, d, s0);
    }

    // The chunk forward from its start, as the forward kernel runs it (the
    // same instructions, so the same states); each step's h_{t-1} to the
    // thread's column of the history first.
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      float xv[CPT], dv[CPT];
      load_channels(xv, sm + C::OFF_X + t * CPB + ch0);
      load_channels(dv, sm + C::OFF_DT + t * CPB + ch0);
      const float4 bq = *reinterpret_cast<const float4*>(sm + C::OFF_B + t * SP + s0);
      const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        hist[(t * CPT + c) * THREADS + tid] = make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
        const float dx = dv[c] * xv[c];
#pragma unroll
        for (int j = 0; j < SPL; ++j)
          h[c][j] = fmaf(hopper::exp2_approx(dv[c] * a2[c][j]), h[c][j], dx * bv[j]);
      }
    }

    // The chunk backwards.  h holds h_t, the history h_{t-1}.  Unrolled by
    // 4, not 8: fully unrolled, 128 registers spill.
#pragma unroll 4
    for (int t = TC - 1; t >= 0; --t) {
      float xv[CPT], dv[CPT], gy[CPT];
      load_channels(xv, sm + C::OFF_X + t * CPB + ch0);
      load_channels(dv, sm + C::OFF_DT + t * CPB + ch0);
      load_channels(gy, sm + C::OFF_DY + t * CPB + ch0);
      const float4 bq = *reinterpret_cast<const float4*>(sm + C::OFF_B + t * SP + s0);
      const float4 cq = *reinterpret_cast<const float4*>(sm + C::OFF_C + t * SP + s0);
      const float bv[SPL] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[SPL] = {cq.x, cq.y, cq.z, cq.w};
      float v[2 * SPL];  // this thread's db terms, then its dc terms, over its channels
      float pr[2 * CPT];  // per channel: this lane's terms of dx and of ddt
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 hq = hist[(t * CPT + c) * THREADS + tid];
        const float hp[SPL] = {hq.x, hq.y, hq.z, hq.w};
        float al[SPL];  // a_t, the walk's decays again
#pragma unroll
        for (int j = 0; j < SPL; ++j) al[j] = hopper::exp2_approx(dv[c] * a2[c][j]);
        const float dx = dv[c] * xv[c];
        float gb = 0.f, gua = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const float g = fmaf(gy[c], cv[j], carry[c][j]);
          carry[c][j] = al[j] * g;
          gb = fmaf(g, bv[j], gb);
          const float gu = carry[c][j] * hp[j];  // g_t a_t h_{t-1}
          gua = fmaf(gu, a2[c][j], gua);
          dA[c][j] = fmaf(gu, dv[c], dA[c][j]);
          v[j] = c == 0 ? g * dx : fmaf(g, dx, v[j]);
          v[SPL + j] = c == 0 ? gy[c] * h[c][j] : fmaf(gy[c], h[c][j], v[SPL + j]);
          h[c][j] = hp[j];
        }
        pr[2 * c] = dv[c] * gb;                       // dx - D dy = dt sum_s g b
        pr[2 * c + 1] = fmaf(gua, LN2, xv[c] * gb);     // ddt = sum_s g a h A + x sum_s g b
        dD[c] = fmaf(gy[c], xv[c], dD[c]);
      }
      // dx and ddt of each channel summed over its LPC lanes: each lane ends
      // with KO of them and stages them.
      sum_lanes<2 * CPT, 1, 1, LPC>(pr, lane);
#pragma unroll
      for (int n = 0; n < KO; ++n) sm[ooff[n] + t * CPB] = pr[n];
      // The db and dc terms over the warp's channel groups.
      sum_lanes<2 * SPL, 1, LPC, 32>(v, lane);
#pragma unroll
      for (int i = 0; i < KEPT; ++i) red[roff[i] + t * SP] = v[i];
    }
    __syncthreads();
    Staged<T, LPC>::write_out(p, k, bi, d0, sm, tid);
    // The chunk's db and dc terms summed over the block's warps, in order.
#pragma unroll
    for (int n = 0; n < C::NR; ++n) {
      const int i = tid + n * THREADS, arr = i / (TC * SP), r = i % (TC * SP);
      const int t = r / SP, s = r % SP;
      if ((C::NR * THREADS <= 2 * TC * SP || i < 2 * TC * SP) && s < ST && t0 + t < L) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red[(arr * WARPS + w) * TC * SP + r];
        (arr ? p.dcp : p.dbp)[(((size_t)blockIdx.x * p.B + bi) * L + t0 + t) * ST + s] = sum;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (d + c >= DI) continue;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (s0 + j < ST) p.dAp[((size_t)bi * DI + d + c) * ST + s0 + j] = dA[c][j];
    if (lane_c == 0) p.dDp[(size_t)bi * DI + d + c] = dD[c];
  }
}

// The partials added in a fixed order and rounded once: db and dc over the
// channel groups, dA and dD over the batch.
template <typename T>
__global__ void __launch_bounds__(256) mamba_bwd_reduce_kernel(
    const float* __restrict__ dbp, const float* __restrict__ dcp, const float* __restrict__ dAp,
    const float* __restrict__ dDp, T* __restrict__ db, T* __restrict__ dc,
    float* __restrict__ dA, float* __restrict__ dD, int G, int B, int L, int DI, int ST) {
  const long long n1 = (long long)B * L * ST, n2 = (long long)DI * ST, n3 = DI;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n1 + n2 + n3;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n1) {
      float sb = 0.f, sc = 0.f;
      for (int g = 0; g < G; ++g) {
        sb += dbp[g * n1 + i];
        sc += dcp[g * n1 + i];
      }
      db[i] = from_float<T>(sb);
      dc[i] = from_float<T>(sc);
    } else if (i < n1 + n2) {
      const long long j = i - n1;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += dAp[b * n2 + j];
      dA[j] = s;
    } else {
      const long long j = i - n1 - n2;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += dDp[b * n3 + j];
      dD[j] = s;
    }
  }
}

int lpc_of(int ST) { return ST <= 16 ? 4 : ST <= 32 ? 8 : ST <= 64 ? 16 : 32; }

int groups_of(int DI, int ST) {
  const int cpb = THREADS / lpc_of(ST) * CPT;
  return (DI + cpb - 1) / cpb;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Workspace layout, in bytes: db and dc partials, dA and dD partials, each
// 256-byte aligned.
struct Workspace {
  size_t dbp, dcp, dAp, dDp, total;
  Workspace(int B, int L, int DI, int ST) {
    const size_t G = groups_of(DI, ST);
    dbp = 0;
    dcp = dbp + align256(G * B * L * ST * 4);
    dAp = dcp + align256(G * B * L * ST * 4);
    dDp = dAp + align256((size_t)B * DI * ST * 4);
    total = dDp + align256((size_t)B * DI * 4);
  }
};

template <typename T, int LPC>
cudaError_t launch(Args p, void* db, void* dc, float* dA, float* dD, cudaStream_t stream) {
  using C = Cfg<LPC>;
  cudaError_t err = cudaFuncSetAttribute(mamba_bwd_kernel<T, LPC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int G = groups_of(p.DI, p.ST);
  mamba_bwd_kernel<T, LPC><<<dim3(G, p.B), THREADS, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)p.B * p.L * p.ST + (long long)p.DI * p.ST + p.DI;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  mamba_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      p.dbp, p.dcp, p.dAp, p.dDp, static_cast<T*>(db), static_cast<T*>(dc), dA, dD, G, p.B,
      p.L, p.DI, p.ST);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_st(const Args& p, void* db, void* dc, float* dA, float* dD, cudaStream_t s) {
  switch (lpc_of(p.ST)) {
    case 4: return launch<T, 4>(p, db, dc, dA, dD, s);
    case 8: return launch<T, 8>(p, db, dc, dA, dD, s);
    case 16: return launch<T, 16>(p, db, dc, dA, dD, s);
    default: return launch<T, 32>(p, db, dc, dA, dD, s);
  }
}

}  // namespace

// Bytes of scratch that repro_mamba_scan_bwd needs at these sizes.
extern "C" long long repro_mamba_scan_bwd_workspace(int B, int L, int DI, int ST) {
  return (long long)Workspace(B, L, DI, ST).total;
}

// Steps between the checkpoints that repro_mamba_scan_bwd reads.
extern "C" int repro_mamba_scan_bwd_chunk() { return TC; }

// xc, dt, dy (B, L, DI) contiguous; A (DI, ST), dskip (DI,) contiguous fp32;
// b and c (B, L, ST) with unit state stride and the given batch and time
// strides, in xc's dtype; dh (B, DI, ST) fp32 or null; ckpt (B, ceil(L / TC)
// - 1, DI, ST4) fp32 contiguous and 16-byte aligned, ST4 = ST rounded up to
// 4: the forward's checkpoints (repro_mamba_scan_ckpt).  Outputs: dxc (B, L,
// DI) in xc's dtype, ddt (B, L, DI) fp32, dA (DI, ST) fp32, db and dc (B, L,
// ST) contiguous in xc's dtype, dD (DI,) fp32.  workspace: 256-byte aligned,
// repro_mamba_scan_bwd_workspace bytes.  dtype of xc, b and c: 0 float32,
// 1 float16, 2 bfloat16.  1 <= ST <= 128.  Two launches on the stream.
// Returns a cudaError_t (0 on success).
extern "C" int repro_mamba_scan_bwd(const void* xc, const void* dt, const void* A, const void* b,
                                    const void* c, const void* dskip, const void* dy,
                                    const void* dh, const void* ckpt, void* dxc, void* ddt,
                                    void* dA, void* db, void* dc, void* dD, void* workspace,
                                    int B, int L, int DI, int ST, long long b_sb, long long b_st,
                                    long long c_sb, long long c_st, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || DI < 1 || ST < 1 || ST > 128)
    return (int)cudaErrorInvalidValue;
  const Workspace ws(B, L, DI, ST);
  uint8_t* w = static_cast<uint8_t*>(workspace);
  Args p;
  p.xc = xc;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = b;
  p.c = c;
  p.dskip = static_cast<const float*>(dskip);
  p.dy = static_cast<const float*>(dy);
  p.dh = static_cast<const float*>(dh);
  p.ckpt = static_cast<const float*>(ckpt);
  p.dxc = dxc;
  p.ddt = static_cast<float*>(ddt);
  p.dbp = reinterpret_cast<float*>(w + ws.dbp);
  p.dcp = reinterpret_cast<float*>(w + ws.dcp);
  p.dAp = reinterpret_cast<float*>(w + ws.dAp);
  p.dDp = reinterpret_cast<float*>(w + ws.dDp);
  p.B = B;
  p.L = L;
  p.DI = DI;
  p.ST = ST;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fA = static_cast<float*>(dA);
  float* fD = static_cast<float*>(dD);
  switch (dtype) {
    case 0: return (int)launch_st<float>(p, db, dc, fA, fD, s);
    case 1: return (int)launch_st<__half>(p, db, dc, fA, fD, s);
    case 2: return (int)launch_st<__nv_bfloat16>(p, db, dc, fA, fD, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
