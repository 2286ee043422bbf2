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
// place), dt (B, L, DI), A (DI, ST) and D (DI,) in fp32.  All arithmetic is
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
// recurrence cannot be run backwards (a_t underflows to 0), so the states are
// recomputed from checkpoints.  One block of 128 threads owns a batch row and
// CPB channels; a thread owns SPT = 16 states of one channel (ST up to 128
// spreads a channel over LPC = 2, 4 or 8 lanes), as in the forward.
// * Pass 1 walks forward from h = 0 and writes the state every TC = 8 steps
//   to a scratch buffer (B, L/8, DI, ST) fp32: 1.07 GB at the training shape.
// * Pass 2 walks the chunks in reverse.  It recomputes the chunk's 8 states
//   of each step from its checkpoint into shared memory (64 KB a block, so
//   two blocks share an SM), then runs the 8 steps backwards with g and the
//   dA sums in registers.  The decays are recomputed with the forward's own
//   instruction (ex2.approx.ftz on A scaled by log2 e), so the states are the
//   forward's.
// * Each step's db and dc terms are summed over the warp's channels by a
//   butterfly that halves the values a lane holds at each exchange (16
//   shuffles for 16 states), then over the block's 4 warps in shared memory,
//   and written as fp32 partials (DI / CPB, B, L, ST); dA and dD as partials
//   (B, DI, ST) and (B, DI).  A second kernel adds the partials in a fixed
//   order and rounds once: no float atomics, and two launches give the same
//   bits.
// * The inputs of the next chunk are loaded into registers while the current
//   one runs (x, dt, dy, b, c, and the next checkpoint), then staged in shared
//   memory as fp32; zeros past L, DI and ST make those steps and lanes add
//   nothing.
// What bounds it: three decays an (element, state), one a pass, and some
// thirty other instructions, so it is bound by instruction issue far above
// the bytes.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 3;
// PERF.md section 6, row 4b): 4.44 ms a call at the training shape in bf16
// and 4.33 in fp32, 14.5% and 18.5% of the bound; 212-244 registers, no
// spills.  A chunk of 16 steps (a 128 KB history, one block an SM) was
// tried and ran slower.  Fewer recomputed decays and a cheaper sum over the
// channels are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int SPT = 16;  // states a thread
constexpr int TC = 8;    // steps a chunk; a checkpoint every chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

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
// ([t][j / 4][thread][4], each thread its own column), then x, dt and dy
// ([t][channel]), b and c ([t][state]), then the warps' sums of the db and
// dc terms ([db, dc][warp][t][state]).
template <int LPC> struct Cfg {
  static constexpr int CPB = THREADS / LPC;      // channels a block
  static constexpr int SP = LPC * SPT;           // states a channel, padded
  static constexpr int NX = TC * CPB / THREADS;  // x, dt, dy values a thread stages a chunk
  static constexpr int NB = TC * SP / THREADS;   // b, c values a thread stages a chunk
  static constexpr int OFF_X = TC * SPT * THREADS;
  static constexpr int OFF_DT = OFF_X + TC * CPB;
  static constexpr int OFF_DY = OFF_DT + TC * CPB;
  static constexpr int OFF_B = OFF_DY + TC * CPB;
  static constexpr int OFF_C = OFF_B + TC * SP;
  static constexpr int OFF_RED = OFF_C + TC * SP;
  static constexpr int SMEM = (OFF_RED + 2 * WARPS * TC * SP) * 4;
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
  const float* dh;  // may be null: dh = 0
  void* dxc;
  float* ddt;
  float* ckpt;  // (B, NC - 1, DI, SP): the state after chunk k
  float* dbp;   // (G, B, L, ST) partial sums over a block's channels
  float* dcp;
  float* dAp;   // (B, DI, ST)
  float* dDp;   // (B, DI)
  int B, L, DI, ST;
  long long b_sb, b_st, c_sb, c_st;
};

// A chunk's inputs as a thread loads them, raw, before it stages them in
// shared memory as fp32.  Element e = tid + k * THREADS of a chunk is (t, ch)
// = (e / CPB, e % CPB) of x, dt and dy and (e / SP, e % SP) of b and c.
template <typename T, int LPC> struct Staged {
  using C = Cfg<LPC>;
  T x[C::NX];
  float dt[C::NX], dy[C::NX];
  T b[C::NB], c[C::NB];

  template <bool GRAD>
  __device__ __forceinline__ void load(const Args& p, int i, int bi, int d0, int tid) {
    const int t0 = i * TC;
    const T* xc = static_cast<const T*>(p.xc);
    const T* bm = static_cast<const T*>(p.b);
    const T* cm = static_cast<const T*>(p.c);
#pragma unroll
    for (int k = 0; k < C::NX; ++k) {
      const int e = tid + k * THREADS, t = e / C::CPB, ch = e % C::CPB;
      const size_t g = ((size_t)bi * p.L + t0 + t) * p.DI + d0 + ch;
      x[k] = T(0.f);
      dt[k] = 0.f;
      dy[k] = 0.f;
      if (t0 + t < p.L && d0 + ch < p.DI) {
        x[k] = xc[g];
        dt[k] = p.dt[g];
        if (GRAD) dy[k] = p.dy[g];
      }
    }
#pragma unroll
    for (int k = 0; k < C::NB; ++k) {
      const int e = tid + k * THREADS, t = e / C::SP, s = e % C::SP;
      b[k] = T(0.f);
      c[k] = T(0.f);
      if (t0 + t < p.L && s < p.ST) {
        b[k] = bm[bi * p.b_sb + (t0 + t) * p.b_st + s];
        if (GRAD) c[k] = cm[bi * p.c_sb + (t0 + t) * p.c_st + s];
      }
    }
  }

  template <bool GRAD> __device__ __forceinline__ void store(float* sm, int tid) const {
#pragma unroll
    for (int k = 0; k < C::NX; ++k) {
      const int e = tid + k * THREADS;
      sm[C::OFF_X + e] = to_float<T>(x[k]);
      sm[C::OFF_DT + e] = dt[k];
      if (GRAD) sm[C::OFF_DY + e] = dy[k];
    }
#pragma unroll
    for (int k = 0; k < C::NB; ++k) {
      const int e = tid + k * THREADS;
      sm[C::OFF_B + e] = to_float<T>(b[k]);
      if (GRAD) sm[C::OFF_C + e] = to_float<T>(c[k]);
    }
  }
};

// The state after chunk k - 1 (zeros for k = 0), from the checkpoints.
template <int LPC>
__device__ __forceinline__ void load_state(float (&h)[SPT], const Args& p, int k, int NC,
                                           int bi, int d, int s0) {
  constexpr int SP = Cfg<LPC>::SP;
#pragma unroll
  for (int j = 0; j < SPT; ++j) h[j] = 0.f;
  if (k == 0 || d >= p.DI) return;
  const float4* src = reinterpret_cast<const float4*>(
      p.ckpt + (((size_t)bi * (NC - 1) + k - 1) * p.DI + d) * SP + s0);
#pragma unroll
  for (int q = 0; q < SPT / 4; ++q) {
    const float4 v = src[q];
    h[4 * q] = v.x; h[4 * q + 1] = v.y; h[4 * q + 2] = v.z; h[4 * q + 3] = v.w;
  }
}

// The chunk's TC steps forward from h, as the forward kernel runs them (the
// same instructions, so the same states); with HIST, each step's h_{t-1}
// goes to the thread's column of the shared history first.
template <int LPC, bool HIST>
__device__ __forceinline__ void walk(float (&h)[SPT], const float (&a2)[SPT], float* sm, int tid,
                                     int ch, int s0) {
  using C = Cfg<LPC>;
  float4* hist = reinterpret_cast<float4*>(sm);
#pragma unroll
  for (int t = 0; t < TC; ++t) {
    const float xv = sm[C::OFF_X + t * C::CPB + ch];
    const float dv = sm[C::OFF_DT + t * C::CPB + ch];
    const float dx = dv * xv;
    const float4* b4 = reinterpret_cast<const float4*>(sm + C::OFF_B + t * C::SP + s0);
#pragma unroll
    for (int q = 0; q < SPT / 4; ++q) {
      if (HIST)
        hist[(t * (SPT / 4) + q) * THREADS + tid] =
            make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      const float4 bq = b4[q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        h[j] = fmaf(hopper::exp2_approx(dv * a2[j]), h[j], dx * bv[i]);
      }
    }
  }
}

// One exchange of the butterfly: lanes with bit M set keep the upper half of
// the M values they hold, the others the lower half, each adding its
// partner's copy of the half it keeps.  Returns the offset of the kept half.
template <int M> __device__ __forceinline__ int halve(float (&v)[SPT], int lane) {
  constexpr int H = M / 2;
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
  return up ? H : 0;
}

// v summed over the warp's channels (the lanes with the same lane % LPC):
// afterwards v[0 .. max(1, LPC / 2) - 1] hold the sums of states s0 + base +
// i, where base is returned.  At LPC = 1 lanes 2m and 2m + 1 hold the same
// sum.
template <int LPC> __device__ __forceinline__ int sum_channels(float (&v)[SPT], int lane) {
  int base = halve<16>(v, lane);
  if constexpr (LPC <= 8) base += halve<8>(v, lane);
  if constexpr (LPC <= 4) base += halve<4>(v, lane);
  if constexpr (LPC <= 2) base += halve<2>(v, lane);
  if constexpr (LPC == 1) v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return base;
}

// One block: batch row blockIdx.y, channels blockIdx.x * CPB .. + CPB - 1.
template <typename T, int LPC>
__global__ void __launch_bounds__(THREADS, 2) mamba_bwd_kernel(const Args p) {
  using C = Cfg<LPC>;
  constexpr int CPB = C::CPB, SP = C::SP, R = LPC / 2 > 1 ? LPC / 2 : 1;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float4* hist = smem4;
  float* red = sm + C::OFF_RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_c = tid % LPC, ch = tid / LPC, s0 = lane_c * SPT;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const int L = p.L, DI = p.DI, ST = p.ST;
  const int NC = (L + TC - 1) / TC;
  const bool dvalid = d < DI;

  float a2[SPT];  // A scaled by log2(e), as the forward scales it
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    a2[j] = (dvalid && s0 + j < ST) ? p.A[(size_t)d * ST + s0 + j] * LOG2E : 0.f;
  const float dsk = dvalid ? p.dskip[d] : 0.f;

  // Pass 1: the state after every chunk but the last, from h = 0.
  Staged<T, LPC> stage;
  float h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) h[j] = 0.f;
  if (NC > 1) stage.template load<false>(p, 0, bi, d0, tid);
  for (int k = 0; k + 1 < NC; ++k) {
    __syncthreads();
    stage.template store<false>(sm, tid);
    __syncthreads();
    if (k + 2 < NC) stage.template load<false>(p, k + 1, bi, d0, tid);
    walk<LPC, false>(h, a2, sm, tid, ch, s0);
    if (dvalid) {
      float4* dst = reinterpret_cast<float4*>(p.ckpt + (((size_t)bi * (NC - 1) + k) * DI + d) * SP
                                              + s0);
#pragma unroll
      for (int q = 0; q < SPT / 4; ++q)
        dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  }

  // Pass 2: the chunks in reverse, each recomputed from its checkpoint.
  float carry[SPT], dA[SPT], hs[SPT];  // a_{t+1} g_{t+1}; dA's sums; the next chunk's start
  float dD = 0.f;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    carry[j] = (p.dh != nullptr && dvalid && s0 + j < ST)
                   ? p.dh[((size_t)bi * DI + d) * ST + s0 + j] : 0.f;
    dA[j] = 0.f;
  }
  stage.template load<true>(p, NC - 1, bi, d0, tid);
  load_state<LPC>(hs, p, NC - 1, NC, bi, d, s0);
  T* dxc = static_cast<T*>(p.dxc);
  for (int k = NC - 1; k >= 0; --k) {
    const int t0 = k * TC;
    __syncthreads();
    stage.template store<true>(sm, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SPT; ++j) h[j] = hs[j];
    if (k > 0) {
      stage.template load<true>(p, k - 1, bi, d0, tid);
      load_state<LPC>(hs, p, k - 1, NC, bi, d, s0);
    }
    walk<LPC, true>(h, a2, sm, tid, ch, s0);

#pragma unroll 1
    for (int t = TC - 1; t >= 0; --t) {
      const float xv = sm[C::OFF_X + t * CPB + ch];
      const float dv = sm[C::OFF_DT + t * CPB + ch];
      const float gy = sm[C::OFF_DY + t * CPB + ch];
      const float dx = dv * xv;
      const float4* b4 = reinterpret_cast<const float4*>(sm + C::OFF_B + t * SP + s0);
      const float4* c4 = reinterpret_cast<const float4*>(sm + C::OFF_C + t * SP + s0);
      float vb[SPT], vc[SPT];  // this channel's db and dc terms
      float gb = 0.f, gua = 0.f;  // sum_s g b, sum_s g a h_{t-1} A log2(e)
#pragma unroll
      for (int q = 0; q < SPT / 4; ++q) {
        const float4 hq = hist[(t * (SPT / 4) + q) * THREADS + tid];
        const float4 bq = b4[q], cq = c4[q];
        const float hp[4] = {hq.x, hq.y, hq.z, hq.w};
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          const float al = hopper::exp2_approx(dv * a2[j]);
          const float u = al * hp[i];                   // a_t h_{t-1}
          const float ht = fmaf(al, hp[i], dx * bv[i]);  // h_t, as the forward has it
          const float g = fmaf(gy, cv[i], carry[j]);
          carry[j] = al * g;
          gb = fmaf(g, bv[i], gb);
          const float gu = g * u;
          gua = fmaf(gu, a2[j], gua);
          dA[j] = fmaf(gu, dv, dA[j]);
          vb[j] = g * dx;
          vc[j] = gy * ht;
        }
      }
#pragma unroll
      for (int o = LPC / 2; o > 0; o >>= 1) {
        gb += __shfl_xor_sync(FULL, gb, o);
        gua += __shfl_xor_sync(FULL, gua, o);
      }
      if (lane_c == 0 && dvalid && t0 + t < L) {
        const size_t gi = ((size_t)bi * L + t0 + t) * DI + d;
        dxc[gi] = from_float<T>(fmaf(dsk, gy, dv * gb));
        p.ddt[gi] = fmaf(gua, LN2, xv * gb);
      }
      dD = fmaf(gy, xv, dD);
      const int base_b = sum_channels<LPC>(vb, lane);
      const int base_c = sum_channels<LPC>(vc, lane);
      if (LPC > 1 || !(lane & 1)) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          red[((0 * WARPS + warp) * TC + t) * SP + s0 + base_b + i] = vb[i];
          red[((1 * WARPS + warp) * TC + t) * SP + s0 + base_c + i] = vc[i];
        }
      }
    }
    __syncthreads();
    // The chunk's db and dc terms summed over the block's warps, in order.
    for (int i = tid; i < TC * SP; i += THREADS) {
      const int t = i / SP, s = i % SP;
      if (s < ST && t0 + t < L) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          sb += red[(0 * WARPS + w) * TC * SP + i];
          sc += red[(1 * WARPS + w) * TC * SP + i];
        }
        const size_t o = (((size_t)blockIdx.x * p.B + bi) * L + t0 + t) * ST + s;
        p.dbp[o] = sb;
        p.dcp[o] = sc;
      }
    }
  }

  if (dvalid) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (s0 + j < ST) p.dAp[((size_t)bi * DI + d) * ST + s0 + j] = dA[j];
    if (lane_c == 0) p.dDp[(size_t)bi * DI + d] = dD;
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

int lpc_of(int ST) { return ST <= SPT ? 1 : ST <= 2 * SPT ? 2 : ST <= 4 * SPT ? 4 : 8; }

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Workspace layout, in bytes: checkpoints, db and dc partials, dA and dD
// partials, each 256-byte aligned.
struct Workspace {
  size_t ckpt, dbp, dcp, dAp, dDp, total;
  Workspace(int B, int L, int DI, int ST) {
    const int lpc = lpc_of(ST), SP = lpc * SPT, CPB = THREADS / lpc;
    const size_t NC = (L + TC - 1) / TC, G = (DI + CPB - 1) / CPB;
    ckpt = 0;
    dbp = ckpt + align256((size_t)B * (NC - 1) * DI * SP * 4);
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
  const int G = (p.DI + C::CPB - 1) / C::CPB;
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
    case 1: return launch<T, 1>(p, db, dc, dA, dD, s);
    case 2: return launch<T, 2>(p, db, dc, dA, dD, s);
    case 4: return launch<T, 4>(p, db, dc, dA, dD, s);
    default: return launch<T, 8>(p, db, dc, dA, dD, s);
  }
}

}  // namespace

// Bytes of scratch that repro_mamba_scan_bwd needs at these sizes.
extern "C" long long repro_mamba_scan_bwd_workspace(int B, int L, int DI, int ST) {
  return (long long)Workspace(B, L, DI, ST).total;
}

// xc, dt, dy (B, L, DI) contiguous; A (DI, ST), dskip (DI,) contiguous fp32;
// b and c (B, L, ST) with unit state stride and the given batch and time
// strides, in xc's dtype; dh (B, DI, ST) fp32 or null.  Outputs: dxc (B, L,
// DI) in xc's dtype, ddt (B, L, DI) fp32, dA (DI, ST) fp32, db and dc (B, L,
// ST) contiguous in xc's dtype, dD (DI,) fp32.  workspace: 256-byte aligned,
// repro_mamba_scan_bwd_workspace bytes.  dtype of xc, b and c: 0 float32,
// 1 float16, 2 bfloat16.  1 <= ST <= 128.  Two launches on the stream.
// Returns a cudaError_t (0 on success).
extern "C" int repro_mamba_scan_bwd(const void* xc, const void* dt, const void* A, const void* b,
                                    const void* c, const void* dskip, const void* dy,
                                    const void* dh, void* dxc, void* ddt, void* dA, void* db,
                                    void* dc, void* dD, void* workspace, int B, int L, int DI,
                                    int ST, long long b_sb, long long b_st, long long c_sb,
                                    long long c_st, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || DI < 1 || ST < 1 || ST > 8 * SPT)
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
  p.dxc = dxc;
  p.ddt = static_cast<float*>(ddt);
  p.ckpt = reinterpret_cast<float*>(w + ws.ckpt);
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
