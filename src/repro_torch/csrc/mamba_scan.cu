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
// Design.  The TPU kernel walks time chunks as a sequential grid axis and
// carries h in VMEM.  Here the sequential axis is a loop inside each thread,
// with its slice of h in registers, and decay and drive are computed on the
// fly: (B, L, DI, ST) is never stored.  A thread owns SPT = 8 states of one
// (batch, channel) lane; LPC = ST / 8 rounded up to a power of two threads
// share a channel (2 at ST = 16), and y's sum over the states is finished by
// warp shuffles among them.  At falcon-mamba-7b's prefill (B = 4, DI = 8192,
// ST = 16) that is 65,536 threads in 512 blocks of 128.  Each block covers
// one batch row and CPB = 128 / LPC channels and walks time in chunks of
// TC = 16 steps: the block first stages the chunk's x, dt, b and c in shared
// memory as fp32 (coalesced loads that do not wait on h), then every thread
// runs the chunk's recurrence from there.  b and c may be strided views (the
// slices of the x_proj output); only their state stride must be 1.  States
// past ST, channels past DI and steps past L are masked, so the wrapper pads
// nothing.  `expf` (not `__expf`) keeps fp32 within 1e-4 of the plain version.
//
// Bound on the H100 SXM at falcon-mamba-7b's prefill: the bytes the function
// must move are xc (bf16) 65.5 MB, dt 131 MB, y 131 MB, h 2.1 MB, b and c
// 0.26 MB: 330 MB, 0.099 ms at 3.35 TB/s.  Its B*L*DI*ST = 524 M exps at the
// SFU's 16 per clock per SM take 0.125 ms, so the scan is bound by
// operations.  This first version spends about 10 instructions per state and
// step, so it cannot reach that bound; what it does about the bound is to do
// one exp per (state, step) and move each input byte once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SPT = 8;  // states per thread
constexpr int TC = 16;  // time steps staged per chunk

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int LPC>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ dskip,
                  float* __restrict__ y, float* __restrict__ hout, int L, int DI, int ST,
                  long long b_sb, long long b_st, long long c_sb, long long c_st) {
  constexpr int CPB = THREADS / LPC;  // channels per block
  constexpr int SP = LPC * SPT;       // states per channel, padded
  __shared__ __align__(16) float sx[TC * CPB];
  __shared__ __align__(16) float sdt[TC * CPB];
  __shared__ __align__(16) float sb[TC * SP];
  __shared__ __align__(16) float sc[TC * SP];

  const int tid = threadIdx.x;
  const int lane_c = tid % LPC;  // which group of SPT states
  const int ch = tid / LPC;      // channel within the block
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + ch;
  const bool d_ok = d < DI;
  const int s0 = lane_c * SPT;

  float a[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    a[j] = (d_ok && s0 + j < ST) ? A[(size_t)d * ST + s0 + j] : 0.f;
    h[j] = 0.f;
  }
  const float dsk = d_ok ? dskip[d] : 0.f;

  const size_t row0 = (size_t)bi * L;  // (batch, t = 0) row of xc, dt and y
  const T* bp = bm + (size_t)bi * b_sb;
  const T* cp = cm + (size_t)bi * c_sb;

  for (int t0 = 0; t0 < L; t0 += TC) {
    const int tc = min(TC, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < TC * CPB; e += THREADS) {
      const int t = e / CPB, c = e % CPB;
      float xv = 0.f, dv = 0.f;
      if (t < tc && d0 + c < DI) {
        const size_t off = (row0 + t0 + t) * DI + d0 + c;
        xv = to_float<T>(xc[off]);
        dv = dt[off];
      }
      sx[e] = xv;
      sdt[e] = dv;
    }
    for (int e = tid; e < TC * SP; e += THREADS) {
      const int t = e / SP, s = e % SP;
      float bv = 0.f, cv = 0.f;
      if (t < tc && s < ST) {
        bv = to_float<T>(bp[(size_t)(t0 + t) * b_st + s]);
        cv = to_float<T>(cp[(size_t)(t0 + t) * c_st + s]);
      }
      sb[e] = bv;
      sc[e] = cv;
    }
    __syncthreads();

    for (int t = 0; t < tc; ++t) {
      const float xv = sx[t * CPB + ch];
      const float dv = sdt[t * CPB + ch];
      const float dx = dv * xv;
      float bv[SPT], cv[SPT];
#pragma unroll
      for (int j = 0; j < SPT; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(sb + t * SP + s0 + j);
        const float4 c4 = *reinterpret_cast<const float4*>(sc + t * SP + s0 + j);
        bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
        cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
      }
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = expf(dv * a[j]) * h[j] + dx * bv[j];
        p = fmaf(h[j], cv[j], p);
      }
#pragma unroll
      for (int off = LPC / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane_c == 0 && d_ok) y[(row0 + t0 + t) * DI + d] = p + dsk * xv;
    }
  }

  if (d_ok) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (s0 + j < ST) hout[((size_t)bi * DI + d) * ST + s0 + j] = h[j];
  }
}

template <typename T, int LPC>
cudaError_t launch(const void* xc, const void* dt, const void* A, const void* b, const void* c,
                   const void* dskip, void* y, void* h, int B, int L, int DI, int ST,
                   long long b_sb, long long b_st, long long c_sb, long long c_st,
                   cudaStream_t stream) {
  constexpr int CPB = THREADS / LPC;
  const dim3 grid((DI + CPB - 1) / CPB, B);
  mamba_scan_kernel<T, LPC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(xc), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(dskip),
      static_cast<float*>(y), static_cast<float*>(h), L, DI, ST, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_st(const void* xc, const void* dt, const void* A, const void* b,
                      const void* c, const void* dskip, void* y, void* h, int B, int L, int DI,
                      int ST, long long b_sb, long long b_st, long long c_sb, long long c_st,
                      cudaStream_t s) {
#define REPRO_MAMBA_LAUNCH(LPC)                                                              \
  return launch<T, LPC>(xc, dt, A, b, c, dskip, y, h, B, L, DI, ST, b_sb, b_st, c_sb, c_st, s)
  if (ST <= SPT) REPRO_MAMBA_LAUNCH(1);
  if (ST <= 2 * SPT) REPRO_MAMBA_LAUNCH(2);
  if (ST <= 4 * SPT) REPRO_MAMBA_LAUNCH(4);
  if (ST <= 8 * SPT) REPRO_MAMBA_LAUNCH(8);
  if (ST <= 16 * SPT) REPRO_MAMBA_LAUNCH(16);
#undef REPRO_MAMBA_LAUNCH
  return cudaErrorInvalidValue;
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
  if (B < 1 || B > 65535 || L < 1 || DI < 1 || ST < 1 || ST > 16 * SPT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_st<float>(xc, dt, A, b, c, dskip, y, h, B, L, DI, ST, b_sb, b_st,
                                   c_sb, c_st, s);
    case 1:
      return (int)launch_st<__half>(xc, dt, A, b, c, dskip, y, h, B, L, DI, ST, b_sb, b_st,
                                    c_sb, c_st, s);
    case 2:
      return (int)launch_st<__nv_bfloat16>(xc, dt, A, b, c, dskip, y, h, B, L, DI, ST, b_sb,
                                           b_st, c_sb, c_st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
