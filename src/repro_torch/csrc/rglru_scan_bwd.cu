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
// Design.  The forward gives each (batch, channel) lane one thread that
// walks all L steps; at a training batch of one (B = 1, D = 4096) that is
// 4096 threads, one warp an SM, bound by latency.  Here time is cut into
// chunks of CH = 32 steps and the walk back is split into three launches,
// all in a fixed order and without atomics, so two launches give the same
// bits:
//   1. chunk: one thread a (lane, chunk) walks its chunk back with a zero
//      carry-in (dh_final in the last chunk) and writes what leaves the
//      chunk, u_c = a_start g~_start, and the product of its a's, A_c;
//   2. carry: one thread a lane walks the chunks back in order, x_{C-1} = 0
//      and x_{c-1} = u_c + A_c x_c, the true a_{end} g_{end} that enters
//      chunk c (written over u_c);
//   3. fix-up: one thread a (lane, chunk) walks its chunk back again from
//      x_c and writes db = g and da = g h_{t-1}.
// The recurrence is linear, so the result is the sequential walk's up to
// fp32 rounding.  Each thread of 1 and 3 loads its whole chunk (32 steps of
// a and dh, and of h in 3) before its dependent FMAs, so it keeps 64 to 97
// loads in flight; neighbouring threads own neighbouring channels, so every
// load and store of a step is coalesced along D.  Steps past L and channels
// past D are masked.
//
// Bound on the H100 SXM at recurrentgemma-9b's training shape (B = 1,
// L = 4096, D = 4096, fp32): a, h_all, dh_all read once and da, db written
// once, 5 x 67.1 MB = 335.5 MB, 0.100 ms at 3.35 TB/s; its FMAs are nothing
// beside that.  This design reads a and dh twice (passes 1 and 3), 470 MB,
// so at best 0.140 ms; the chunk scratch (u, A: 2 x B x L/32 x D fp32,
// 4.2 MB there) stays in L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CH = 32;  // time steps a chunk

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Pass 1: the chunk's walk back from a zero carry-in (dh_final in the last
// chunk): u = a_start g~_start and A = the product of the chunk's a's.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lru_bwd_chunk_kernel(const T* __restrict__ a, const float* __restrict__ dh,
                     const float* __restrict__ dhf, float* __restrict__ u,
                     float* __restrict__ prod, int L, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (d >= D) return;  // no barrier or shuffle below
  const int C = gridDim.y;
  const int t0 = c * CH;
  const size_t base = ((size_t)bi * L + t0) * D + d;
  float ra[CH], rd[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const bool ok = t0 + i < L;
    ra[i] = ok ? to_float<T>(a[base + (size_t)i * D]) : 1.f;
    rd[i] = ok ? dh[base + (size_t)i * D] : 0.f;
  }
  float w = (c == C - 1 && dhf != nullptr) ? dhf[(size_t)bi * D + d] : 0.f;
  float p = 1.f;
#pragma unroll
  for (int i = CH - 1; i >= 0; --i) {
    if (t0 + i < L) {
      const float g = rd[i] + w;
      w = ra[i] * g;
      p *= ra[i];
    }
  }
  const size_t o = ((size_t)bi * C + c) * D + d;
  u[o] = w;
  prod[o] = p;
}

// Pass 2: the carries across chunks, in order from the last: x_{C-1} = 0,
// x_{c-1} = u_c + A_c x_c; x_c overwrites u_c.
__global__ void __launch_bounds__(THREADS)
lru_bwd_carry_kernel(float* __restrict__ u, const float* __restrict__ prod, int C, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  float* up = u + (size_t)bi * C * D + d;
  const float* pp = prod + (size_t)bi * C * D + d;
  float x = 0.f;
  for (int c = C - 1; c >= 1; --c) {
    const float uc = up[(size_t)c * D], pc = pp[(size_t)c * D];
    up[(size_t)c * D] = x;
    x = fmaf(pc, x, uc);
  }
  up[0] = x;
}

// Pass 3: the chunk's walk back from its true carry-in, writing the
// gradients.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lru_bwd_fixup_kernel(const T* __restrict__ a, const float* __restrict__ hall,
                     const float* __restrict__ dh, const float* __restrict__ dhf,
                     const float* __restrict__ x, float* __restrict__ da,
                     float* __restrict__ db, int L, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (d >= D) return;
  const int C = gridDim.y;
  const int t0 = c * CH;
  const size_t base = ((size_t)bi * L + t0) * D + d;
  float ra[CH], rd[CH], rh[CH];  // rh[i] = h_{t0 + i - 1}
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const bool ok = t0 + i < L;
    ra[i] = ok ? to_float<T>(a[base + (size_t)i * D]) : 0.f;
    rd[i] = ok ? dh[base + (size_t)i * D] : 0.f;
    rh[i] = ok && t0 + i > 0 ? hall[base + (size_t)(i - 1) * D] : 0.f;
  }
  float w;
  if (c == C - 1)
    w = dhf != nullptr ? dhf[(size_t)bi * D + d] : 0.f;
  else
    w = x[((size_t)bi * C + c) * D + d];
#pragma unroll
  for (int i = CH - 1; i >= 0; --i) {
    if (t0 + i < L) {
      const float g = rd[i] + w;
      db[base + (size_t)i * D] = g;
      da[base + (size_t)i * D] = g * rh[i];
      w = ra[i] * g;
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const float* hall, const float* dh, const float* dhf,
                   float* da, float* db, float* work, int B, int L, int D, cudaStream_t stream) {
  const int C = (L + CH - 1) / CH;
  const int dblocks = (D + THREADS - 1) / THREADS;
  float* u = work;
  float* prod = work + (size_t)B * C * D;
  const T* at = static_cast<const T*>(a);
  lru_bwd_chunk_kernel<T><<<dim3(dblocks, C, B), THREADS, 0, stream>>>(at, dh, dhf, u, prod, L,
                                                                        D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lru_bwd_carry_kernel<<<dim3(dblocks, B), THREADS, 0, stream>>>(u, prod, C, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lru_bwd_fixup_kernel<T><<<dim3(dblocks, C, B), THREADS, 0, stream>>>(at, hall, dh, dhf, u, da,
                                                                        db, L, D);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the backward needs: u and A, 2 x B x ceil(L / CH) x D fp32.
extern "C" long long repro_rglru_scan_bwd_workspace(int B, int L, int D) {
  return 2LL * B * ((L + CH - 1) / CH) * D * (long long)sizeof(float);
}

// a: contiguous (B, L, D) of dtype (0 float32, 1 float16, 2 bfloat16);
// hall, dh: contiguous (B, L, D) fp32; dhf: (B, D) fp32 or null (0); da, db:
// (B, L, D) fp32 outputs; work: repro_rglru_scan_bwd_workspace bytes.
// Launches the three passes on `stream` and returns a cudaError_t (0 on
// success).
extern "C" int repro_rglru_scan_bwd(const void* a, const float* hall, const float* dh,
                                    const float* dhf, float* da, float* db, float* work, int B,
                                    int L, int D, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || (L + CH - 1) / CH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(a, hall, dh, dhf, da, db, work, B, L, D, s);
    case 1: return (int)launch<__half>(a, hall, dh, dhf, da, db, work, B, L, D, s);
    case 2: return (int)launch<__nv_bfloat16>(a, hall, dh, dhf, da, db, work, B, L, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
