// RG-LRU linear recurrence (Griffin) for Hopper.
//
// Replaces the Pallas TPU kernel `rglru_scan` / `_lru_kernel` in
// src/repro/kernels/rglru_scan.py.  It computes the same function, from
// h = 0:  h_t = a_t (.) h_{t-1} + b_t  along time, elementwise over the
// channels; a and b (B, L, D) in fp32, fp16 or bf16, arithmetic in fp32,
// h_all (B, L, D) and h_final (B, D) in fp32.
//
// Design.  The TPU kernel walks time chunks as a sequential grid axis and
// carries h in VMEM.  Here one thread owns one (batch, channel) lane and
// loops over time with h in a register: at recurrentgemma-9b's prefill
// (B = 4, L = 2048, D = 4096) that is 16,384 threads, each with 2048
// dependent FMAs.  Neighbouring threads own neighbouring channels, so every
// load and store of a time step is coalesced along D.  Loads do not wait on
// h: the thread reads the next U = 16 steps of a and b into registers while
// it runs the current 16, so each thread keeps 32 loads in flight behind its
// dependency chain.  Steps past L and channels past D are masked.
//
// Bound on the H100 SXM at recurrentgemma-9b's prefill: a and b (fp32) read
// once and h_all written once, 3 x 134 MB = 403 MB, 0.120 ms at 3.35 TB/s;
// its 33.5 M FMAs are nothing beside that, so the scan is bound by bytes.
// With only about four warps on each SM, this first version is bound by
// memory latency rather than by the rate; a chunked two-pass scan that
// spreads time over more threads is the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // time steps loaded ahead

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void load_steps(float (&ra)[U], float (&rb)[U], const T* ap,
                                           const T* bp, int t0, int L, int D) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const bool ok = t0 + i < L;
    ra[i] = ok ? to_float<T>(ap[(size_t)(t0 + i) * D]) : 0.f;
    rb[i] = ok ? to_float<T>(bp[(size_t)(t0 + i) * D]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ hall,
                  float* __restrict__ hfin, int L, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;  // no barrier or shuffle below: threads past D may leave
  const size_t base = (size_t)bi * L * D + d;
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = hall + base;

  float ra[U], rb[U], na[U], nb[U];
  load_steps<T>(ra, rb, ap, bp, 0, L, D);
  float h = 0.f;
  for (int t0 = 0; t0 < L; t0 += U) {
    load_steps<T>(na, nb, ap, bp, t0 + U, L, D);  // all masked past the end
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (t0 + i < L) {
        h = fmaf(ra[i], h, rb[i]);
        hp[(size_t)(t0 + i) * D] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ra[i] = na[i];
      rb[i] = nb[i];
    }
  }
  hfin[(size_t)bi * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* hall, void* hfin, int B, int L, int D,
                   cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(hall),
      static_cast<float*>(hfin), L, D);
  return cudaGetLastError();
}

}  // namespace

// a, b: contiguous (B, L, D) device arrays of one dtype (0 float32,
// 1 float16, 2 bfloat16); hall (B, L, D) and hfin (B, D) fp32 outputs.
// Returns a cudaError_t (0 on success).
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
