// What the embedding bag's forward (embedding_bag.cu) and backward
// (embedding_bag_bwd.cu) share: the block shape, fp32 conversions of the
// tables' types, and one lane's 16-byte (or scalar) load and store of a
// chunk of a row.  A group of L lanes owns one row of E values and each
// lane takes every L-th chunk of VEC values, so a row of E = 128 fp32
// (512 bytes) is one coalesced request of a whole warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;  // ids (and rows) in flight per lane

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

// The values of T in the 16 bytes of one vector load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Splits one 32-bit word of a 16-byte load into its T values, as floats.
template <typename T> __device__ __forceinline__ void unpack(uint32_t w, float* f);
template <> __device__ __forceinline__ void unpack<float>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w);
}
template <> __device__ __forceinline__ void unpack<__half>(uint32_t w, float* f) {
  f[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  f[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T> __device__ __forceinline__ uint32_t pack(const float* f);
template <> __device__ __forceinline__ uint32_t pack<float>(const float* f) {
  return __float_as_uint(f[0]);
}
template <> __device__ __forceinline__ uint32_t pack<__half>(const float* f) {
  return (uint32_t)__half_as_ushort(__float2half_rn(f[0])) |
         ((uint32_t)__half_as_ushort(__float2half_rn(f[1])) << 16);
}
template <> __device__ __forceinline__ uint32_t pack<__nv_bfloat16>(const float* f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[0])) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[1])) << 16);
}

// One lane's chunk of a row: `width` (<= VEC) values from rp, as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(float (&v)[VEC], const T* rp, int width,
                                           int64_t st_e) {
  if constexpr (VEC > 1) {
    if (width == VEC) {  // one 16-byte load
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(rp));
      constexpr int PER = VEC / 4;  // T values per 32-bit word
      unpack<T>(w.x, &v[0]);
      unpack<T>(w.y, &v[PER]);
      unpack<T>(w.z, &v[2 * PER]);
      unpack<T>(w.w, &v[3 * PER]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = i < width ? to_float<T>(rp[(int64_t)i * st_e]) : 0.f;
}

// Rounds a chunk's sums to T and stores them; one 16-byte store where the
// output row is aligned (E a multiple of VEC).
template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* op, const float (&acc)[VEC], int width, int E) {
  if constexpr (VEC > 1) {
    if (width == VEC && E % VEC == 0) {
      constexpr int PER = VEC / 4;
      uint4 w;
      w.x = pack<T>(&acc[0]);
      w.y = pack<T>(&acc[PER]);
      w.z = pack<T>(&acc[2 * PER]);
      w.w = pack<T>(&acc[3 * PER]);
      *reinterpret_cast<uint4*>(op) = w;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < width) op[i] = from_float<T>(acc[i]);
}

// The lanes that share one row: enough for one chunk each, at most a warp.
int lanes_per_bag(int n_chunks) {
  int L = 1;
  while (L < n_chunks && L < 32) L *= 2;
  return L;
}

}  // namespace
