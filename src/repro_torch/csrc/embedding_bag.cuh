// What the embedding bag's forward (embedding_bag.cu) and backward
// (embedding_bag_bwd.cu) share: the block shape, fp32 conversions of the
// tables' types, and one lane's 16-byte (or scalar) load of a chunk of a
// row, kept as raw bits until it is added, and the store of its sums.  A
// group of L lanes owns one row of E values and each lane takes every L-th
// chunk of VEC values, so a row of E = 128 fp32 (512 bytes) is one
// coalesced request of a whole warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
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

// One lane's chunk of a row as raw bits: the VEC values of T in the 16
// bytes of one vector load (VEC > 1), or one value (VEC = 1).  Four
// registers a chunk whatever T is, where fp32 values of bf16 would take 8.
template <int VEC> struct Raw { uint32_t w[VEC > 1 ? 4 : 1]; };

template <typename T> __device__ __forceinline__ uint32_t load_bits(const T* p) {
  if constexpr (sizeof(T) == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// `width` (<= VEC) values from rp: one 16-byte load, else scalar loads
// packed as a 16-byte load would hold them (zero past `width`).
template <typename T, int VEC>
__device__ __forceinline__ void load_raw(Raw<VEC>& r, const T* rp, int width, int64_t st_e) {
  if constexpr (VEC > 1) {
    if (width == VEC) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(rp));
      r.w[0] = v.x;
      r.w[1] = v.y;
      r.w[2] = v.z;
      r.w[3] = v.w;
      return;
    }
    constexpr int PER = VEC / 4;  // T values per 32-bit word
#pragma unroll
    for (int q = 0; q < 4; ++q) r.w[q] = 0u;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < width)
        r.w[i / PER] |= load_bits<T>(rp + (int64_t)i * st_e) << ((32 / PER) * (i % PER));
  } else {
    r.w[0] = load_bits<T>(rp);
  }
}

template <typename T> __device__ __forceinline__ float one_float(uint32_t w);
template <> __device__ __forceinline__ float one_float<float>(uint32_t w) {
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float one_float<__half>(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)w));
}
template <> __device__ __forceinline__ float one_float<__nv_bfloat16>(uint32_t w) {
  return __uint_as_float(w << 16);
}

// acc[i] += value i of the chunk, in fp32.
template <typename T, int VEC>
__device__ __forceinline__ void add_raw(float (&acc)[VEC], const Raw<VEC>& r) {
  if constexpr (VEC > 1) {
    constexpr int PER = VEC / 4;
    float f[VEC];
#pragma unroll
    for (int q = 0; q < 4; ++q) unpack<T>(r.w[q], &f[q * PER]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += f[i];
  } else {
    acc[0] += one_float<T>(r.w[0]);
  }
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

// The lanes of this lane's group of L, as a shuffle/ballot mask.
__device__ __forceinline__ unsigned group_mask(int gbase, int L) {
  return L == 32 ? FULL : ((1u << L) - 1u) << gbase;
}

}  // namespace
