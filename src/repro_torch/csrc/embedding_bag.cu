// DLRM embedding-bag lookup for Hopper.
//
// Replaces the Pallas TPU kernel `embedding_bag` / `_bag_kernel` in
// src/repro/kernels/embedding_bag.py.  It computes the same function:
//   out[b, t] = sum_j tables[t, idx[b, t, j]]
// over tables (T, R, E) in fp32, fp16 or bf16 and indices (B, T, NNZ) in
// int32 or int64, summing in fp32 (in j's order) and rounding once to the
// tables' dtype.  An id past the table is clamped to R - 1 and a negative
// one wrapped by R first (then clamped to 0), as the reference's XLA gather
// does, so no id reads outside its table and nothing is checked on the host.
//
// Design.  The TPU kernel prefetches the ids as scalars and lets each grid
// step DMA one (1, 1, E) row.  Here the lookup is a gather: a group of L
// lanes owns one (b, t) bag, and each lane loads 16 bytes of a row at a
// time (4 fp32 or 8 bf16/fp16 values), so one row of E = 128 fp32 (512
// bytes) is one coalesced request of a whole warp; with a smaller E, L
// shrinks and a warp serves 32 / L bags.  The lanes read U = 4 of the bag's
// ids ahead of the rows those ids select, and keep U row loads in flight
// before they add, so the dependent id -> row chain is paid once per U rows.
// A row of E not a multiple of the vector width ends in scalar loads;
// tables whose rows are not 16-byte aligned, or whose last dim is strided,
// take a scalar kernel (one value a lane).  Every offset into the tables is
// 64-bit: at T = 8, R = 1e7, E = 128 the last table starts 8.96e9 elements in.
//
// Bound on the H100 SXM: bytes.  A bag moves NNZ rows in and one row out and
// adds NNZ * E values, far below the fp32 rate, so the floor is the bytes of
// the rows the ids select (plus ids and output) at 3.35 TB/s: 0.16 ms for
// B = 4096, T = 8, NNZ = 32, E = 128 fp32 (537 MB of rows).  At the DLRM
// serving batch (B = 128, NNZ = 1: 0.5 MB) the launch dominates.

#include "embedding_bag.cuh"

namespace {

// The row an id selects: negative ids wrap by R, then all clamp to [0, R).
template <typename I>
__device__ __forceinline__ int64_t row_of(I raw, int64_t R) {
  int64_t id = (int64_t)raw;
  if (id < 0) id += R;
  return id < 0 ? 0 : (id >= R ? R - 1 : id);
}

template <typename I>
__device__ __forceinline__ void load_ids(int64_t (&ids)[U], const I* ip, int j0, int nnz,
                                         int64_t si_j, int64_t R) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u;
    ids[u] = j < nnz ? row_of<I>(ip[(int64_t)j * si_j], R) : 0;
  }
}

// VEC = Vec<T>::N: rows are 16-byte aligned with unit element stride, and a
// lane loads 16 bytes at a time (scalar loads for a ragged tail).  VEC = 1:
// any strides, one value a lane.
template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ tables, const I* __restrict__ idx,
                     T* __restrict__ out, int nT, int64_t n_bags, int64_t R, int E, int nnz,
                     int L, int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b,
                     int64_t si_t, int64_t si_j) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t bag = warp * (32 / L) + lane / L;
  if (bag >= n_bags) return;  // no barrier or shuffle below
  const int sub = lane & (L - 1);
  const int64_t b = bag / nT;
  const int t = (int)(bag - b * nT);
  const I* ip = idx + b * si_b + (int64_t)t * si_t;
  const T* tp = tables + (int64_t)t * st_t;
  T* op = out + bag * E;
  const int n_chunks = (E + VEC - 1) / VEC;

  for (int c = sub; c < n_chunks; c += L) {
    const int e0 = c * VEC;
    const int width = min(VEC, E - e0);
    const T* cp = tp + (int64_t)e0 * st_e;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    int64_t cur[U];
    load_ids<I>(cur, ip, 0, nnz, si_j, R);
    for (int j0 = 0; j0 < nnz; j0 += U) {
      int64_t nxt[U];
      load_ids<I>(nxt, ip, j0 + U, nnz, si_j, R);  // ids ahead of this group's rows
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)  // U row loads in flight before any add
        if (j0 + u < nnz) load_chunk<T, VEC>(v[u], cp + cur[u] * st_r, width, st_e);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < nnz) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];  // in j's order
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
    store_chunk<T, VEC>(op + e0, acc, width, E);
  }
}

template <typename T, typename I, int VEC>
cudaError_t launch_vec(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                       int E, int nnz, int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b,
                       int64_t si_t, int64_t si_j, cudaStream_t stream) {
  const int L = lanes_per_bag((E + VEC - 1) / VEC);
  const int64_t n_bags = (int64_t)B * nT;
  const int64_t bags_per_block = (int64_t)WARPS * (32 / L);
  const int64_t blocks = (n_bags + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, I, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(tables), static_cast<const I*>(idx), static_cast<T*>(out), nT,
      n_bags, R, E, nnz, L, st_t, st_r, st_e, si_b, si_t, si_j);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                   int E, int nnz, int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b,
                   int64_t si_t, int64_t si_j, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool aligned = reinterpret_cast<uintptr_t>(tables) % 16 == 0 && st_e == 1 &&
                       st_t % N == 0 && st_r % N == 0;
  if (aligned)
    return launch_vec<T, I, N>(tables, idx, out, B, nT, R, E, nnz, st_t, st_r, st_e, si_b,
                               si_t, si_j, stream);
  return launch_vec<T, I, 1>(tables, idx, out, B, nT, R, E, nnz, st_t, st_r, st_e, si_b, si_t,
                             si_j, stream);
}

template <typename T>
cudaError_t launch_ids(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                       int E, int nnz, int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b,
                       int64_t si_t, int64_t si_j, int idx64, cudaStream_t stream) {
  if (idx64)
    return launch<T, int64_t>(tables, idx, out, B, nT, R, E, nnz, st_t, st_r, st_e, si_b, si_t,
                              si_j, stream);
  return launch<T, int32_t>(tables, idx, out, B, nT, R, E, nnz, st_t, st_r, st_e, si_b, si_t,
                            si_j, stream);
}

}  // namespace

// tables: (T, R, E) device array of one dtype (0 float32, 1 float16,
// 2 bfloat16) with element strides st_t, st_r, st_e; idx: (B, T, NNZ) int32
// (idx64 = 0) or int64 (idx64 = 1) with element strides si_b, si_t, si_j;
// out: contiguous (B, T, E) of the tables' dtype.  Returns a cudaError_t
// (0 on success).
extern "C" int repro_embedding_bag(const void* tables, const void* idx, void* out, int B, int T,
                                   long long R, int E, int nnz, long long st_t, long long st_r,
                                   long long st_e, long long si_b, long long si_t,
                                   long long si_j, int dtype, int idx64, void* stream) {
  if (B < 1 || T < 1 || R < 1 || E < 1 || nnz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_ids<float>(tables, idx, out, B, T, R, E, nnz, st_t, st_r, st_e, si_b,
                                    si_t, si_j, idx64, s);
    case 1:
      return (int)launch_ids<__half>(tables, idx, out, B, T, R, E, nnz, st_t, st_r, st_e, si_b,
                                     si_t, si_j, idx64, s);
    case 2:
      return (int)launch_ids<__nv_bfloat16>(tables, idx, out, B, T, R, E, nnz, st_t, st_r, st_e,
                                            si_b, si_t, si_j, idx64, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
