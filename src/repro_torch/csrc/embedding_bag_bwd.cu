// DLRM embedding-bag backward for Hopper: the gradient of the lookup
// `out[b, t] = sum_j tables[t, idx[b, t, j]]` with respect to the tables.
//
// Replaces no TPU kernel: the JAX package takes this gradient with
// `jax.grad` of its gather (src/repro/models/dlrm.py:78), a scatter-add.
// It computes the same function:
//   dtables[t, r] = sum over (b, j) with id(b, t, j) = r of dout[b, t]
// as a dense (T, R, E) array in dout's dtype (fp32, fp16 or bf16), summed in
// fp32 in (b, j) order and rounded once.  Ids follow the reference's
// gather: a negative id wraps once by R, and an id still outside [0, R)
// contributes no gradient (the forward reads a clamped row for it, but the
// scatter drops it).
//
// Design: deterministic, no float atomics (ROADMAP C5).  The wrapper
// (kernels/embedding_bag.py) builds an int64 key t * R + id for every entry
// (T * R for a dropped one, which sorts past every row) and orders the keys
// with a stable sort, so entries of one row form a run in (b, j) order; it
// hands the sorted keys, each entry's flat position (b * T + t) * NNZ + j,
// and a zeroed dtables to this kernel.  A group of L lanes looks at one
// sorted entry; only the group at the first entry of a run goes on.  It
// walks the run, U entries at a time (their positions, then their dout rows
// in flight, then the adds in order), summing the dout rows chunk by chunk
// with the forward's 16-byte loads (embedding_bag.cuh), and writes the row
// of dtables once.  So every row is written by one group, in one order, and
// two launches on the same inputs give the same bits.  Rows no id selects
// keep the wrapper's zeros.  Every offset into dtables and dout is 64-bit:
// at T = 2, R = 1e7, E = 128, table 1's last rows lie 2.56e9 elements in.
//
// Bound on the H100 SXM: bytes.  Each entry reads one dout row (B * T * NNZ
// rows, fewer distinct), its key and position, and each distinct row is
// written once; at the DLRM training batch (B = 128, T = 2, NNZ = 1, E =
// 128 fp32) that is 0.26 MB, so the launch dominates.  The zero fill of the
// dense dtables (10.24 GB at T = 2, R = 1e7) is the wrapper's, not this
// kernel's, and is timed apart.

#include "embedding_bag.cuh"

namespace {

// The dout row of the entry at flat position pos = (b * T + t) * nnz + j.
template <typename T>
__device__ __forceinline__ const T* dout_row(const T* dout, int64_t pos, int nnz, int nT,
                                             int64_t sd_b, int64_t sd_t) {
  const int64_t bag = pos / nnz;
  const int64_t b = bag / nT;
  return dout + b * sd_b + (bag - b * nT) * sd_t;
}

// VEC = Vec<T>::N: dout rows are 16-byte aligned with unit element stride,
// and a lane loads 16 bytes at a time (scalar loads for a ragged tail).
// VEC = 1: any dout strides, one value a lane.  dtables is contiguous.  The
// launch bound asks for one resident block at least: with no minimum,
// ptxas held the bf16 kernel to 80 registers and spilled 4 bytes (84
// without a spill).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
embedding_bag_bwd_kernel(const T* __restrict__ dout, const int64_t* __restrict__ keys,
                         const int64_t* __restrict__ pos, T* __restrict__ dtables, int64_t n,
                         int64_t n_rows, int nT, int nnz, int E, int L, int64_t sd_b,
                         int64_t sd_t, int64_t sd_e) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t first = warp * (32 / L) + lane / L;  // the sorted entry this group looks at
  if (first >= n) return;  // no barrier or shuffle below
  const int64_t key = keys[first];
  // A dropped id (key n_rows), or not the first entry of its run.
  if (key >= n_rows || (first > 0 && keys[first - 1] == key)) return;
  const int sub = lane & (L - 1);
  T* op = dtables + key * (int64_t)E;
  const int n_chunks = (E + VEC - 1) / VEC;

  for (int c = sub; c < n_chunks; c += L) {
    const int e0 = c * VEC;
    const int width = min(VEC, E - e0);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    // The run's entries are contiguous in the sorted keys, so `in` below is
    // true for a prefix of the U entries; the walk ends at the first false.
    bool more = true;
    for (int64_t k0 = first; more; k0 += U) {
      bool in[U];
      int64_t p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = k0 + u;
        in[u] = k < n && keys[k] == key;
        p[u] = in[u] ? pos[k] : 0;
      }
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)  // U row loads in flight before any add
        if (in[u])
          load_chunk<T, VEC>(v[u], dout_row<T>(dout, p[u], nnz, nT, sd_b, sd_t) + e0 * sd_e,
                             width, sd_e);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (in[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];  // in sorted, (b, j), order
        }
      }
      more = in[U - 1];
    }
    store_chunk<T, VEC>(op + e0, acc, width, E);
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* dout, const int64_t* keys, const int64_t* pos, void* dtables,
                       int64_t n, int nT, int64_t R, int E, int nnz, int64_t sd_b, int64_t sd_t,
                       int64_t sd_e, cudaStream_t stream) {
  const int L = lanes_per_bag((E + VEC - 1) / VEC);
  const int64_t per_block = (int64_t)WARPS * (32 / L);
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  embedding_bag_bwd_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dout), keys, pos, static_cast<T*>(dtables), n, (int64_t)nT * R, nT,
      nnz, E, L, sd_b, sd_t, sd_e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* dout, const int64_t* keys, const int64_t* pos, void* dtables,
                   int64_t n, int nT, int64_t R, int E, int nnz, int64_t sd_b, int64_t sd_t,
                   int64_t sd_e, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool aligned = reinterpret_cast<uintptr_t>(dout) % 16 == 0 && sd_e == 1 &&
                       sd_b % N == 0 && sd_t % N == 0;
  if (aligned)
    return launch_vec<T, N>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd_b, sd_t, sd_e,
                            stream);
  return launch_vec<T, 1>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd_b, sd_t, sd_e, stream);
}

}  // namespace

// dout: (B, T, E) device array of one dtype (0 float32, 1 float16,
// 2 bfloat16) with element strides sd_b, sd_t, sd_e; keys: n = B * T * nnz
// sorted int64 keys t * R + id (T * R for a dropped id); pos: each sorted
// entry's flat position (b * T + t) * nnz + j, int64; dtables: contiguous
// (T, R, E) of dout's dtype, zeroed.  Writes the rows the keys select.
// Returns a cudaError_t (0 on success).
extern "C" int repro_embedding_bag_bwd(const void* dout, const void* keys, const void* pos,
                                       void* dtables, long long n, int T, long long R, int E,
                                       int nnz, long long sd_b, long long sd_t, long long sd_e,
                                       int dtype, void* stream) {
  if (n < 1 || T < 1 || R < 1 || E < 1 || nnz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(keys);
  const int64_t* p = static_cast<const int64_t*>(pos);
  switch (dtype) {
    case 0:
      return (int)launch<float>(dout, k, p, dtables, n, T, R, E, nnz, sd_b, sd_t, sd_e, s);
    case 1:
      return (int)launch<__half>(dout, k, p, dtables, n, T, R, E, nnz, sd_b, sd_t, sd_e, s);
    case 2:
      return (int)launch<__nv_bfloat16>(dout, k, p, dtables, n, T, R, E, nnz, sd_b, sd_t, sd_e,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
