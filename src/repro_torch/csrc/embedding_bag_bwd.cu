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
// scatter drops it).  No float atomics, so the bits repeat: every row of dtables is
// written once, by one group of lanes, in one order, so two launches on the
// same inputs give the same bits.  The wrapper (kernels/embedding_bag.py)
// zeroes dtables; rows no id selects keep those zeros.  Every offset into
// dtables and dout is 64-bit: at T = 2, R = 1e7, E = 128, table 1's last
// rows lie 2.56e9 elements in.
//
// A group of L lanes owns one row of E values; each lane takes every L-th
// 16-byte chunk (embedding_bag.cuh) and adds, in fp32 and in order, the
// chunks of the dout rows that go into its row.  Two tilings, which the
// wrapper picks by n = B * T * nnz alone (`bag_bwd_tiling`):
//
// `small` (n <= N_SMALL): one launch, no sort, no key or position array.
//   Block (x, t) stages the m = B * nnz keys of table t in shared memory, in
//   (b, j) order (the wrapped id, or -1 for a dropped one), and for each of
//   2^hbits hash slots the first and last entry whose key lands there
//   (integer atomicMin / atomicMax: the same whatever the order).  Each
//   group takes an entry i; it owns the entry's row when no entry in
//   [first, i) of its slot has the same key (none to scan when first = i,
//   the common case), and then adds its own row and those of the entries
//   in (i, last] with its key, found by a ballot over L staged keys at a
//   time, in (b, j) order: the order of the sorted walk, hence the same
//   bits.  A row's address needs no id, so the group's first row is in
//   flight while the ids are staged, and the next entry's row while this
//   one is summed.  What bounds the tiling: a block holds a whole table's
//   keys (8 bytes each) and at least one slot a key (8 bytes), 16 bytes a
//   key of the 227 KB a block may use, so 14.5 K keys; N_SMALL = 8192 is the
//   largest power of two under that (8192 keys and 16384 slots: 192 KB).
//   Each block of table t stages all m keys: the launch reads m ids a block
//   from L2 and does 2 shared atomics for each, so blocks are capped at
//   about 4 an SM, a group taking several entries past that.  The training
//   batch (B = 128, T = 2, nnz = 1: m = 128) is 32 blocks of 3 KB;
//   B = 128 over the paper's 64 tables 576 blocks.
//
// `sorted` (n > N_SMALL, the hot multi-hot case): the wrapper computes the
//   key t * R + id of every entry (T * R for a dropped one, which sorts past
//   every row) with embedding_bag_keys_kernel, in int32 where T * R fits
//   (the radix sort then makes half the passes), and orders the keys with a
//   stable sort, so entries of one row form a run in (b, j) order; it hands
//   the sorted keys, each entry's flat position (b * T + t) * nnz + j, and a
//   zeroed dtables to embedding_bag_bwd_sorted_kernel.  A warp takes 32
//   consecutive sorted entries: one coalesced load of their keys and
//   positions, each lane turning its position into a row offset (the only
//   divisions), and a ballot for the run starts.  With 16-byte chunks it
//   then has every row of the runs that start in the chunk in flight at
//   once, by cp.async into its ring in shared memory (no register holds a
//   row in flight), and its groups sum the runs from there (group g the
//   starts g, g + 32 / L, ...).  The run that reaches the chunk's end goes
//   on past it, L entries a coalesced step, each step's keys loaded while
//   the rows before it are.  So the dependent key -> position -> row chain
//   is paid once a chunk, not once an entry or a run.  On hot ids (runs of
//   about 32) the kernel reads each entry's dout row from L2: 134 MB at B =
//   4096, 32 ids a bag, E = 128 fp32, which bounds it, not the 9 MB it
//   must move from memory.
//
// Bound on the H100 SXM: bytes.  Each entry reads its dout row once (B * T
// rows, fewer distinct), and each distinct row of dtables is written once;
// at the DLRM training batch (B = 128, T = 2, NNZ = 1, E = 128 fp32) that
// is 0.26 MB, so the launch dominates.  The zero fill of the dense dtables
// (10.24 GB at T = 2, R = 1e7) is the wrapper's, not this kernel's.

#include <limits.h>

#include "embedding_bag.cuh"

namespace {

constexpr int N_SMALL = 8192;  // entries up to which the `small` tiling serves
constexpr int ROWS = 8;  // dout chunks a lane has in flight in registers
// The sorted kernel's block: 4 warps, each with a 16 KB ring at E = 128 fp32
// (32 rows x 512 bytes), so 3 blocks fit an SM's shared memory.
constexpr int SORTED_WARPS = 4;
constexpr int SMALL_MIN_BLOCKS = 1, SORTED_MIN_BLOCKS = 3;  // blocks an SM, for ptxas
constexpr int SLOTS_PER_KEY = 2;  // the small kernel's hash slots per staged key
constexpr size_t MAX_SMEM = 227 * 1024;  // dynamic shared memory a block may use

// The element offset in dout of the row of the entry at flat position
// p = (b * T + t) * nnz + j.
__device__ __forceinline__ int64_t row_offset(int64_t p, int nnz, int nT, int64_t sd_b,
                                              int64_t sd_t) {
  int64_t b, t;
  if (p <= INT_MAX) {  // 32-bit division where it fits
    const unsigned bag = (unsigned)p / (unsigned)nnz;
    const unsigned bu = bag / (unsigned)nT;
    b = bu;
    t = bag - bu * (unsigned)nT;
  } else {
    const int64_t bag = p / nnz;
    b = bag / nT;
    t = bag - b * nT;
  }
  return b * sd_b + t * sd_t;
}

// The hash slot of a key among 2^hbits (hbits >= 1).
__device__ __forceinline__ int slot_of(int64_t key, int hbits) {
  const uint32_t x = (uint32_t)key ^ (uint32_t)((uint64_t)key >> 32);
  return (int)((x * 2654435761u) >> (32 - hbits));
}

// VEC = Vec<T>::N: dout rows are 16-byte aligned with unit element stride,
// and a lane loads 16 bytes at a time (scalar loads for a ragged tail).
// VEC = 1: any dout strides, one value a lane.  dtables is contiguous.
// Grid (blocks a table, T); dynamic shared memory: m int64 keys, then two
// int arrays of 2^hbits slots.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, SMALL_MIN_BLOCKS)
embedding_bag_bwd_small_kernel(const T* __restrict__ dout, const void* __restrict__ ids,
                               int ids64, T* __restrict__ dtables, int m, int nnz, int64_t R,
                               int E, int L, int hbits, int64_t si_b, int64_t si_t,
                               int64_t si_j, int64_t sd_b, int64_t sd_t, int64_t sd_e) {
  extern __shared__ int64_t skey[];  // table t's keys in (b, j) order; -1 dropped
  // Per hash slot, the first and last entry whose key lands there: only
  // entries between them can share a key with one that does.
  int* first = reinterpret_cast<int*>(skey + m);
  int* last = first + (1 << hbits);
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, sub = lane & (L - 1), gbase = lane - sub;
  const unsigned gmask = group_mask(gbase, L);
  const int groups = THREADS / L, stride = gridDim.x * groups;
  const int n_chunks = (E + VEC - 1) / VEC, rounds = (n_chunks + L - 1) / L;
  const T* dt = dout + (int64_t)t * sd_t;
  // The lane's chunk of a row in round 0.  The group's first entry's row is
  // in flight while the ids are staged: the owner adds it first, and its
  // address needs no id.
  const bool active0 = sub < n_chunks;
  const int width0 = active0 ? min(VEC, E - sub * VEC) : 0;
  const int64_t off0 = (int64_t)sub * VEC * sd_e;
  int i = blockIdx.x * groups + threadIdx.x / L;
  Raw<VEC> own{};
  if (i < m && active0)
    load_raw<T, VEC>(own, dt + (int64_t)(i / nnz) * sd_b + off0, width0, sd_e);
  for (int h = threadIdx.x; h < (1 << hbits); h += THREADS) {
    first[h] = INT_MAX;
    last[h] = -1;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += THREADS) {
    const int b = k / nnz, j = k - b * nnz;
    const int64_t off = (int64_t)b * si_b + (int64_t)t * si_t + (int64_t)j * si_j;
    int64_t id = ids64 ? static_cast<const int64_t*>(ids)[off]
                       : (int64_t) static_cast<const int*>(ids)[off];
    if (id < 0) id += R;
    const int64_t key = (id >= 0 && id < R) ? id : -1;
    skey[k] = key;
    if (key >= 0) {  // integer min and max: the same whatever the order
      const int h = slot_of(key, hbits);
      atomicMin(&first[h], k);
      atomicMax(&last[h], k);
    }
  }
  __syncthreads();  // the last barrier: no thread has returned yet

  // Control flow below is uniform within a group: every lane of it holds
  // the same entry i and key.
  for (; i < m; i += stride) {
    const Raw<VEC> cur = own;
    if (i + stride < m && active0)  // the next entry's row, in flight meanwhile
      load_raw<T, VEC>(own, dt + (int64_t)((i + stride) / nnz) * sd_b + off0, width0, sd_e);
    const int64_t key = skey[i];
    if (key < 0) continue;  // a dropped id
    const int h = slot_of(key, hbits), f = first[h], l = last[h];
    // The row's owner is its first entry: no entry in [f, i) has the key.
    bool earlier = false;
    for (int c = f - f % L; f < i && c < i && !earlier; c += L) {
      const int k = c + sub;
      earlier = __ballot_sync(gmask, k >= f && k < i && skey[k] == key) != 0u;
    }
    if (earlier) continue;
    T* op = dtables + ((int64_t)t * R + key) * E;
    for (int r = 0; r < rounds; ++r) {
      const int cc = r * L + sub, e0 = cc * VEC;
      const bool active = cc < n_chunks;
      const int width = active ? min(VEC, E - e0) : 0;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
      if (r == 0) {
        if (active) add_raw<T, VEC>(acc, cur);
      } else if (active) {
        Raw<VEC> v;
        load_raw<T, VEC>(v, dt + (int64_t)(i / nnz) * sd_b + (int64_t)e0 * sd_e, width, sd_e);
        add_raw<T, VEC>(acc, v);
      }
      // The later entries with the key, in (b, j) order: all in (i, l].
      for (int c = (i + 1) - (i + 1) % L; c <= l && i < l; c += L) {
        const int k = c + sub;
        unsigned hits = __ballot_sync(gmask, k > i && k <= l && skey[k] == key) >> gbase;
        while (hits) {  // ROWS rows in flight, then the adds in (b, j) order
          Raw<VEC> v[ROWS];
          int cnt = 0;
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            if (hits) {
              const int idx = c + __ffs(hits) - 1;
              hits &= hits - 1u;
              if (active)
                load_raw<T, VEC>(v[u], dt + (int64_t)(idx / nnz) * sd_b + (int64_t)e0 * sd_e,
                                 width, sd_e);
              cnt = u + 1;
            }
          }
#pragma unroll
          for (int u = 0; u < ROWS; ++u)
            if (u < cnt && active) add_raw<T, VEC>(acc, v[u]);
        }
      }
      if (active) store_chunk<T, VEC>(op + e0, acc, width, E);
    }
  }
}

// cp.async of `bytes` (<= 16; zero past them) from global to shared memory,
// cached in L2 only; a thread's copies have landed at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The dout rows at element offsets off_at(0 .. cnt-1) (from `lane_dout`,
// the lane's column) added to acc in order, ROWS in flight in registers;
// off_at(u) is uniform within the group.
template <typename T, int VEC, typename OffAt>
__device__ __forceinline__ void add_rows(float (&acc)[VEC], int cnt, OffAt off_at,
                                         const T* lane_dout, int width, int64_t sd_e,
                                         bool active) {
  for (int u0 = 0; u0 < cnt; u0 += ROWS) {
    Raw<VEC> v[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (u0 + u < cnt) {
        const int64_t off = off_at(u0 + u);
        if (active) load_raw<T, VEC>(v[u], lane_dout + off, width, sd_e);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      if (u0 + u < cnt && active) add_raw<T, VEC>(acc, v[u]);
  }
}

// Grid: one warp per 32 sorted entries, SORTED_WARPS a block.  keys (K:
// int32 where T * R fits, else int64) and pos as the wrapper sorts them.
// VEC > 1: dynamic shared memory holds each warp's ring of 32 rows x L
// 16-byte chunks.
template <typename T, int VEC, typename K>
__global__ void __launch_bounds__(SORTED_WARPS * 32, SORTED_MIN_BLOCKS)
embedding_bag_bwd_sorted_kernel(const T* __restrict__ dout, const K* __restrict__ keys,
                                const int64_t* __restrict__ pos, T* __restrict__ dtables,
                                int64_t n, int64_t n_rows, int nT, int nnz, int E, int L,
                                int64_t sd_b, int64_t sd_t, int64_t sd_e) {
  __shared__ K skey[SORTED_WARPS][32];
  __shared__ int64_t soff[SORTED_WARPS][32];  // each entry's dout row offset
  extern __shared__ uint4 ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = ((int64_t)blockIdx.x * SORTED_WARPS + warp) * 32;
  if (base >= n) return;  // the whole warp; no block barrier below
  // One coalesced load of the chunk's keys and positions; each lane turns
  // its position into a row offset, so no later load waits on a division.
  const int64_t k = base + lane;
  const K dropped = (K)n_rows;  // past n too
  const K key = k < n ? keys[k] : dropped;
  skey[warp][lane] = key;
  soff[warp][lane] = k < n ? row_offset(pos[k], nnz, nT, sd_b, sd_t) : 0;
  K prev = __shfl_up_sync(FULL, key, 1);
  if (lane == 0) prev = base > 0 ? keys[base - 1] : (K)-1;
  const unsigned change = __ballot_sync(FULL, key != prev);  // where a run (or the drops) starts
  const unsigned valid = __ballot_sync(FULL, key != dropped);  // a prefix: drops sort last
  unsigned starts = change & valid;
  if (!starts) return;  // the chunk lies inside a run an earlier warp walks
  __syncwarp();

  const int sub = lane & (L - 1), gbase = lane - sub, g = lane / L, G = 32 / L;
  const unsigned gmask = group_mask(gbase, L);
  const int n_chunks = (E + VEC - 1) / VEC, rounds = (n_chunks + L - 1) / L;
  const int first = __ffs(starts) - 1, last = 31 - __clz(valid);  // the rows this warp adds
  // The group that takes the chunk's last run walks past the chunk's end
  // when the run reaches it.
  const bool tail = (valid >> 31) && (__popc(starts) - 1) % G == g;
  for (int q = g; q > 0 && starts; --q) starts &= starts - 1u;  // group g: starts g, g + G, ...
  uint4* wring = ring + warp * 32 * L;
  for (int r = 0; r < rounds; ++r) {
    const int cc = r * L + sub, e0 = cc * VEC;
    const bool active = cc < n_chunks;
    const int width = active ? min(VEC, E - e0) : 0;
    const T* lane_dout = dout + (int64_t)e0 * sd_e;
    // The first step past the chunk, in flight with the chunk's rows.
    K next_key = dropped;
    int64_t next_off = 0;
    if (tail && base + 32 + sub < n) {
      next_key = keys[base + 32 + sub];
      next_off = row_offset(pos[base + 32 + sub], nnz, nT, sd_b, sd_t);
    }
    if constexpr (VEC > 1) {
      // Every row of the chunk's runs in flight at once: group g loads rows
      // first + g, first + g + G, ..., each lane its 16-byte chunk of them.
      for (int row = first + g; row <= last; row += G)
        if (active) cp_async16(wring + row * L + sub, lane_dout + soff[warp][row],
                               width * (int)sizeof(T));
      cp_async_wait_all();
      __syncwarp();  // the rows other groups loaded
    }
    for (unsigned mine = starts; mine;) {  // uniform within the group
      const int s = __ffs(mine) - 1;
      for (int q = 0; q < G && mine; ++q) mine &= mine - 1u;
      const unsigned later = change & ~((2u << s) - 1u);
      const int end = later ? __ffs(later) - 1 : 32;  // 32: the run goes on past the chunk
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
      if constexpr (VEC > 1) {
        if (active) {
          for (int row = s; row < end; ++row) {
            const uint4 w = wring[row * L + sub];
            const Raw<VEC> raw{{w.x, w.y, w.z, w.w}};
            add_raw<T, VEC>(acc, raw);
          }
        }
      } else {
        add_rows<T, VEC>(acc, end - s, [&](int u) { return soff[warp][s + u]; }, lane_dout, width,
                         sd_e, active);
      }
      const K run_key = skey[warp][s];
      // Past the chunk, L sorted entries a step (the run's are a prefix),
      // each step's keys loaded before the rows of the one before.
      for (int64_t c = base + 32, cnt = L; end == 32 && cnt == L; c += L) {
        const int64_t off = next_off;
        cnt = __popc(__ballot_sync(gmask, next_key == run_key));
        next_key = dropped;
        if (cnt == L && c + L + sub < n) {
          next_key = keys[c + L + sub];
          next_off = row_offset(pos[c + L + sub], nnz, nT, sd_b, sd_t);
        }
        add_rows<T, VEC>(acc, (int)cnt, [&](int u) { return __shfl_sync(gmask, off, gbase + u); },
                         lane_dout, width, sd_e, active);
      }
      if (active) store_chunk<T, VEC>(dtables + (int64_t)run_key * E + e0, acc, width, E);
    }
    __syncwarp();  // every lane done with the ring before the next round
  }
}

// keys[k] = t * R + id for the entry at flat position k = (b * T + t) * nnz
// + j, a negative id wrapped once by R; T * R for an id still outside
// [0, R).  One pass over the ids, at any strides, int32 or int64; K as the
// sorted kernel takes them.
template <typename I, typename K>
__global__ void __launch_bounds__(THREADS)
embedding_bag_keys_kernel(const I* __restrict__ ids, K* __restrict__ keys, int64_t n, int nT,
                          int nnz, int64_t R, int64_t si_b, int64_t si_t, int64_t si_j) {
  for (int64_t k = (int64_t)blockIdx.x * THREADS + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * THREADS) {
    const int64_t bag = k / nnz, j = k - bag * nnz, b = bag / nT, t = bag - b * nT;
    int64_t id = ids[b * si_b + t * si_t + j * si_j];
    if (id < 0) id += R;
    keys[k] = (K)((id >= 0 && id < R) ? t * R + id : (int64_t)nT * R);
  }
}

struct Strides { int64_t b, t, e; };

template <typename T, int VEC>
cudaError_t small_vec(const void* dout, const void* ids, int ids64, void* dtables, int B,
                      int nT, int64_t R, int E, int nnz, Strides si, Strides sd,
                      cudaStream_t stream) {
  const int L = lanes_per_bag((E + VEC - 1) / VEC);
  const int groups = THREADS / L, m = B * nnz;
  // 2^hbits >= SLOTS_PER_KEY * m hash slots (fewer where shared memory
  // runs out, but never fewer than m): a key shares its slot with another
  // key, and so scans a range, with odds of about 1 - exp(-1 / SLOTS_PER_KEY).
  int hbits = 1;
  while ((1 << hbits) < SLOTS_PER_KEY * m) ++hbits;
  while (hbits > 1 && (1 << (hbits - 1)) >= m &&
         (size_t)m * sizeof(int64_t) + (2u << hbits) * sizeof(int) > MAX_SMEM)
    --hbits;
  const size_t smem = (size_t)m * sizeof(int64_t) + (2u << hbits) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        embedding_bag_bwd_small_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  // A group per entry, up to about 4 blocks an SM over all tables; past
  // that a group takes several entries, so fewer blocks stage each table.
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int need = (m + groups - 1) / groups, cap = (4 * sms + nT - 1) / nT;
  const dim3 grid((unsigned)(need < cap ? need : cap), (unsigned)nT);
  embedding_bag_bwd_small_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(dout), ids, ids64, static_cast<T*>(dtables), m, nnz, R, E, L, hbits,
      si.b, si.t, si.e, sd.b, sd.t, sd.e);
  return cudaGetLastError();
}

template <typename T, int VEC, typename K>
cudaError_t sorted_vec(const void* dout, const void* keys, const int64_t* pos, void* dtables,
                       int64_t n, int nT, int64_t R, int E, int nnz, Strides sd,
                       cudaStream_t stream) {
  const int L = lanes_per_bag((E + VEC - 1) / VEC);
  const int64_t per_block = (int64_t)SORTED_WARPS * 32;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const size_t smem = VEC > 1 ? (size_t)SORTED_WARPS * 32 * L * sizeof(uint4) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        embedding_bag_bwd_sorted_kernel<T, VEC, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  embedding_bag_bwd_sorted_kernel<T, VEC, K><<<(unsigned)blocks, SORTED_WARPS * 32, smem,
                                                stream>>>(
      static_cast<const T*>(dout), static_cast<const K*>(keys), pos, static_cast<T*>(dtables), n,
      (int64_t)nT * R, nT, nnz, E, L, sd.b, sd.t, sd.e);
  return cudaGetLastError();
}

// 16-byte loads where dout allows them.
template <typename T>
bool aligned(const void* dout, Strides sd) {
  constexpr int N = Vec<T>::N;
  return reinterpret_cast<uintptr_t>(dout) % 16 == 0 && sd.e == 1 && sd.b % N == 0 &&
         sd.t % N == 0;
}

template <typename T>
cudaError_t small(const void* dout, const void* ids, int ids64, void* dtables, int B, int nT,
                  int64_t R, int E, int nnz, Strides si, Strides sd, cudaStream_t s) {
  if (aligned<T>(dout, sd))
    return small_vec<T, Vec<T>::N>(dout, ids, ids64, dtables, B, nT, R, E, nnz, si, sd, s);
  return small_vec<T, 1>(dout, ids, ids64, dtables, B, nT, R, E, nnz, si, sd, s);
}

template <typename T, typename K>
cudaError_t sorted(const void* dout, const void* keys, const int64_t* pos, void* dtables,
                   int64_t n, int nT, int64_t R, int E, int nnz, Strides sd, cudaStream_t s) {
  if (aligned<T>(dout, sd))
    return sorted_vec<T, Vec<T>::N, K>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd, s);
  return sorted_vec<T, 1, K>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd, s);
}

template <typename K>
cudaError_t sorted_by_dtype(int dtype, const void* dout, const void* keys, const int64_t* pos,
                            void* dtables, int64_t n, int nT, int64_t R, int E, int nnz,
                            Strides sd, cudaStream_t s) {
  switch (dtype) {
    case 0: return sorted<float, K>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd, s);
    case 1: return sorted<__half, K>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd, s);
    case 2: return sorted<__nv_bfloat16, K>(dout, keys, pos, dtables, n, nT, R, E, nnz, sd, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename I>
cudaError_t keys_of(const void* ids, int keys64, void* keys, int64_t n, int nT, int64_t R,
                    int nnz, Strides si, cudaStream_t s) {
  const int64_t need = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(need < (1 << 20) ? need : (1 << 20));  // grid-stride past
  const I* in = static_cast<const I*>(ids);
  if (keys64)
    embedding_bag_keys_kernel<I, int64_t><<<blocks, THREADS, 0, s>>>(
        in, static_cast<int64_t*>(keys), n, nT, nnz, R, si.b, si.t, si.e);
  else
    embedding_bag_keys_kernel<I, int><<<blocks, THREADS, 0, s>>>(
        in, static_cast<int*>(keys), n, nT, nnz, R, si.b, si.t, si.e);
  return cudaGetLastError();
}

}  // namespace

// The `small` tiling.  dout: (B, T, E) device array of one dtype (0 float32,
// 1 float16, 2 bfloat16) with element strides sd_*; ids: (B, T, nnz) int32
// (ids64 = 0) or int64 (1) with element strides si_*, B * T * nnz <=
// N_SMALL; dtables: contiguous (T, R, E) of dout's dtype, zeroed.  Writes
// the rows the ids select.  Returns a cudaError_t (0 on success).
extern "C" int repro_embedding_bag_bwd_small(const void* dout, const void* ids, int ids64,
                                             void* dtables, int B, int T, long long R, int E,
                                             int nnz, long long si_b, long long si_t,
                                             long long si_j, long long sd_b, long long sd_t,
                                             long long sd_e, int dtype, void* stream) {
  if (B < 1 || T < 1 || R < 1 || E < 1 || nnz < 1 || (long long)B * T * nnz > N_SMALL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides si{si_b, si_t, si_j}, sd{sd_b, sd_t, sd_e};
  switch (dtype) {
    case 0: return (int)small<float>(dout, ids, ids64, dtables, B, T, R, E, nnz, si, sd, s);
    case 1: return (int)small<__half>(dout, ids, ids64, dtables, B, T, R, E, nnz, si, sd, s);
    case 2:
      return (int)small<__nv_bfloat16>(dout, ids, ids64, dtables, B, T, R, E, nnz, si, sd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The `sorted` tiling.  keys: n = B * T * nnz sorted keys t * R + id (T * R
// for a dropped id), int32 (keys64 = 0; T * R must fit) or int64 (1); pos:
// each sorted entry's flat position (b * T + t) * nnz + j, int64; dout and
// dtables as above.
extern "C" int repro_embedding_bag_bwd_sorted(const void* dout, const void* keys, int keys64,
                                              const void* pos, void* dtables, long long n, int T,
                                              long long R, int E, int nnz, long long sd_b,
                                              long long sd_t, long long sd_e, int dtype,
                                              void* stream) {
  if (n < 1 || T < 1 || R < 1 || E < 1 || nnz < 1 || (!keys64 && (long long)T * R > INT_MAX))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(pos);
  const Strides sd{sd_b, sd_t, sd_e};
  if (keys64)
    return (int)sorted_by_dtype<int64_t>(dtype, dout, keys, p, dtables, n, T, R, E, nnz, sd, s);
  return (int)sorted_by_dtype<int>(dtype, dout, keys, p, dtables, n, T, R, E, nnz, sd, s);
}

// The `sorted` tiling's keys, unsorted: keys[k] for k < n = B * T * nnz as
// embedding_bag_keys_kernel writes them, int32 (keys64 = 0; T * R must fit)
// or int64 (1), from (B, T, nnz) ids (int32 or int64) at element strides
// si_*.
extern "C" int repro_embedding_bag_keys(const void* ids, int ids64, void* keys, int keys64,
                                        long long n, int T, long long R, int nnz, long long si_b,
                                        long long si_t, long long si_j, void* stream) {
  if (n < 1 || T < 1 || R < 1 || nnz < 1 || (!keys64 && (long long)T * R > INT_MAX))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides si{si_b, si_t, si_j};
  if (ids64) return (int)keys_of<int64_t>(ids, keys64, keys, n, T, R, nnz, si, s);
  return (int)keys_of<int>(ids, keys64, keys, n, T, R, nnz, si, s);
}
