// DLRM embedding-bag lookup for Hopper.
//
// Replaces the Pallas TPU kernel `embedding_bag` / `_bag_kernel` in
// src/repro/kernels/embedding_bag.py.  It computes the same function:
//   out[b, t] = sum_j tables[t, idx[b, t, j]]
// over tables (T, R, E) in fp32, fp16 or bf16 and indices (B, T, NNZ) in
// int32 or int64, summing in fp32 (in j's order, from 0) and rounding once
// to the tables' dtype.  An id past the table is clamped to R - 1 and a
// negative one wrapped by R first (then clamped to 0), as the reference's
// XLA gather does, so no id reads outside its table and nothing is checked
// on the host.
//
// Design.  The TPU kernel prefetches the ids as scalars and lets each grid
// step DMA one (1, 1, E) row.  Here the lookup is a gather.  A group of L
// lanes owns a row (embedding_bag.cuh): each lane loads 16 bytes of it at a
// time (4 fp32 or 8 bf16/fp16 values), so a row of E = 128 is one coalesced
// request of a warp in fp32 and of half a warp in bf16.  The bags, taken
// flat as bag = b * T + t, are cut into units of G consecutive bags, and
// each group walks units in a grid-stride loop over a grid of MIN_BLOCKS
// blocks an SM, all resident at once.  The launch (`split_of`) takes the
// fewest bags a unit that let the groups the card holds take every unit in
// one pass, at most Q / nnz: the serving lookup (1024 bags) spreads over
// the SMs a bag a group, the scoring batch (32768 bags of one id) takes Q
// bags a unit, a multi-hot bag is a unit alone.  A group:
//   - reads a unit's ids in rounds of L, one id a lane: one coalesced
//     request for consecutive bags' ids, where every lane loading every id
//     would be one request an id; __shfl_sync hands out the row offsets;
//   - issues its chunks of up to Q rows (Q = 4 with 16-byte chunks, 8 with
//     scalar ones) before it adds any, holding them as raw bits (4
//     registers a 16-byte chunk in any dtype), then adds them in j's order:
//     each row its own sum at one id a bag, all into the current bag's sums
//     where they belong to it, else one row a step of a loop that is not
//     unrolled; it stores a bag's sums after its last id;
//   - loads the next round's ids (the next unit's, at a unit's end) once
//     the current round's first rows are in flight, so a group waits on an
//     id load once, at its start.
// The divisions on the way to the first load (an entry's bag and id, a
// bag's b and t) multiply by a reciprocal the host computes.  At the
// scoring batch (E = 128 fp32, one id a bag) a warp so has 4 rows (2 KB) in
// flight, where a warp a bag had one row, behind its own dependent id load;
// its 8192 units take 2.6 passes of the 3168 groups an H100 holds.  A row
// of E not a multiple of the vector width ends in scalar loads; tables
// whose rows are not 16-byte aligned, or whose last dim is strided, take
// the same kernel with one value a lane.  Every offset into the tables is
// 64-bit: at T = 8, R = 1e7, E = 128 the last table starts 8.96e9 elements
// in.
//
// Bound on the H100 SXM: bytes.  A bag moves NNZ rows in and one row out and
// adds NNZ * E values, far below the fp32 rate, so the floor is the bytes of
// the rows the ids select (plus ids and output) at 3.35 TB/s: 0.16 ms for
// B = 4096, T = 8, NNZ = 32, E = 128 fp32 (537 MB of rows), 0.010 ms at one
// id a bag (16.8 MB of rows, as much output).  At the DLRM serving batch
// (B = 128, NNZ = 1: 0.5 MB) the launch dominates.

#include "embedding_bag.cuh"

namespace {

// The rows each lane has in flight, and so the most bags of one id a unit:
// 16-byte chunks take 4 registers a row, scalar ones 1.
constexpr int Q_VEC = 4, Q_SCALAR = 8;
constexpr int MIN_BLOCKS = 3;  // blocks an SM, for ptxas: up to 80 registers a thread

// The row an id selects: negative ids wrap by R, then all clamp to [0, R).
template <typename I>
__device__ __forceinline__ int64_t row_of(I raw, int64_t R) {
  int64_t id = (int64_t)raw;
  if (id < 0) id += R;
  return id < 0 ? 0 : (id >= R ? R - 1 : id);
}

// a / d for a >= 0 and d >= 1, from inv = 1.0 / d: below 2^50 the product
// is within a quarter of the quotient, and one step corrects its floor.  A
// few instructions where an integer division takes dozens, on the path to
// the first load.
__device__ __forceinline__ int64_t div_by(int64_t a, int64_t d, double inv) {
  if (a >= (int64_t(1) << 50)) return a / d;
  int64_t q = (int64_t)((double)a * inv);
  if (q * d > a) --q;
  else if ((q + 1) * d <= a) ++q;
  return q;
}

// VEC = Vec<T>::N: rows are 16-byte aligned with unit element stride, and a
// lane loads 16 bytes at a time (scalar loads for a ragged tail).  VEC = 1:
// any strides, one value a lane.  Unit u is bags [u * G, u * G + G) and its
// entries e = k * nnz + j (bag u * G + k, id j), in that order.
template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
embedding_bag_kernel(const T* __restrict__ tables, const I* __restrict__ idx,
                     T* __restrict__ out, int nT, int64_t n_bags, int64_t n_units, int64_t R,
                     int E, int nnz, int L, int rounds, int G, double inv_nnz, double inv_nT,
                     int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b, int64_t si_t,
                     int64_t si_j) {
  constexpr int Q = VEC > 1 ? Q_VEC : Q_SCALAR;
  const int lane = threadIdx.x & 31, sub = lane & (L - 1), gbase = lane - sub;
  const unsigned gmask = group_mask(gbase, L);
  const int groups = THREADS / L;
  const int64_t stride = (int64_t)gridDim.x * groups;
  int64_t u = (int64_t)blockIdx.x * groups + threadIdx.x / L;
  if (u >= n_units) return;  // the whole group: no barrier below, shuffles stay in it
  const int n_chunks = (E + VEC - 1) / VEC;  // rounds = ceil(n_chunks / L), from the host

  auto n_entries = [&](int64_t unit) {
    const int64_t left = n_bags - unit * G;
    return (int)(left < G ? left : G) * nnz;
  };
  // The bag within its unit of entry e.  A unit of one bag needs no
  // division: 2-3% off the 16-byte kernel at B = 128, 4 ids a bag.  The
  // scalar kernels keep the division: with the shortcut their time after an
  // L2 flush rose 7-10% at E = 13, 7 ids a bag (tools/time_bag_checks.py on
  // an H100 SXM).
  auto bag_in_unit = [&](int e) {
    if constexpr (VEC > 1) return nnz == 1 ? e : (G == 1 ? 0 : (int)div_by(e, nnz, inv_nnz));
    else return nnz == 1 ? e : (int)div_by(e, nnz, inv_nnz);
  };
  // The lane's id of the next round of L entries, and its table's offset.
  I raw = 0;
  int64_t toff = 0;
  auto fetch = [&](int64_t unit, int e0) {
    const int64_t e = (int64_t)e0 + sub;
    if (e < n_entries(unit)) {
      const int k = bag_in_unit((int)e), j = (int)e - k * nnz;
      const int64_t bag = unit * G + k, b = div_by(bag, nT, inv_nT);
      const int t = (int)(bag - b * nT);
      raw = idx[b * si_b + (int64_t)t * si_t + (int64_t)j * si_j];
      toff = (int64_t)t * st_t;
    }
  };

  fetch(u, 0);
  int r = 0, e0 = 0;  // the chunk round and the first entry of this round of ids
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // Control flow below is uniform within a group.
  for (;;) {
    const int n_ent = n_entries(u), cnt = min(L, n_ent - e0);
    // Where the next round starts: its ids load once this round's first rows
    // are in flight.
    const bool last = n_ent - e0 <= L;  // the unit's last round of ids
    int64_t u_next = u;
    int r_next = r, e_next = last ? 0 : e0 + L;
    if (last) {
      if (++r_next == rounds) {
        r_next = 0;
        u_next += stride;
      }
    }
    const int c = r * L + sub, col = c * VEC;
    const bool active = c < n_chunks;
    const int width = active ? min(VEC, E - col) : 0;
    const T* lane_tables = tables + (int64_t)col * st_e;
    // The bag and id of entry e0.
    int k = bag_in_unit(e0), j = e0 - k * nnz;
    const int64_t roff = sub < cnt ? toff + row_of<I>(raw, R) * st_r : 0;
    // With 16-byte chunks, the row offsets of a later batch are shuffled,
    // from the lanes that loaded their ids, while the batch before it is in
    // flight (scalar rows shuffle as they load: registers are short there).
    constexpr bool AHEAD = VEC > 1;
    long long off[AHEAD ? Q : 1];
    for (int q0 = 0; q0 < cnt; q0 += Q) {
      const int n = min(Q, cnt - q0);
      Raw<VEC> v[Q];
      if (AHEAD && q0 > 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q)  // n rows in flight before any add
          if (q < n && active) load_raw<T, VEC>(v[q], lane_tables + off[q], width, st_e);
      } else if (n == 1) {  // one row: one shuffle
        const long long o = __shfl_sync(gmask, (long long)roff, gbase + q0);
        if (active) load_raw<T, VEC>(v[0], lane_tables + o, width, st_e);
      } else {  // every shuffle outside a branch, each load as its offset lands
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const long long o = __shfl_sync(gmask, (long long)roff, gbase + ((q0 + q) & (L - 1)));
          if (q < n && active) load_raw<T, VEC>(v[q], lane_tables + o, width, st_e);
        }
      }
      if (q0 == 0 && u_next < n_units) fetch(u_next, e_next);
      if (AHEAD && q0 + Q < cnt) {  // the next batch's offsets, while these rows land
#pragma unroll
        for (int q = 0; q < (AHEAD ? Q : 1); ++q)
          off[q] = __shfl_sync(gmask, (long long)roff, gbase + ((q0 + Q + q) & (L - 1)));
      }
      if (nnz == 1) {  // a bag a row: each sum 0 + row, stored as it lands
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (q < n && active) {
            float one[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) one[i] = 0.f;
            add_raw<T, VEC>(one, v[q]);
            store_chunk<T, VEC>(out + (u * G + k + q) * E + col, one, width, E);
          }
        }
        k += n;
      } else if (n <= nnz - j) {  // every row adds to the current bag, in j's order
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (q < n && active) add_raw<T, VEC>(acc, v[q]);
        if ((j += n) == nnz) {  // the bag's last id: its sums, rounded once
          if (active) store_chunk<T, VEC>(out + (u * G + k) * E + col, acc, width, E);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
          j = 0;
          ++k;
        }
      } else {  // a bag ends inside the batch: one row a step, the rest shifted down
#pragma unroll 1
        for (int q = 0; q < n; ++q) {
          if (active) add_raw<T, VEC>(acc, v[0]);
          if (++j == nnz) {
            if (active) store_chunk<T, VEC>(out + (u * G + k) * E + col, acc, width, E);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
            j = 0;
            ++k;
          }
#pragma unroll
          for (int i = 0; i + 1 < Q; ++i) v[i] = v[i + 1];
        }
      }
    }
    if (u_next >= n_units) return;
    u = u_next;
    r = r_next;
    e0 = e_next;
  }
}

// How a lookup is split: VEC values a lane loads at a time (16 bytes where
// the rows are 16-byte aligned with unit element stride, else 1), L lanes a
// row, G bags a unit and Q rows in flight a lane.  G is the fewest bags
// that let the groups of the card's `sms` SMs take every unit in one pass,
// at most Q / nnz, at least 1.
struct Split {
  int vec, L, G, Q;
};

template <typename T>
Split split_of(const void* tables, int E, int nnz, int64_t n_bags, int64_t st_t, int64_t st_r,
               int64_t st_e, int sms) {
  constexpr int N = Vec<T>::N;
  const bool aligned = reinterpret_cast<uintptr_t>(tables) % 16 == 0 && st_e == 1 &&
                       st_t % N == 0 && st_r % N == 0;
  const int vec = aligned ? N : 1, Q = aligned ? Q_VEC : Q_SCALAR;
  const int L = lanes_per_bag((E + vec - 1) / vec);
  const int64_t groups = (int64_t)sms * MIN_BLOCKS * (THREADS / L);
  const int64_t fill = (n_bags + groups - 1) / groups, cap = Q / nnz > 1 ? Q / nnz : 1;
  return {vec, L, (int)(fill < cap ? fill : cap), Q};
}

template <typename T, typename I, int VEC>
cudaError_t launch_vec(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                       int E, int nnz, const Split& s, int sms, int64_t st_t, int64_t st_r,
                       int64_t st_e, int64_t si_b, int64_t si_t, int64_t si_j,
                       cudaStream_t stream) {
  const int n_chunks = (E + VEC - 1) / VEC, groups = THREADS / s.L;
  const int64_t n_bags = (int64_t)B * nT, n_units = (n_bags + s.G - 1) / s.G;
  // MIN_BLOCKS blocks an SM, all resident at once (the launch bound holds
  // their registers), fewer where the units run out.
  const int64_t need = (n_units + groups - 1) / groups, cap = (int64_t)sms * MIN_BLOCKS;
  embedding_bag_kernel<T, I, VEC><<<(unsigned)(need < cap ? need : cap), THREADS, 0, stream>>>(
      static_cast<const T*>(tables), static_cast<const I*>(idx), static_cast<T*>(out), nT,
      n_bags, n_units, R, E, nnz, s.L, (n_chunks + s.L - 1) / s.L, s.G, 1.0 / nnz, 1.0 / nT,
      st_t, st_r, st_e, si_b, si_t, si_j);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                   int E, int nnz, int sms, int64_t st_t, int64_t st_r, int64_t st_e, int64_t si_b,
                   int64_t si_t, int64_t si_j, cudaStream_t stream) {
  const Split s = split_of<T>(tables, E, nnz, (int64_t)B * nT, st_t, st_r, st_e, sms);
  if (s.vec > 1)
    return launch_vec<T, I, Vec<T>::N>(tables, idx, out, B, nT, R, E, nnz, s, sms, st_t, st_r,
                                       st_e, si_b, si_t, si_j, stream);
  return launch_vec<T, I, 1>(tables, idx, out, B, nT, R, E, nnz, s, sms, st_t, st_r, st_e, si_b,
                             si_t, si_j, stream);
}

template <typename T>
cudaError_t launch_ids(const void* tables, const void* idx, void* out, int B, int nT, int64_t R,
                       int E, int nnz, int sms, int64_t st_t, int64_t st_r, int64_t st_e,
                       int64_t si_b, int64_t si_t, int64_t si_j, int idx64,
                       cudaStream_t stream) {
  if (idx64)
    return launch<T, int64_t>(tables, idx, out, B, nT, R, E, nnz, sms, st_t, st_r, st_e, si_b,
                              si_t, si_j, stream);
  return launch<T, int32_t>(tables, idx, out, B, nT, R, E, nnz, sms, st_t, st_r, st_e, si_b,
                            si_t, si_j, stream);
}

}  // namespace

// tables: (T, R, E) device array of one dtype (0 float32, 1 float16,
// 2 bfloat16) with element strides st_t, st_r, st_e; idx: (B, T, NNZ) int32
// (idx64 = 0) or int64 (idx64 = 1) with element strides si_b, si_t, si_j;
// out: contiguous (B, T, E) of the tables' dtype; sms: the current device's
// SMs, which size the units (`split_of`; any split gives the same bits).
// Returns a cudaError_t (0 on success).
extern "C" int repro_embedding_bag(const void* tables, const void* idx, void* out, int B, int T,
                                   long long R, int E, int nnz, int sms, long long st_t,
                                   long long st_r, long long st_e, long long si_b,
                                   long long si_t, long long si_j, int dtype, int idx64,
                                   void* stream) {
  if (B < 1 || T < 1 || R < 1 || E < 1 || nnz < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_ids<float>(tables, idx, out, B, T, R, E, nnz, sms, st_t, st_r, st_e,
                                    si_b, si_t, si_j, idx64, s);
    case 1:
      return (int)launch_ids<__half>(tables, idx, out, B, T, R, E, nnz, sms, st_t, st_r, st_e,
                                     si_b, si_t, si_j, idx64, s);
    case 2:
      return (int)launch_ids<__nv_bfloat16>(tables, idx, out, B, T, R, E, nnz, sms, st_t, st_r,
                                            st_e, si_b, si_t, si_j, idx64, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split `repro_embedding_bag` takes for these tables and B * T =
// n_bags bags of nnz ids on `sms` SMs, into split[0..3]: VEC, L, G, Q.
// Computes nothing on the device.  Returns a cudaError_t (0 on success).
extern "C" int repro_embedding_bag_split(const void* tables, int E, int nnz, long long n_bags,
                                         long long st_t, long long st_r, long long st_e,
                                         int dtype, int sms, int* split) {
  if (E < 1 || nnz < 1 || n_bags < 1 || sms < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Split s =
      dtype == 0 ? split_of<float>(tables, E, nnz, n_bags, st_t, st_r, st_e, sms)
      : dtype == 1 ? split_of<__half>(tables, E, nnz, n_bags, st_t, st_r, st_e, sms)
                   : split_of<__nv_bfloat16>(tables, E, nnz, n_bags, st_t, st_r, st_e, sms);
  split[0] = s.vec;
  split[1] = s.L;
  split[2] = s.G;
  split[3] = s.Q;
  return 0;
}
