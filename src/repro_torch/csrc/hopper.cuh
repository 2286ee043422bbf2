// Hopper (sm_90a) building blocks shared by the port's kernels
// (flash_attention.cu, flash_attention_bwd.cu, moe_gmm.cu, moe_gmm_bwd.cu,
// mamba_scan.cu):
// mbarriers, TMA tile loads, clusters (barriers across blocks), TMA stores,
// the SFU's exp2, wgmma shared-memory descriptors and products, the
// producer/consumer register split, and the host-side encoding of TMA
// tensor maps.
//
// Layout convention of the tensor-core kernels (the skinny weight stream
// and the Mamba scan read plain, unswizzled boxes).  Every wgmma operand
// tile is loaded by TMA with the 128-byte swizzle in boxes whose inner
// extent is 64 16-bit values (128 bytes), so a box of R rows is R x 128
// bytes, and wider tiles are several boxes side by side.
// A wgmma operand is then described as follows (CUTLASS's canonical SW128
// layouts, in bytes):
//   K-major (the reduction axis is the fastest): rows 128 bytes apart, each
//     8-row group SBO = 1024 bytes on; a k16 step moves the start 32 bytes
//     within the 128-byte row, and every 64 values of K into the next box.
//   MN-major (the output axis is the fastest): K rows 128 bytes apart, each
//     8 K rows SBO = 1024 bytes on, each 64-wide chunk of M or N LBO bytes
//     on (the size of one box); a k16 step moves the start 16 rows, 2048
//     bytes.  wgmma reads it with its transpose bit set (16-bit types only),
//     for B (TRANS_B) or for A from shared memory (TRANS_A).
// Boxes start on 1024-byte boundaries, so the swizzle phase of an address is
// the same for TMA and wgmma and the descriptors' base offset stays 0.
//
// Head dim 80 (namespace d80 below) fills no whole 128-byte box: a row of 80
// 16-bit values is 160 bytes.  Its tiles are a box of columns 0-63 with the
// 128-byte swizzle (R x 128 bytes) followed by a box of columns 64-79 with
// the 32-byte swizzle (R x 32 bytes: 32-byte rows, each 8-row group SBO = 256
// bytes on; a k16 step, 16 rows, 512 bytes), so TMA moves the real 160 bytes
// a row and no product runs on zero columns.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is only
// guaranteed 16-byte alignment; callers ask for 1024 bytes more than they use).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA; the
// caller follows it with __syncthreads(), or with cluster_sync() in a kernel
// launched in clusters (below).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives and adds `bytes` to the transaction count that the TMA loads
// completing on this barrier will pay off.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of the given parity has completed.  (No
// timeout trap here: a trap block that both warpgroups' code can reach makes
// ptxas allocate the consumers' code within the launch-time 168 registers,
// ignoring their setmaxnreg budget, and the D = 256 attention kernel spills.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One TMA load of a 3-D box at coordinates (c0 innermost, c1, c2) into
// shared memory, completing on `bar`.  Coordinates past the tensor's edge
// read zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------ clusters and TMA stores
//
// A kernel launched in clusters (cudaLaunchKernelEx with a cluster
// dimension) initialises its barriers as above and then calls cluster_sync()
// instead of __syncthreads(), so that no peer arrives on its barriers before
// they exist; it calls cluster_sync() again before it returns, so that
// nothing lands in the shared memory of a block that has gone.  Launched
// without clusters, a block is a cluster of one and the same code serves.

// This block's rank in its cluster, and the cluster's size in blocks.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster arrives (release) and waits
// (acquire): a __syncthreads() that spans the cluster.  Not .aligned, so a
// warp whose threads took different branches may call it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrives on the barrier at bar's offset in the shared memory of block `cta`
// of the cluster, this block's own included: mapa gives its address in the
// cluster's shared window.  (The default semantics, as CUTLASS's
// ClusterBarrier: written .release.cluster, it made the grouped-matmul
// backward in pairs 2.3-2.5x slower, tools/gmm_bwd_variants.py.)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// One TMA store of a 3-D box from shared memory at coordinates (c0
// innermost, c1, c2): whole lines are written, and values past the tensor's
// edge are not.  The box is laid out as the map's swizzle says (see the
// layout convention above).  The writing threads make their shared-memory
// stores visible to TMA first (fence_async_shared, then a barrier); the
// issuing thread groups its stores with bulk_commit and waits on them with
// bulk_wait_read (the source may be written again) or bulk_wait (the
// global writes are done).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups of this thread's stores still read
// their shared-memory source.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N committed groups of this thread's stores are not
// complete.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's earlier shared-memory writes before later reads of
// them by TMA (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads of the block (a multiple of 32) on
// hardware barrier `id` (1-15; __syncthreads() is 0).  Not .aligned.
__device__ __forceinline__ void named_barrier_sync(uint32_t id, uint32_t threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x by the special-function unit (ex2.approx: about 2 ulp).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Producer/consumer register split (setmaxnreg): a warpgroup gives back or
// takes registers; all four warps of the warpgroup execute it together.
template <int REGS> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address
// (a shared-memory address, as smem_u32 gives it), leading and stride byte
// offsets (see the layout convention above).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  const uint32_t lo = ((addr & 0x3FFFFu) >> 4) | (((lbo & 0x3FFFFu) >> 4) << 16);
  const uint32_t hi = ((sbo & 0x3FFFFu) >> 4) | (1u << 30);  // layout type 1: 128-byte swizzle
  return ((uint64_t)hi << 32) | lo;
}

// The same for the 32-byte swizzle (layout type 3).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  const uint32_t lo = ((addr & 0x3FFFFu) >> 4) | (((lbo & 0x3FFFFu) >> 4) << 16);
  const uint32_t hi = ((sbo & 0x3FFFFu) >> 4) | (3u << 30);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The value of x, hidden from the optimiser: shared-memory descriptors
// computed from it inside a tile loop stay there, instead of being hoisted
// out of it and held in registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (before it starts and after it is waited for).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two fp32 values as one register of two 16-bit values, the first in the
// low half (the order of a wgmma A fragment).
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN accumulator fragment (N/2 fp32 registers a thread) as the wgmma
// A fragments of its K = N/16 k16 steps, rounded to T: the layouts agree
// (see Wgmma below), so a product's output feeds the next product from
// registers, as P feeds P V in attention.
template <typename T, int K>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[K][4], const float (&d)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack2<T>(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// wgmma.mma_async m64nNk16 with an fp32 accumulator d of N/2 registers a
// thread: Wgmma<N, T>::ss<TRANS_B, TRANS_A>(d, desc_a, desc_b, scale_d)
// reads A and B from shared memory; ::rs reads A from four registers a
// thread.  TRANS_B = 1 reads B as MN-major, TRANS_A = 1 (ss only; 0 by
// default) reads A as MN-major, else each is K-major.  scale_d = 0
// overwrites d, 1 accumulates.  Accumulator layout (thread t of the
// warpgroup, warp w = t / 32, lane l): d[4j + 2i + c] holds row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c.  A fragment: a[0] rows l/4,
// k 2(l%4)..+1; a[1] row +8; a[2] and a[3] the same at k + 8.
template <int N, typename T> struct Wgmma;

#define HOPPER_ACC32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_ACC32_OPS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_ACC64_OPS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_ACC128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define HOPPER_ACC128_OPS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define HOPPER_WGMMA_64(CTYPE, TY) \
  template <> struct Wgmma<64, CTYPE> { \
    template <int TRANS_B, int TRANS_A = 0> \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, \
                                              int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                   HOPPER_ACC32 ", %32, %33, p, 1, 1, %36, %35;\n}\n" \
                   : HOPPER_ACC32_OPS(d) \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A)); \
    } \
    template <int TRANS_B> \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], \
                                              uint64_t b, int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                   HOPPER_ACC32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
                   : HOPPER_ACC32_OPS(d) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), \
                     "n"(TRANS_B)); \
    } \
  };
#define HOPPER_WGMMA_128(CTYPE, TY) \
  template <> struct Wgmma<128, CTYPE> { \
    template <int TRANS_B, int TRANS_A = 0> \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, \
                                              int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
                   HOPPER_ACC64 ", %64, %65, p, 1, 1, %68, %67;\n}\n" \
                   : HOPPER_ACC64_OPS(d) \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A)); \
    } \
    template <int TRANS_B> \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], \
                                              uint64_t b, int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
                   HOPPER_ACC64 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
                   : HOPPER_ACC64_OPS(d) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), \
                     "n"(TRANS_B)); \
    } \
  };
#define HOPPER_WGMMA_256(CTYPE, TY) \
  template <> struct Wgmma<256, CTYPE> { \
    template <int TRANS_B, int TRANS_A = 0> \
    static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b, \
                                              int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
                   HOPPER_ACC128 ", %128, %129, p, 1, 1, %132, %131;\n}\n" \
                   : HOPPER_ACC128_OPS(d) \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A)); \
    } \
    template <int TRANS_B> \
    static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], \
                                              uint64_t b, int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
                   HOPPER_ACC128 ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
                   : HOPPER_ACC128_OPS(d) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), \
                     "n"(TRANS_B)); \
    } \
  };

HOPPER_WGMMA_64(__nv_bfloat16, "bf16")
HOPPER_WGMMA_64(__half, "f16")
HOPPER_WGMMA_128(__nv_bfloat16, "bf16")
HOPPER_WGMMA_128(__half, "f16")
HOPPER_WGMMA_256(__nv_bfloat16, "bf16")
HOPPER_WGMMA_256(__half, "f16")

#define HOPPER_ACC8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_ACC8_OPS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define HOPPER_WGMMA_16(CTYPE, TY) \
  template <> struct Wgmma<16, CTYPE> { \
    template <int TRANS_B, int TRANS_A = 0> \
    static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, \
                                              int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
                   HOPPER_ACC8 ", %8, %9, p, 1, 1, %12, %11;\n}\n" \
                   : HOPPER_ACC8_OPS(d) \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A)); \
    } \
    template <int TRANS_B> \
    static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], \
                                              uint64_t b, int scale_d) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
                   HOPPER_ACC8 ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n" \
                   : HOPPER_ACC8_OPS(d) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), \
                     "n"(TRANS_B)); \
    } \
  };

HOPPER_WGMMA_16(__nv_bfloat16, "bf16")
HOPPER_WGMMA_16(__half, "f16")

// Head dim 80 (the layout note at the top): a tile of ROWS rows is a
// 128-byte-swizzled box of columns 0-63 (ROWS x 128 bytes) followed by a
// 32-byte-swizzled box of columns 64-79 (ROWS x 32 bytes).
namespace d80 {
constexpr int ROW_BYTES = 160;

// Loads rows [row, row + ROWS) of plane z of a (80, rows, planes) array into
// the tile at dst: `wide` reads boxes of (64, ROWS) with the 128-byte swizzle,
// `narrow` boxes of (16, ROWS) with the 32-byte swizzle.
template <int ROWS>
__device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* wide,
                                     const CUtensorMap* narrow, uint64_t* bar, int row, int z) {
  tma_load_3d(dst, wide, bar, 0, row, z);
  tma_load_3d(dst + ROWS * 128, narrow, bar, 64, row, z);
}

// The K-major descriptor of k16 step kk (columns 16kk .. 16kk+15) of the
// 64 rows from row r0 of a ROWS-row tile at shared address base.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int r0, int kk) {
  return kk < 4 ? desc_sw128(base + r0 * 128 + kk * 32, 16, 1024)
                : desc_sw32(base + ROWS * 128 + r0 * 32, 16, 256);
}

// d (an m64n80 fp32 accumulator: d[4j + 2i + c] is column 8j + ...) +=
// A x the tile's rows 16kk .. 16kk+15 as the MN-major B operand (K = the
// tile's rows, N = its 80 columns), A from registers (rs) or a descriptor
// (ss, TRANS_A as Wgmma::ss): an m64n64k16 on the wide box and an m64n16k16
// on the narrow one.
template <typename T, int ROWS>
__device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint32_t base, int kk,
                                   int scale_d) {
  Wgmma<64, T>::template rs<1>(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                               desc_sw128(base + kk * 2048, ROWS * 128, 1024), scale_d);
  Wgmma<16, T>::template rs<1>(*reinterpret_cast<float(*)[8]>(&d[32]), a,
                               desc_sw32(base + ROWS * 128 + kk * 512, ROWS * 32, 256), scale_d);
}
template <typename T, int ROWS, int TRANS_A>
__device__ __forceinline__ void ss(float (&d)[40], uint64_t a, uint32_t base, int kk,
                                   int scale_d) {
  Wgmma<64, T>::template ss<1, TRANS_A>(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                                        desc_sw128(base + kk * 2048, ROWS * 128, 1024), scale_d);
  Wgmma<16, T>::template ss<1, TRANS_A>(*reinterpret_cast<float(*)[8]>(&d[32]), a,
                                        desc_sw32(base + ROWS * 128 + kk * 512, ROWS * 32, 256),
                                        scale_d);
}
}  // namespace d80

// ------------------------------------------- bulk copies and turns across blocks
//
// A bulk copy or fp32 add of `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from shared to global memory, in this thread's
// bulk group (bulk_commit, bulk_wait above).  The add is done in L2, so
// blocks that take turns at one buffer add in the order of their turns.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
// Orders this thread's global accesses through the generic proxy against its
// bulk copies (the async proxy), both ways.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// A counter in global memory that blocks take turns by: read with acquire
// semantics at GPU scope, and added to with release semantics.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first use
// so that the library needs no -lcuda.
inline cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A tensor map over a 3-D array of extents (n0 innermost, n1, n2) whose dims
// 1 and 2 lie s1 and s2 bytes apart, read in boxes of (box0, box1, 1); reads
// past an edge fill zeros.  Encoded on the host at every launch (a few
// microseconds, against kernels of tens of microseconds and more).  TMA
// needs a 16-byte-aligned base, s1, s2 and box0 times the element size
// multiples of 16 bytes, and box0, box1 <= 256.
inline cudaError_t encode_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                             uint64_t n0, uint64_t n1, uint64_t n2, uint64_t s1, uint64_t s2,
                             uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  // The encoding needs a current context.  A thread that has made no CUDA
  // call yet has none (autograd's worker, when the first node of a backward
  // is a kernel of this repo): cudaSetDevice makes the device's primary
  // context current (CUDA 12), without a synchronisation.
  int device;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous 16-bit array read in boxes of (box0, box1, 1) with the given
// swizzle (head dim 80: (64, R) with the 128-byte swizzle and (16, R) with
// the 32-byte one; see d80).
inline cudaError_t make_map_3d_box(CUtensorMap* map, const void* base, bool bf16, uint64_t n0,
                                   uint64_t n1, uint64_t n2, uint32_t box0, uint32_t box1,
                                   CUtensorMapSwizzle swizzle) {
  return encode_3d(map, base,
                   bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                   n0, n1, n2, n0 * 2, n0 * n1 * 2, box0, box1, swizzle);
}

// The tensor-core kernels' map: boxes of (64, box1, 1) with the 128-byte
// swizzle (the layout convention above).
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, bool bf16, uint64_t n0,
                               uint64_t n1, uint64_t n2, uint32_t box1) {
  return make_map_3d_box(map, base, bf16, n0, n1, n2, 64, box1, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The two maps of an (n0, n1, n2) array, n0 = 80 or 72, for d80::load: the
// wide one (64-column boxes, 128-byte swizzle) and the narrow one (16-column,
// 32-byte swizzle; at n0 = 72 its last 8 columns are zeros).
inline cudaError_t make_maps_d80(CUtensorMap* wide, CUtensorMap* narrow, const void* base,
                                 bool bf16, uint64_t n0, uint64_t n1, uint64_t n2, uint32_t rows) {
  cudaError_t err =
      make_map_3d_box(wide, base, bf16, n0, n1, n2, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  return make_map_3d_box(narrow, base, bf16, n0, n1, n2, 16, rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

// An unswizzled map of fp32 (elem_bytes 4) or bf16 / fp16 values: a box
// lands in shared memory as box1 rows of box0 values.
inline cudaError_t make_map_3d_plain(CUtensorMap* map, const void* base, int elem_bytes,
                                     bool bf16, uint64_t n0, uint64_t n1, uint64_t n2,
                                     uint64_t s1, uint64_t s2, uint32_t box0, uint32_t box1) {
  const CUtensorMapDataType type = elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : bf16          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode_3d(map, base, type, n0, n1, n2, s1, s2, box0, box1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
