"""Builds variants of the grouped-matmul backward's wgmma kernel and times
them in turns on one CUDA card, at qwen3-moe-30b-a3b's two bf16 training
products (E = 128, C = 1280; gate/up D = 2048, F = 768, and down D = 768,
F = 2048):

    python3 tools/gmm_bwd_variants.py [OUT_DIR]

Each variant is ``csrc/moe_gmm_bwd.cu`` and ``csrc/hopper.cuh`` with a few
lines replaced (VARIANTS: what each one takes out or changes), built with
``kernels._build``'s flags into OUT_DIR (default ``build/gmm_bwd_variants``)
and called through the same C entry point as the kernel (the build, the
turns and the clock sampling are ``tools/kernel_variants.py``'s).  RUNS launches
them: the design's steps in the order they were built (persistent blocks
alone storing from each thread; + the epilogue stored by TMA; + pairs of
blocks kept in step, the kernel as it is), the kernel with one unit of work
a cluster (not persistent: the SM count passed as 1 << 20), and the
variants.  Every run that computes the same function is held to the
kernel's bits first.  Then dx and dw are timed apart (CUDA events, 10 calls
a sample) in ten rounds, each round in a shuffled order, beside
``torch.bmm`` for the same product; the median and the least of each are
printed with the card's ``nvidia-smi`` name and power limit.  Last, each run
is called back to back for SUSTAIN seconds while ``nvidia-smi`` samples the
SM clock and the power draw every 50 ms, and the medians of the samples are
printed beside that run's time a call.  The card's power limit throttles
its clock, so only times taken in one run are compared.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_variants as kv  # noqa: E402

ROOT, CSRC = kv.ROOT, kv.CSRC

# The first persistent step's epilogue: each thread stores its values.
DIRECT_STORES = """      T* oe = reinterpret_cast<T*>(out) + (size_t)e * M * N;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 16 * warp + lane / 4 + 8 * i;
        if (row >= M) continue;
        T* orow = oe + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col < N)  // N is even, so col + 1 < N too
            *reinterpret_cast<uint32_t*>(orow + col) =
                hopper::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
"""
EPILOGUE = ("      // Four 64 x 64 boxes, staged in turns",
            "    if (leader) hopper::bulk_wait<0>();\n  }\n  hopper::cluster_sync();")
DIRECT = [(EPILOGUE, DIRECT_STORES),
          ("CUtensorMap map_out, int M, int N, int K,\n                     int E) {",
           "CUtensorMap map_out, int M, int N, int K,\n                     int E, void* out) {"),
          ("&M, &N, &K, &E};", "&M, &N, &K, &E, &out};"),
          ("int E, int sms,\n                           cudaStream_t stream) {",
           "int E, int sms,\n                           cudaStream_t stream, void* out = nullptr) {"),
          ("C, D, F, E, sms, stream);", "C, D, F, E, sms, stream, dx);"),
          ("D, F, C, E, sms, stream);", "D, F, C, E, sms, stream, dw);")]
ALONE = [("  const int pair = tiles_m > 1 ? 2 : 1;\n", "  const int pair = 1;\n")]
# The design before: each block of a pair loads one 128-column half of B by
# TMA multicast into both blocks (32 KB a stage from L2 a block, not 48).
MULTICAST_LOAD = """__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One TMA store of a 3-D box"""
MULTICAST = [("// One TMA store of a 3-D box", MULTICAST_LOAD),
             ("              hopper::tma_load_3d(b + h * HALF_B + c * BK * 128, &map_b, &full[s], c0, c1, e);\n",
              "              if (pair == 1)\n"
              "                hopper::tma_load_3d(b + h * HALF_B + c * BK * 128, &map_b, &full[s], c0, c1, e);\n"
              "              else if (h == rank)\n"
              "                hopper::tma_load_3d_multicast(b + h * HALF_B + c * BK * 128, &map_b, &full[s],\n"
              "                                              c0, c1, e, 3);\n")]

# The epilogue without waits between boxes: consumer warpgroup 0 stages its
# four boxes in the ring stage its tile has just drained (held back from the
# producer until the TMA stores have read it, at the next tile's first
# k-step), warpgroup 1 in the 32 KB staging area; one barrier and four
# stores a tile each.
ARRIVE_COUNT = """__device__ __forceinline__ void mbar_arrive_count_cluster(uint64_t* bar, uint32_t cta,
                                                          uint32_t count) {
  asm volatile(
      "{\\n.reg .b32 remote;\\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote], %2;\\n}\\n" ::"r"(smem_u32(bar)),
      "r"(cta), "r"(count)
      : "memory");
}

// One TMA store of a 3-D box"""
IN_STAGE = """    // A warp's release of a stage, on both blocks of a pair.
    auto release = [&](int s) {
      if (lane != 0) return;
      if (pair == 2) {
        hopper::mbar_arrive_cluster(&empty[s], 0);
        hopper::mbar_arrive_cluster(&empty[s], 1);
      } else {
        hopper::mbar_arrive(&empty[s]);
      }
    };
    float acc[BN / 2];
    int it = 0, held = -1;
    for (int u = first; u < units; u += step) {
      int e, m0, n0;
      tile(u, e, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t a = hopper::smem_u32(smem + s * STAGE_BYTES + warpgroup * HALF_A);
        const uint32_t b = a - warpgroup * HALF_A + A_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if constexpr (DW)
            hopper::Wgmma<BN, T>::template ss<1, 1>(
                acc, hopper::desc_sw128(a + kk * 2048, BK * 128, 1024),
                hopper::desc_sw128(b + kk * 2048, BK * 128, 1024), 1);
          else
            hopper::Wgmma<BN, T>::template ss<0, 0>(
                acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                hopper::desc_sw128(b + kk * 32, 16, 1024), 1);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        hopper::wgmma_wait<1>();
        if (kt > 0) {
          release((it - 1) % STAGES);
        } else if (held >= 0) {  // the stores have read the boxes: free their stage
          if (leader) {
            hopper::bulk_wait_read<0>();
            for (int c = 0; c < pair; ++c) hopper::mbar_arrive_count_cluster(&empty[held], c, 4);
          }
          held = -1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      const int last = (it - 1) % STAGES;
      hopper::named_barrier_sync(3, 256);  // both warpgroups are done with the last stage
      uint8_t* boxes;
      if (warpgroup == 0) {
        boxes = smem + last * STAGE_BYTES;
        held = last;
      } else {
        release(last);
        boxes = staged;
        if (leader) hopper::bulk_wait_read<0>();
        hopper::named_barrier_sync(2, 128);
      }

      const int row0 = m0 + 64 * warpgroup;
      if (row0 >= M) continue;
#pragma unroll
      for (int bx = 0; bx < BN / 64; ++bx) {
        if (n0 + 64 * bx >= N) break;
        uint8_t* box = boxes + bx * OUT_BOX;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint8_t* row = box + (16 * warp + lane / 4 + 8 * i) * 128 + 4 * (lane % 4);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * bx + jj;
            *reinterpret_cast<uint32_t*>(row + ((jj ^ (lane / 4)) << 4)) =
                hopper::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
        }
      }
      hopper::fence_async_shared();
      hopper::named_barrier_sync(1 + warpgroup, 128);
      if (leader) {
        for (int bx = 0; bx < BN / 64 && n0 + 64 * bx < N; ++bx)
          hopper::tma_store_3d(&map_out, boxes + bx * OUT_BOX, n0 + 64 * bx, row0, e);
        hopper::bulk_commit();
      }
    }
"""
EPILOGUE_IN_STAGE = [("// One TMA store of a 3-D box", ARRIVE_COUNT),
                     (("    // A warp's release of a stage, on both blocks of a pair.",
                       "    if (leader) hopper::bulk_wait<0>();\n  }\n  hopper::cluster_sync();"),
                      IN_STAGE),
                     ("    uint8_t* boxes = staged + warpgroup * 2 * OUT_BOX;  // this warpgroup's two buffers\n",
                      "")]

# name: (what it measures, computes the kernel's function, [(old, new), ...]);
# a pair EPILOGUE stands for the source between those two lines.
VARIANTS = {
    "default": ("the kernel as it is: pairs in step, each block loading all of B", True, []),
    "alone": ("blocks alone, walking the same tiles in the same order", True, ALONE),
    "alone_direct_stores": (
        "blocks alone, the epilogue stored from each thread's registers, no TMA store", True,
        ALONE + DIRECT),
    "multicast": ("pairs sharing each stage's B box by TMA multicast (the design before)", True,
                  MULTICAST),
    "n_fastest": (
        "pairs walking each expert's units with the N tile fastest instead of M", True,
        [("    m0 = ((r % pairs_m) * pair + rank) * BM;\n    n0 = (r / pairs_m) * BN;\n",
          "    m0 = ((r / ((N + BN - 1) / BN)) * pair + rank) * BM;\n"
          "    n0 = (r % ((N + BN - 1) / BN)) * BN;\n")]),
    "release_cluster_arrive": (
        "the pair's remote arrive with .release.cluster semantics", True,
        [('"mbarrier.arrive.shared::cluster.b64 _, [remote];\\n}\\n"',
          '"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\\n}\\n"')]),
    "three_stages": ("a ring of 3 stages instead of 4", True,
                     [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
    "epilogue_skipped": (
        "the epilogue skipped at run time (K > 0) but kept in the code, so that the "
        "accumulators stay live and the math is not cut", False,
        [("      if (row0 >= M) continue;", "      if (row0 >= M || K > 0) continue;")]),
    "epilogue_in_stage": (
        "the epilogue with no waits between boxes: warpgroup 0's boxes in the stage just "
        "drained, warpgroup 1's in the staging area", True, EPILOGUE_IN_STAGE),
    "stores_cut": (
        "the epilogue written to shared memory but never stored: its TMA stores cut", False,
        [("          hopper::tma_store_3d(&map_out, box, n0 + 64 * bx, row0, e);\n", "")]),
    "loads_cut": (
        "the ring filled once, then no loads: the tile loop's math and epilogue alone", False,
        [("          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);\n",
          "          if (it >= STAGES) {\n"
          "            hopper::mbar_arrive(&full[s]);\n"
          "            continue;\n"
          "          }\n"
          "          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);\n")]),
}
ONE_EACH = 1 << 20  # an SM count that gives every unit of work its own cluster
# (label, variant, one unit of work a cluster)
RUNS = (("step 1: persistent, blocks alone, each thread stores", "alone_direct_stores", False),
        ("step 2: + the epilogue stored by TMA (blocks alone)", "alone", False),
        ("step 3: + pairs kept in step (the kernel)", "default", False),
        ("the kernel, one unit of work a cluster", "default", True),
        ("pairs sharing B by multicast", "multicast", False),
        ("pairs walking N fastest", "n_fastest", False),
        ("remote arrive .release.cluster", "release_cluster_arrive", False),
        ("a ring of 3 stages", "three_stages", False),
        ("the epilogue staged in the drained stage", "epilogue_in_stage", False),
        ("the TMA stores cut", "stores_cut", False),
        ("the epilogue skipped", "epilogue_skipped", False),
        ("loads cut after the ring's first fill", "loads_cut", False))
SHAPES = (("gate_up", 128, 1280, 2048, 768), ("down", 128, 1280, 768, 2048))
ROUNDS, ITERS, SUSTAIN = 10, 10, 1.5


def edited(name: str) -> tuple[str, str]:
    """``hopper.cuh`` and ``moe_gmm_bwd.cu`` with the variant's lines
    replaced, or raises if a line to replace is missing."""
    texts = kv.edited(("hopper.cuh", "moe_gmm_bwd.cu"), VARIANTS[name][2],
                      f"gmm_bwd_variants: {name}")
    return texts["hopper.cuh"], texts["moe_gmm_bwd.cu"]


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gmm_bwd_variants: no CUDA device")
    out_dir = Path(argv[0]) if argv else ROOT / "build" / "gmm_bwd_variants"
    libs = kv.build_all(out_dir, {n: dict(zip(("hopper.cuh", "moe_gmm_bwd.cu"), edited(n)))
                                  for n in VARIANTS}, "moe_gmm_bwd.cu")
    card = kv.card()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p, i = ctypes.c_void_p, ctypes.c_int

    def call(lib, x, w, dy, dx, dw, need_dx, need_dw, one_each):
        E, C, D = x.shape
        F = w.shape[2]
        fn = lib.repro_moe_gmm_bwd_wgmma
        fn.argtypes = [p] * 5 + [i] * 8 + [p]
        fn.restype = i
        err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), E, C,
                 D, F, need_dx, need_dw, 2, ONE_EACH if one_each else sms,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gmm_bwd_variants: CUDA error {err}")

    def time_ms(fn):
        return kv.time_ms(fn, ITERS)

    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gmm_bwd_variants on {card}: " + "; ".join(f"{n}: {v[0]}" for n, v in VARIANTS.items()))
    runs = [("torch.bmm", None, False)] + list(RUNS)
    smi = kv.Smi(out_dir / "smi.csv")
    sustained = []  # (shape, run, ms a call, t0, t1)
    try:
        for label, E, C, D, F in SHAPES:
            x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
            w = (torch.randn(E, D, F, generator=gen, device=dev) / D**0.5).bfloat16()
            dy = torch.randn(E, C, F, generator=gen, device=dev).bfloat16()
            dx, dw = torch.empty_like(x), torch.empty_like(w)
            call(libs["default"], x, w, dy, dx, dw, 1, 1, False)
            want = dx.clone(), dw.clone()
            for run, name, one_each in RUNS:
                if VARIANTS[name][1]:
                    dx.zero_(), dw.zero_()
                    call(libs[name], x, w, dy, dx, dw, 1, 1, one_each)
                    if not (torch.equal(dx, want[0]) and torch.equal(dw, want[1])):
                        raise SystemExit(f"gmm_bwd_variants: {run} changed the bits")

            def timed(name, one_each):
                if name is None:
                    return (time_ms(lambda: torch.bmm(dy, w.transpose(1, 2))),
                            time_ms(lambda: torch.bmm(x.transpose(1, 2), dy)))
                lib = libs[name]
                return (time_ms(lambda: call(lib, x, w, dy, dx, dw, 1, 0, one_each)),
                        time_ms(lambda: call(lib, x, w, dy, dx, dw, 0, 1, one_each)))

            times = kv.in_turns({run: (lambda n=name, o=one_each: timed(n, o))
                                 for run, name, one_each in runs}, ROUNDS)
            for run, ts in sorted(times.items()):
                dx_ms = statistics.median(t[0] for t in ts)
                dw_ms = statistics.median(t[1] for t in ts)
                print(f"{label} {run}: median dx_ms {dx_ms} dw_ms {dw_ms} sum {dx_ms + dw_ms}; "
                      f"least dx_ms {min(t[0] for t in ts)} dw_ms {min(t[1] for t in ts)}; "
                      f"on {card}", flush=True)
            for run, name, one_each in runs:  # back to back, for the clock and the power
                if run == "torch.bmm":
                    def both():
                        torch.bmm(dy, w.transpose(1, 2))
                        torch.bmm(x.transpose(1, 2), dy)
                else:
                    def both(lib=libs[name], one_each=one_each):
                        call(lib, x, w, dy, dx, dw, 1, 1, one_each)
                sustained.append((label, run, *kv.sustained(both, SUSTAIN)))
            del x, w, dy, dx, dw, want
            torch.cuda.empty_cache()
    finally:
        smi.stop()
    for label, run, ms, t0, t1 in sustained:
        mhz, watts, n = smi.between(t0, t1)
        print(f"{label} {run}: sustained {ms} ms a call (dx and dw); SM clock median {mhz} MHz, "
              f"power draw median {watts} W over {n} samples; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
