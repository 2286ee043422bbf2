"""Builds variants of the head-dim-80 attention kernels (the forward's
``flash_attention_d80_wgmma_kernel`` and the backward's
``dkdv_d80_wgmma_kernel``) and times them in turns on one CUDA card, at
hubert-xlarge's shapes (bf16, H = KV = 16, D = 80, unmasked):

    python3 tools/attn80_variants.py [OUT_DIR [NAME ...]]

Each variant is ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``
and ``csrc/hopper.cuh`` with a few lines replaced (VARIANTS: what each one
changes), both sources built with ``kernels._build``'s flags into OUT_DIR
(default ``build/attn80_variants``; with NAMEs, only those and the
default) and called through the kernels' C entry points.  Every variant but the ablations (``abl_``: timed only, their dq is
wrong) is first held to the plain versions (the forward within the bf16
bar of ``ref_flash_attention``, dq, dk and dv within 2e-2 of the largest
gradient of autograd of it in fp32) and to its own bits on a second
launch, and its registers and spills are read from ptxas.  Then each case
(CASES: the forward at the training shape, B = 4 x 4096, and at the
serving one, 4 x 1000; the backward at the training shape; two small
phase-3 shapes by their kernels' device time) is timed (CUDA events or
``torch.profiler``, ITERS calls a sample) in ROUNDS rounds, each round in a
shuffled order; the median and the least are printed with the card's
``nvidia-smi`` name and power limit (``tools/kernel_variants.py`` builds
and turns).
"""

from __future__ import annotations

import ctypes
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_variants as kv  # noqa: E402

ROOT = kv.ROOT
FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"
SOURCES = ("hopper.cuh", FWD, BWD)
FWD_BK = "constexpr int BK = 128;       // keys per k/v tile"
FWD_STAGES = "constexpr int STAGES = 2;     // k and v tiles in the ring"
NARROW_SECOND = """  tma_load_3d(dst, wide, bar, 0, row, z);
  tma_load_3d(dst + ROWS * 128, narrow, bar, 64, row, z);"""
NARROW_FIRST = """  tma_load_3d(dst + ROWS * 128, narrow, bar, 64, row, z);
  tma_load_3d(dst, wide, bar, 0, row, z);"""
BWD_STAGES = "constexpr int STAGES = 2;  // (Q, dO) tiles in the ring"
TURNS = ('''__device__ __forceinline__ void take_turn(int warpgroup) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + warpgroup) : "memory");
}
__device__ __forceinline__ void pass_turn(int warpgroup) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - warpgroup) : "memory");
}
}  // namespace wg80''')
NO_TURNS = ('''__device__ __forceinline__ void take_turn(int) {}
__device__ __forceinline__ void pass_turn(int) {}
}  // namespace wg80''')

DS_STORE = """          hopper::mbar_wait(&ds_empty[i % 2], ((i / 2) & 1) ^ 1);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kr = 64 * warpgroup + 16 * warp + lane / 4 + 8 * (e % 2);
              const int chunk = 2 * kk + e / 2;  // the queries' 8-column group
              *reinterpret_cast<uint32_t*>(ds_tile + kr * 128 + ((chunk ^ (kr % 8)) * 16) +
                                           col0 * 2) = da[kk][e];
            }
"""
DV_DK = ("""#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)  // 16 queries, 16 rows of the tiles, a step
            d80::rs<T, BN>(dv_acc, pa[kk], dos, kk, 1);
""", """          hopper::wgmma_commit();
        }
        // This warpgroup's half""")
DV_DK_INTERLEAVED = DS_STORE + """#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            d80::rs<T, BN>(dv_acc, pa[kk], dos, kk, 1);
            d80::rs<T, BN>(dk_acc, da[kk], qs, kk, 1);
          }
"""
SDP = ("""#pragma unroll
          for (int kk = 0; kk < 5; ++kk)
            hopper::Wgmma<BN, T>::template ss<0>(st, d80::kmajor<BM>(kw, 64 * warpgroup, kk),""",
       """          hopper::wgmma_wait<1>();  // S^T is in: P^T is computed while dP^T runs
""")
SDP_ONE_GROUP = """#pragma unroll
          for (int kk = 0; kk < 5; ++kk) {
            hopper::Wgmma<BN, T>::template ss<0>(st, d80::kmajor<BM>(kw, 64 * warpgroup, kk),
                                                 d80::kmajor<BN>(qs, 0, kk), kk > 0);
            hopper::Wgmma<BN, T>::template ss<0>(dpt, d80::kmajor<BM>(vw, 64 * warpgroup, kk),
                                                 d80::kmajor<BN>(dos, 0, kk), kk > 0);
          }
          hopper::wgmma_commit();
          wg::pass_turn(warpgroup);
          hopper::wgmma_wait<0>();
"""


def _const(line: str, value: int) -> tuple[str, str]:
    return line, re.sub(r"= \d+;", f"= {value};", line)


# name: (what it changes, [(old, new), ...]).
VARIANTS = {
    "default": ("the kernels as they are: forward 128-key tiles in a ring of 2, products on a "
                "64-column 128-byte-swizzled box and a 16-column 32-byte one; backward dQ in "
                "turns, (Q, dO) ring of 2", []),
    "fwd_stages3": ("forward: a ring of 3 k and v tiles", [_const(FWD_STAGES, 3)]),
    "fwd_stages4": ("forward: a ring of 4 k and v tiles", [_const(FWD_STAGES, 4)]),
    "fwd_bk64_stages4": ("forward: 64-key tiles, a ring of 4",
                         [_const(FWD_BK, 64), _const(FWD_STAGES, 4)]),
    "fwd_bk64": ("forward: 64-key tiles, a ring of 2", [_const(FWD_BK, 64)]),
    "narrow_first": ("both: each tile's 16-column box loaded before its 64-column one",
                     [(NARROW_SECOND, NARROW_FIRST)]),
    "fwd_no_pingpong": ("forward: the two consumers issue their products without turns",
                        [(TURNS, NO_TURNS)]),
    "bwd_stages3": ("backward: a (Q, dO) ring of 3", [_const(BWD_STAGES, 3)]),
    "bwd_interleave": ("backward: dS^T stored before dV's product, then dV's and dK's k16 "
                       "steps interleaved (two accumulator chains in flight)",
                       [(DV_DK, DV_DK_INTERLEAVED)]),
    "bwd_sdp_one_group": ("backward: S^T's and dP^T's k16 steps interleaved in one group (P^T "
                          "waits for both)", [(SDP, SDP_ONE_GROUP)]),
    # Ablations, timed only (their dq is wrong): what each part of the
    # backward's dQ in turns costs.
    "abl_no_turns": ("backward, timing only: the writers add without waiting for their turns",
                     [("            while (hopper::ld_acquire(counter) != turn) {\n            }\n",
                       "")]),
    "abl_no_adds": ("backward, timing only: the writers take their turns but copy and add "
                    "nothing", [(("            if (turn == 0)\n              hopper::bulk_store(",
                                  "            hopper::fence_async_global();\n"), "")]),
    "abl_no_dq_product": ("backward, timing only: no dQ = dS K product (its partials unset)",
                          [(("  for (int kk = 0; kk < BM / 16; ++kk)  // 16 keys, 16 rows of dS^T "
                             "and K", "  hopper::wgmma_commit();"), "")]),
}
# (label, kernel, B, H, KV, S, causal): hubert-xlarge's training and serving
# shapes, then two small ones of chip_smoke.py's phase 3, timed by their
# kernels' device time (torch.profiler), which the host's launches would
# otherwise hide.
CASES = (("forward B=4 S=4096", "fwd", 4, 16, 16, 4096, False),
         ("forward B=4 S=1000", "fwd", 4, 16, 16, 1000, False),
         ("backward B=4 S=4096", "bwd", 4, 16, 16, 4096, False),
         ("forward B=4 S=127 causal, device", "fwd", 4, 16, 16, 127, True),
         ("backward B=2 H=16 KV=4 S=1000 causal, device", "bwd", 2, 16, 4, 1000, True))
D = 80
ROUNDS, ITERS = 5, 10


def texts(name: str) -> dict[str, str]:
    """The kernels' sources with the variant's lines replaced, and the header
    they include, or raises if a line to replace is missing."""
    return kv.edited(SOURCES, VARIANTS[name][1], f"attn80_variants: {name}")


def ptxas(out_dir: Path, name: str) -> str:
    """The variant's registers and spills of its D = 80 bf16 kernels."""
    got = []
    for main, base in ((FWD, "flash_attention_d80_wgmma_kernel"), (BWD, "dkdv_d80_wgmma_kernel")):
        text = (out_dir / name / f"ptxas_{Path(main).stem}.txt").read_text()
        m = re.search(base + r"I13__nv_bfloat16.*?\n(.*?spill loads)\n.*?Used (\d+) registers",
                      text, re.S)
        if m:
            got.append(f"{base} {m.group(2)} registers, {m.group(1).strip()}")
    return "; ".join(got)


def build(out_dir: Path, name: str) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """The variant's forward and backward libraries (one nvcc each)."""
    variant = texts(name)
    libs = []
    for main in (FWD, BWD):
        libs.append(kv.build(out_dir, name, variant, main))
        (out_dir / name / "ptxas.txt").replace(out_dir / name / f"ptxas_{Path(main).stem}.txt")
    return tuple(libs)


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.kernels.ref import ref_flash_attention

    if not torch.cuda.is_available():
        raise SystemExit("attn80_variants: no CUDA device")
    out_dir = Path(argv[0]) if argv else ROOT / "build" / "attn80_variants"
    names = ["default", *(n for n in argv[1:] if n != "default")] if argv[1:] else list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(out_dir, n), names)))
    card = kv.card()
    print(f"attn80_variants on {card}: " + "; ".join(f"{n}: {v[0]}" for n, v in VARIANTS.items()))
    for name in names:
        print(f"{name}: {ptxas(out_dir, name)}", flush=True)
    dev = torch.device("cuda")
    sms = sm_count(0)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fwd, bwd in libs.values():
        fwd.repro_flash_attention_wgmma.argtypes = [p] * 5 + [i] * 9 + [p]
        bwd.repro_flash_attention_bwd_wgmma.argtypes = [p] * 11 + [i] * 10 + [p]
        bwd.repro_flash_attention_bwd_workspace.argtypes = [i] * 7
        bwd.repro_flash_attention_bwd_workspace.restype = ctypes.c_longlong

    def forward(lib, q, k, v, o, lse, causal):
        B, Hq, Sq, _ = q.shape
        err = lib[0].repro_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Hq,
            k.shape[1], Sq, k.shape[2], D, int(causal), 0, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attn80_variants: forward CUDA error {err}")

    def backward(lib, q, k, v, o, lse, do, grads, causal):
        B, Hq, Sq, _ = q.shape
        KV, Sk = k.shape[1], k.shape[2]
        n = lib[1].repro_flash_attention_bwd_workspace(B, Hq, KV, Sq, Sk, D, sms)
        work = torch.empty(max(n, 4) // 4, device=dev)
        delta = torch.empty(B, Hq, Sq, device=dev)
        err = lib[1].repro_flash_attention_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(), work.data_ptr(),
            B, Hq, KV, Sq, Sk, D, int(causal), 0, sms, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attn80_variants: backward CUDA error {err}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, Hq, KV, Sq, Sk):
        q, do = (torch.randn(B, Hq, Sq, D, generator=gen, device=dev).bfloat16() for _ in "qd")
        k, v = (torch.randn(B, KV, Sk, D, generator=gen, device=dev).bfloat16() for _ in "kv")
        return q, k, v, do

    for B, Hq, KV, Sq, Sk, causal in ((2, 16, 16, 1000, 1000, False), (1, 8, 2, 300, 300, True),
                                      (1, 4, 4, 1000, 777, False)):
        q, k, v, do = inputs(B, Hq, KV, Sq, Sk)
        want_o = ref_flash_attention(q, k, v, causal=causal)
        qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(ref_flash_attention(qf, kf, vf, causal=causal), (qf, kf, vf),
                                   do.float())
        for name, lib in libs.items():
            if name.startswith("abl_"):
                continue
            o, lse = torch.empty_like(q), torch.empty(B, Hq, Sq, device=dev)
            forward(lib, q, k, v, o, lse, causal)
            grads = [torch.empty_like(t) for t in (q, k, v)]
            backward(lib, q, k, v, o, lse, do, grads, causal)
            o2 = torch.empty_like(o)
            forward(lib, q, k, v, o2, lse, causal)
            again = [torch.empty_like(t) for t in (q, k, v)]
            backward(lib, q, k, v, o, lse, do, again, causal)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(grads, again))):
                raise SystemExit(f"attn80_variants: {name} gives other bits on a second launch")
            ok = torch.allclose(o.float(), want_o.float(), rtol=2e-2, atol=2e-2) and all(
                float((g.float() - w).abs().max()) <= 2e-2 * float(w.abs().max())
                for g, w in zip(grads, want))
            if not ok:
                raise SystemExit(f"attn80_variants: {name} off the plain version at "
                                 f"{(B, Hq, KV, Sq, Sk, causal)}")
    for label, kind, B, H, KV, S, causal in CASES:
        q, k, v, do = inputs(B, H, KV, S, S)
        o, lse = torch.empty_like(q), torch.empty(B, H, S, device=dev)
        forward(libs["default"], q, k, v, o, lse, causal)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        if kind == "fwd":
            run = lambda lib: forward(lib, q, k, v, torch.empty_like(q), lse, causal)
        else:
            run = lambda lib: backward(lib, q, k, v, o, lse, do, grads, causal)
        timer = kv.device_ms if label.endswith("device") else kv.time_ms
        times = kv.in_turns({name: (lambda lib=lib: timer(lambda: run(lib), ITERS))
                             for name, lib in libs.items()
                             if kind == "bwd" or not name.startswith("abl_")}, ROUNDS)
        for name, ts in times.items():
            print(f"{label} {name}: median {statistics.median(ts)} ms, least {min(ts)} ms a "
                  f"launch; on {card}", flush=True)
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
