"""Builds variants of the Mamba scan's backward kernel and times them in turns
on one CUDA card, at falcon-mamba-7b's training shape (B = 4, L = 4096,
DI = 8192, ST = 16, b and c strided as the layer makes them), in bf16 and
fp32:

    python3 tools/scan_bwd_variants.py [OUT_DIR]

Each variant is ``csrc/mamba_scan_bwd.cu`` with a few lines replaced
(VARIANTS: what each one changes), built with ``kernels._build``'s flags into
OUT_DIR (default ``build/scan_bwd_variants``) and called through the same C
entry point as the kernel, on the checkpoints of the repo's forward kernel
(``mamba_scan(..., checkpoints=True)``).  Every variant is first held to the
plain version (``ref_mamba_scan_bwd``) at the bars of ``chip_smoke.py``'s
``check_mamba_bwd``, and its registers and spills are read from ptxas.
Then each is timed (CUDA events, 10 calls a sample) in ROUNDS rounds, each
round in a shuffled order; the median and the least are printed with the
card's ``nvidia-smi`` name and power limit; last, each is called back to
back for SUSTAIN seconds while ``nvidia-smi`` samples the SM clock and the
power draw (``tools/kernel_variants.py`` builds, turns and samples).  The
count of each SASS opcode in the bf16 kernel at ST = 16 (``cuobjdump``) is
printed beside it, a chunk's loop being unrolled in the source.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_variants as kv  # noqa: E402

ROOT = kv.ROOT
SOURCE = "mamba_scan_bwd.cu"
TWO_BLOCKS = ("LPC == 4 ? 4 : 2)  // 4 blocks an SM", "LPC == 4 ? 2 : 2)  // 2 blocks an SM")
LOAD2 = ("  const float2 q = *reinterpret_cast<const float2*>(p);\n"
         "  v[0] = q.x; v[1] = q.y;\n")
CPT4 = [("constexpr int CPT = 2;", "constexpr int CPT = 4;"),
        ("static_assert(CPT == 2,", "static_assert(CPT == 4,"),
        (LOAD2, "  const float4 q = *reinterpret_cast<const float4*>(p);\n"
                "  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;\n"),
        TWO_BLOCKS]
SUMS = [("      sum_lanes<2 * CPT, 1, 1, LPC>(pr, lane);\n", ""),
        ("      sum_lanes<2 * SPL, 1, LPC, 32>(v, lane);\n", "")]
REVERSE = ("    // The chunk backwards.  h holds h_t, the history h_{t-1}.  Unrolled by\n"
           "    // 4, not 8: fully unrolled, 128 registers spill.\n#pragma unroll 4\n")
WALK = "    // thread's column of the history first.\n#pragma unroll\n"

WALK_EXP = "          h[c][j] = fmaf(hopper::exp2_approx(dv[c] * a2[c][j]), h[c][j], dx * bv[j]);"
REVERSE_EXP = "        for (int j = 0; j < SPL; ++j) al[j] = hopper::exp2_approx(dv[c] * a2[c][j]);"

# name: (what it changes, whether it computes the kernel's function,
# [(old, new), ...]); a variant that does not is a timing of what is left.
VARIANTS = {
    "default": ("the kernel as it is: 2 channels x 4 states a thread, four blocks an SM "
                "(16 warps), the reverse steps unrolled by 4", True, []),
    "cpt4": ("4 channels x 4 states a thread: half the blocks, two an SM (8 warps)", True, CPT4),
    "threads256": ("blocks of 256 threads (128 channels), two an SM: half the db, dc partials",
                   True, [("constexpr int THREADS = 128;  // 4 warps",
                           "constexpr int THREADS = 256;"), TWO_BLOCKS]),
    "reverse_unrolled": ("the chunk's 8 reverse steps unrolled whole (it spills)", True,
                         [(REVERSE, REVERSE.replace("unroll 4\n", "unroll\n"))]),
    "walk_by_4": ("the chunk's forward steps unrolled by 4 too", True,
                  [(WALK, WALK.replace("unroll\n", "unroll 4\n"))]),
    "walk_rolled": ("the chunk's forward steps in a loop, not unrolled", True,
                    [(WALK, WALK.replace("unroll\n", "unroll 1\n"))]),
    "walk_exp_cut": ("the walk's exps cut (its decay is dt A log2 e itself)", False,
                     [(WALK_EXP, WALK_EXP.replace("hopper::exp2_approx(dv[c] * a2[c][j])",
                                                  "dv[c] * a2[c][j]"))]),
    "reverse_exp_cut": ("the reverse steps' exps cut", False,
                        [(REVERSE_EXP, REVERSE_EXP.replace("hopper::exp2_approx(dv[c] * a2[c][j])",
                                                           "dv[c] * a2[c][j]"))]),
    "sums_cut": ("no sums over lanes: each lane writes its own db, dc and dx, ddt terms", False,
                 SUMS),
    "selects_cut": ("the sums' exchanges without their selects: every lane sends the upper "
                    "half and keeps the lower", False,
                    [("    const float send = up ? v[i] : v[i + H];\n"
                      "    const float keep = up ? v[i + H] : v[i];\n",
                      "    const float send = v[i + H];\n    const float keep = v[i];\n")]),
    "shuffles_cut": ("the sums' halving exchanges without their shuffles (each lane adds "
                     "its own other half)", False,
                     [("    v[i] = keep + __shfl_xor_sync(FULL, send, M);\n",
                       "    v[i] = keep + send;\n")]),
    "cpt4_sums_cut": ("4 channels a thread, no sums over lanes", False, CPT4 + SUMS),
}
SHAPES = (("training bf16", 4, 4096, 8192, 16, 256, "bfloat16"),
          ("training fp32", 4, 4096, 8192, 16, 256, "float32"))
ROUNDS, ITERS, SUSTAIN = 7, 10, 1.5
NAMES = ("dxc", "ddt", "da", "db", "dc", "dd")


def texts(name: str) -> dict[str, str]:
    """``mamba_scan_bwd.cu`` with the variant's lines replaced, and the header
    it includes, or raises if a line to replace is missing."""
    return kv.edited(("hopper.cuh", SOURCE), VARIANTS[name][2], f"scan_bwd_variants: {name}")


def edited(name: str) -> str:
    """``mamba_scan_bwd.cu`` with the variant's lines replaced."""
    return texts(name)[SOURCE]


def ptxas(out_dir: Path, name: str) -> str:
    """The variant's registers and spills of its bf16 kernel at ST = 16."""
    text = (out_dir / name / "ptxas.txt").read_text()
    m = re.search(r"mamba_bwd_kernelI13__nv_bfloat16Li4EE.*?\n(.*?spill loads)\n.*?Used (\d+) "
                  r"registers", text, re.S)
    return f"{m.group(2)} registers, {m.group(1).strip()}" if m else "not found"


def sass_counts(out_dir: Path, name: str) -> str:
    """SASS opcodes of the variant's bf16 kernel at ST = 16, most frequent
    first (``cuobjdump`` of its library)."""
    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(out_dir / name / "libmamba_scan_bwd.so")],
                          capture_output=True, text=True).stdout
    body = sass.split("mamba_bwd_kernelI13__nv_bfloat16Li4EE", 1)[-1].split("Function :", 1)[0]
    ops = Counter(m.group(1).split(".")[0]
                  for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                                       body))
    return f"{sum(ops.values())} instructions: " + ", ".join(f"{k} {v}" for k, v in
                                                            ops.most_common(14))


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ref import ref_mamba_scan_bwd

    if not torch.cuda.is_available():
        raise SystemExit("scan_bwd_variants: no CUDA device")
    out_dir = Path(argv[0]) if argv else ROOT / "build" / "scan_bwd_variants"
    libs = kv.build_all(out_dir, {n: texts(n) for n in VARIANTS}, SOURCE)
    card = kv.card()
    print(f"scan_bwd_variants on {card}: " + "; ".join(f"{n}: {v[0]}" for n, v in VARIANTS.items()))
    for name in VARIANTS:
        print(f"{name}: {ptxas(out_dir, name)}; {sass_counts(out_dir, name)}", flush=True)
    dev = torch.device("cuda")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def call(lib, args, dy, ckpt, outs):
        xc, dt, a, b, c, d = args
        B, L, DI = xc.shape
        ST = a.shape[1]
        fn, ws = lib.repro_mamba_scan_bwd, lib.repro_mamba_scan_bwd_workspace
        fn.argtypes = [p] * 16 + [i] * 4 + [q] * 4 + [i, p]
        fn.restype = i
        ws.argtypes = [i] * 4
        ws.restype = q
        work = torch.empty(ws(B, L, DI, ST), dtype=torch.uint8, device=dev)
        err = fn(*(t.data_ptr() for t in (xc, dt, a, b, c, d, dy)), 0, ckpt.data_ptr(),
                 *(t.data_ptr() for t in outs), work.data_ptr(), B, L, DI, ST, b.stride(0),
                 b.stride(1), c.stride(0), c.stride(1), DTYPE_CODES[xc.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"scan_bwd_variants: CUDA error {err}")

    gen = torch.Generator(device=dev).manual_seed(0)
    smi = kv.Smi(out_dir / "smi.csv")
    sustained = []
    try:
        for label, B, L, DI, ST, R, dtype in SHAPES:
            dtype = getattr(torch, dtype)
            xc = torch.randn(B, L, DI, generator=gen, device=dev).to(dtype)
            dt = torch.rand(B, L, DI, generator=gen, device=dev) * 0.099 + 0.001
            a = -torch.arange(1, ST + 1, dtype=torch.float32, device=dev).repeat(DI, 1)
            xdbc = torch.randn(B, L, R + 2 * ST, generator=gen, device=dev).to(dtype)
            args = (xc, dt, a, xdbc[..., R:R + ST], xdbc[..., R + ST:],
                    torch.randn(DI, generator=gen, device=dev))
            dy = torch.randn(B, L, DI, generator=gen, device=dev)
            ckpt = mamba_scan(*args, checkpoints=True)[2]
            want = ref_mamba_scan_bwd(*args, dy)
            outs = [torch.empty_like(w) for w in want]
            for name, lib in libs.items():
                call(lib, args, dy, ckpt, outs)
                if not VARIANTS[name][1]:
                    continue
                for n, g, w in zip(NAMES, outs, want):
                    g, w = g.float(), w.float()
                    over = (g - w).abs() - 1e-4 * float(w.abs().max())
                    if n in ("dxc", "db", "dc") and dtype != torch.float32:
                        over = over - torch.finfo(dtype).eps * w.abs()
                    if float(over.max()) > 0.0:
                        raise SystemExit(f"scan_bwd_variants: {name} {n} off the plain version, "
                                         f"{label}")
            times = kv.in_turns({name: (lambda lib=lib: kv.time_ms(
                lambda: call(lib, args, dy, ckpt, outs), ITERS)) for name, lib in libs.items()},
                ROUNDS)
            for name, ts in times.items():
                print(f"{label} {name}: median {statistics.median(ts)} ms, least {min(ts)} ms a "
                      f"call; on {card}", flush=True)
            for name, lib in libs.items():
                sustained.append((label, name, *kv.sustained(
                    lambda lib=lib: call(lib, args, dy, ckpt, outs), SUSTAIN)))
            del xc, dt, xdbc, args, dy, ckpt, want, outs
            torch.cuda.empty_cache()
    finally:
        smi.stop()
    for label, name, ms, t0, t1 in sustained:
        mhz, watts, n = smi.between(t0, t1)
        print(f"{label} {name}: sustained {ms} ms a call; SM clock median {mhz} MHz, power draw "
              f"median {watts} W over {n} samples; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
