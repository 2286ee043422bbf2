"""Builds variants of the RG-LRU scan's forward and backward kernels and times
them in turns on one CUDA card, at recurrentgemma-9b's shapes (fp32, as the
layer passes them):

    python3 tools/lru_variants.py [OUT_DIR]

Each variant is ``csrc/rglru_scan.cu`` and ``csrc/rglru_scan_bwd.cu`` with a
few lines replaced (VARIANTS: what each one changes), both built with
``kernels._build``'s flags into OUT_DIR (default ``build/lru_variants``) and
called through the kernels' C entry points.  Every variant is first held to
the plain versions (``ref_rglru_scan`` within 1e-5, ``ref_rglru_scan_bwd``
within 1e-4 of each gradient's max|.|) and to its own bits on a second
launch, and its registers and spills are read from ptxas.  Then each case
(CASES: the forward at B = 1 and at the prefill, the backward at B = 1 with
fp32 and bf16 a) is timed (CUDA events, ITERS calls a sample) in ROUNDS
rounds, each round in a shuffled order; the median and the least are
printed with the card's ``nvidia-smi`` name and power limit
(``tools/kernel_variants.py`` builds and turns).
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
FWD, BWD = "rglru_scan.cu", "rglru_scan_bwd.cu"
SOURCES = ("hopper.cuh", FWD, BWD)
STAGES = "constexpr int STAGES = 4;                // rounds in the ring"
WARPS = "constexpr int WARPS = 8;                 // consumer warps, one chunk of a round each"
CHUNK = "constexpr int CH = 16;                   // steps a chunk"


def _const(line: str, value: int) -> tuple[str, str]:
    return line, re.sub(r"= \d+;", f"= {value};", line)


# name: (what it changes, [(old, new), ...]); each edit applies to both
# kernels (their constants and staging are written alike).
VARIANTS = {
    "default": ("the kernels as they are: 32-channel tiles, 8 warps of 16-step chunks "
                "(128-step rounds), a ring of 4 stages", []),
    "stages3": ("a ring of 3 stages (loads two rounds ahead; the forward fits two blocks an SM)",
                [_const(STAGES, 3)]),
    "stages2": ("a ring of 2 stages (loads one round ahead)", [_const(STAGES, 2)]),
    "chunk8": ("8-step chunks, 64-step rounds: half the stage (the forward fits three blocks an "
               "SM, the backward two)", [_const(CHUNK, 8)]),
    "chunk32_warps4": ("4 warps of 32-step chunks (128-step rounds, half the consumers)",
                       [_const(CHUNK, 32), _const(WARPS, 4)]),
    "warps16_chunk8": ("16 warps of 8-step chunks (128-step rounds, twice the consumers)",
                       [_const(CHUNK, 8), _const(WARPS, 16)]),
    "plain_loads": ("the producer's plain loads at every shape (no TMA)",
                    [("  const bool tma = aligned(", "  const bool tma = false && aligned(")]),
}
# (label, kernel, B, L, D, dtype of a and b)
CASES = (("forward B=1 L=4096 D=4096 fp32", "fwd", 1, 4096, 4096, "float32"),
         ("forward B=4 L=2048 D=4096 fp32", "fwd", 4, 2048, 4096, "float32"),
         ("backward B=1 L=4096 D=4096 fp32", "bwd", 1, 4096, 4096, "float32"),
         ("backward B=1 L=4096 D=4096 bf16 a", "bwd", 1, 4096, 4096, "bfloat16"))
ROUNDS, ITERS = 7, 10


def texts(name: str) -> dict[str, str]:
    """The kernels' sources with the variant's lines replaced, and the header
    they include, or raises if a line to replace is missing."""
    return kv.edited(SOURCES, VARIANTS[name][1], f"lru_variants: {name}")


def ptxas(out_dir: Path, name: str) -> str:
    """The variant's registers and spills of its fp32 kernels."""
    got = []
    for main, base in ((FWD, "lru_fwd_kernel"), (BWD, "lru_bwd_kernel")):
        text = (out_dir / name / f"ptxas_{Path(main).stem}.txt").read_text()
        m = re.search(base + r"IfE.*?\n(.*?spill loads)\n.*?Used (\d+) registers", text, re.S)
        got.append(f"{base}<float> " + (f"{m.group(2)} registers, {m.group(1).strip()}"
                                         if m else "not found"))
    return "; ".join(got)


def build(out_dir: Path, name: str) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """The variant's forward and backward libraries (one nvcc each)."""
    variant = texts(name)
    libs = []
    for main in (FWD, BWD):
        libs.append(kv.build(out_dir, name, variant, main))
        log = out_dir / name / "ptxas.txt"
        log.replace(out_dir / name / f"ptxas_{Path(main).stem}.txt")
    return tuple(libs)


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.kernels.ref import ref_rglru_scan, ref_rglru_scan_bwd

    if not torch.cuda.is_available():
        raise SystemExit("lru_variants: no CUDA device")
    out_dir = Path(argv[0]) if argv else ROOT / "build" / "lru_variants"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(out_dir, n), VARIANTS)))
    card = kv.card()
    print(f"lru_variants on {card}: " + "; ".join(f"{n}: {v[0]}" for n, v in VARIANTS.items()))
    for name in VARIANTS:
        print(f"{name}: {ptxas(out_dir, name)}", flush=True)
    dev = torch.device("cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fwd, bwd in libs.values():
        fwd.repro_rglru_scan.argtypes = [p] * 4 + [i] * 4 + [p]
        bwd.repro_rglru_scan_bwd.argtypes = [p] * 6 + [i] * 4 + [p]

    def call(lib, kind, args, outs):
        B, L, D = args[0].shape
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "fwd":
            err = lib[0].repro_rglru_scan(*(t.data_ptr() for t in args + outs), B, L, D,
                                          DTYPE_CODES[args[0].dtype], stream)
        else:
            a, h_all, dh = args
            err = lib[1].repro_rglru_scan_bwd(a.data_ptr(), h_all.data_ptr(), dh.data_ptr(), 0,
                                              *(t.data_ptr() for t in outs), B, L, D,
                                              DTYPE_CODES[a.dtype], stream)
        if err:
            raise RuntimeError(f"lru_variants: CUDA error {err}")

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, kind, B, L, D, dtype in CASES:
        a = (torch.rand(B, L, D, generator=gen, device=dev) * 0.89 + 0.1).to(getattr(torch, dtype))
        b = torch.randn(B, L, D, generator=gen, device=dev).to(a.dtype)
        if kind == "fwd":
            args, want = (a, b), ref_rglru_scan(a, b)
            outs = (torch.empty(B, L, D, device=dev), torch.empty(B, D, device=dev))
        else:
            h_all = ref_rglru_scan(a, b)[0]
            args = (a, h_all, torch.randn(B, L, D, generator=gen, device=dev))
            want = [w.float() for w in ref_rglru_scan_bwd(*args)]
            outs = (torch.empty(B, L, D, device=dev), torch.empty(B, L, D, device=dev))
        for name, lib in libs.items():
            call(lib, kind, args, outs)
            first = [o.clone() for o in outs]
            call(lib, kind, args, outs)
            if not all(torch.equal(f, o) for f, o in zip(first, outs)):
                raise SystemExit(f"lru_variants: {name} gives other bits on a second launch, "
                                 f"{label}")
            for g, w in zip(outs, want):
                if kind == "fwd":
                    ok = torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                else:
                    g = g.to(a.dtype).float()  # the wrapper's cast
                    bar = 1e-4 * float(w.abs().max())
                    if a.dtype != torch.float32:
                        bar = bar + torch.finfo(a.dtype).eps * w.abs()
                    ok = bool(((g - w).abs() <= bar).all())
                if not ok:
                    raise SystemExit(f"lru_variants: {name} off the plain version, {label}")
        times = kv.in_turns({name: (lambda lib=lib: kv.time_ms(
            lambda: call(lib, kind, args, outs), ITERS)) for name, lib in libs.items()}, ROUNDS)
        for name, ts in times.items():
            print(f"{label} {name}: median {statistics.median(ts)} ms, least {min(ts)} ms a "
                  f"launch; on {card}", flush=True)
        del a, b, args, want, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
