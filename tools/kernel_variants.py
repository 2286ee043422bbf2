"""What the kernel-variant tools share: a variant is a kernel's CUDA sources
with a few lines replaced, built with ``kernels._build``'s flags into a
library of its own and called through the kernel's C entry point; the
variants are timed in turns on one card (every round in a shuffled order),
and called back to back while ``nvidia-smi`` samples the SM clock and the
power draw.  ``tools/gmm_bwd_variants.py`` (the grouped matmul's backward)
and ``tools/scan_bwd_variants.py`` (the Mamba scan's backward) keep only
their tables of variants and the calls of their kernels.
"""

from __future__ import annotations

import ctypes
import datetime
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "csrc"


def edited(files: tuple[str, ...], edits, name: str = "") -> dict[str, str]:
    """The texts of ``files`` (names under ``csrc/``) with each (old, new) of
    ``edits`` replaced in whichever file holds it, or raises if a line to
    replace is missing.  An ``old`` that is a pair (start, end) stands for
    the text from start up to end."""
    texts = {f: (CSRC / f).read_text() for f in files}
    for old, new in edits:
        if isinstance(old, tuple):  # the text from old[0] up to old[1]
            for text in texts.values():
                start = text.find(old[0])
                end = text.find(old[1], start) if start >= 0 else -1
                if end >= 0:
                    old = text[start:end]
                    break
            else:
                raise SystemExit(f"{name}: no lines {old!r} to replace")
        hits = [f for f, text in texts.items() if old in text]
        if not hits:
            raise SystemExit(f"{name}: no line {old!r} to replace")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    return texts


def build(out_dir: Path, name: str, texts: dict[str, str], main: str) -> ctypes.CDLL:
    """Writes the variant's files into ``out_dir/name`` and builds ``main``
    (one of them) with ``kernels._build``'s flags; raises if nvcc fails."""
    from repro_torch.kernels import _build

    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (d / f).write_text(text)
    lib = d / f"lib{Path(main).stem}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / main)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    (d / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def build_all(out_dir: Path, variants: dict[str, dict[str, str]], main: str) -> dict:
    """Every variant's library, built at once (one nvcc a variant)."""
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(lambda n: build(out_dir, n, variants[n], main),
                                           variants)))


def card() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms a call of ``fn`` on the card: CUDA events around ``iters`` calls
    back to back, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(runs: dict, rounds: int, seed: int = 0) -> dict:
    """``runs`` (label -> a function that returns a time, or a tuple of
    times) called once a round, ``rounds`` rounds, each round in an order
    shuffled by ``seed``: label -> the list of what each call returned."""
    rnd = random.Random(seed)
    order = list(runs)
    times: dict = {}
    for _ in range(rounds):
        rnd.shuffle(order)
        for label in order:
            times.setdefault(label, []).append(runs[label]())
    return times


class Smi:
    """``nvidia-smi`` sampling the SM clock and the power draw every 50 ms
    into ``path`` while it runs; ``between(t0, t1)`` gives the medians of the
    samples taken in that window of the host's clock."""

    def __init__(self, path: Path):
        self.path = path
        with open(path, "w") as out:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "50"],
                stdout=out, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> None:
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.samples = []
        for line in self.path.read_text().splitlines():
            try:
                stamp, mhz, watts = (f.strip() for f in line.split(","))
                self.samples.append((datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f"),
                                     float(mhz), float(watts)))
            except ValueError:
                continue

    def between(self, t0, t1):
        got = [(mhz, watts) for t, mhz, watts in self.samples if t0 <= t <= t1]
        if not got:
            return None, None, 0
        return (statistics.median(m for m, _ in got), statistics.median(w for _, w in got),
                len(got))


def sustained(fn, seconds: float) -> tuple[float, datetime.datetime, datetime.datetime]:
    """``fn`` called back to back for ``seconds``: (ms a call, the window to
    read the clock and power samples in, its first half second left out)."""
    import torch

    fn()
    torch.cuda.synchronize()
    n, t0 = 0, datetime.datetime.now()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        for _ in range(20):
            fn()
        n += 20
        torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3 / n
    return ms, t0 + datetime.timedelta(seconds=0.5), datetime.datetime.now()
