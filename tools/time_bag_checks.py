"""Times ``chip_smoke.py``'s embedding-bag checks (phase 3's ``check_bag`` and
``check_bag_bwd``) of one or more checkouts on one CUDA card, each checkout
in a process of its own, so that two versions of the checks compare on the
same card in one run:

    python3 tools/time_bag_checks.py OUT.jsonl TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and ``src/``),
e.g. the parent commit unpacked by ``git archive`` into ``build/parent``
and ``.``, in the order parent, change, change, parent.  The kernels of each
tree are built from its own sources before the clock starts, and the
profiler is started once first, as the earlier phases of ``chip_smoke.py``
leave it.  Prints, and appends to OUT.jsonl, one JSON line a run: the tree,
the wall seconds of ``check_bag``, of ``check_bag_bwd`` and of both with the
cache frees between them (``chip_smoke.py``'s ``t_bag`` span), the card's
``nvidia-smi`` name and power limit, from the checks' own lines each
forward case's device time (``fwd_device_ms``, by label: calls back to
back) and each backward case's tiling, kernel and path device times
(``bwd``, by label; the other tiling's beside them where both take the
case), the forward's device time at ``COLD_CASES``, each call after an
L2 flush, timed by this tool alike for every tree (``fwd_device_cold_ms``),
and the tree's phase 4e (``score_dlrm``: the paper DLRM scored at each of
``DLRM_BATCHES``, its forward's wall by the host's clock, median of 20,
``score_ms``), after the host's µs a call of the forward wrapper at the
serving lookup (``wrapper_host_us``).  Then the wrapper's host µs, and a
table of each label's forward device times and of the scoring walls,
across the runs.  The checks' own output goes to
OUT.jsonl's directory, one log a run.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

FWD = re.compile(r"^phase 3 kernel: embedding_bag (.+?): max\|err\|.*? device_ms (\S+) ")
BWD = re.compile(r"^phase 3 kernel: embedding_bag_bwd (.+?): tiling (\w+),.*? kernel_ms (\S+) "
                 r"path_ms (\S+) ")
BWD_OTHER = re.compile(r"^phase 3 kernel: embedding_bag_bwd (.+?) forced to (\w+): kernel_ms "
                       r"(\S+) path_ms (\S+) ")
SCORE = re.compile(r"^phase 4e score: B=(\d+) forward (\S+) ms ")


class _Tee(io.StringIO):
    """Keeps what is printed and passes it on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def parse(lines: list[str]) -> dict:
    """The device times in the checks' printed lines, by case label, and
    phase 4e's forward walls, by batch."""
    fwd, bwd, score = {}, {}, {}
    for line in lines:
        if m := SCORE.match(line):
            score[f"B={m.group(1)}"] = float(m.group(2))
        elif m := FWD.match(line):
            fwd[m.group(1)] = float(m.group(2))
        elif m := BWD.match(line):
            bwd[m.group(1)] = dict(tiling=m.group(2), kernel_ms=float(m.group(3)),
                                   path_ms=float(m.group(4)))
        elif m := BWD_OTHER.match(line):
            bwd[m.group(1)].update({f"{m.group(2)}_kernel_ms": float(m.group(3)),
                                    f"{m.group(2)}_path_ms": float(m.group(4))})
    return dict(fwd_device_ms=fwd, bwd=bwd, score_ms=score)


# Forward lookups this tool times cold on every tree alike, on the paper
# DLRM's tables (T=8, R=1e7): (label, table dtype, E, B, NNZ, id dtype, ids:
# uniform in [0, R), in the last 1000 rows, or past the table and negative).
COLD_CASES = (("serving B=128 NNZ=1 fp32 int32", "float32", 128, 128, 1, "int32", "uniform"),
              ("B=4096 NNZ=1 fp32 int32", "float32", 128, 4096, 1, "int32", "uniform"),
              ("B=4096 NNZ=1 fp32 int64", "float32", 128, 4096, 1, "int64", "uniform"),
              ("multi-hot B=4096 NNZ=32 fp32 int32", "float32", 128, 4096, 32, "int32", "uniform"),
              ("ids near R-1 B=128 NNZ=4 fp32 int32", "float32", 128, 128, 4, "int32", "near_end"),
              ("ids past the table B=128 NNZ=1 fp32 int32", "float32", 128, 128, 1, "int32",
               "past"),
              ("serving B=128 NNZ=1 bf16 int32", "bfloat16", 128, 128, 1, "int32", "uniform"),
              ("B=4096 NNZ=1 bf16 int32", "bfloat16", 128, 4096, 1, "int32", "uniform"),
              ("multi-hot B=4096 NNZ=32 bf16 int32", "bfloat16", 128, 4096, 32, "int32", "uniform"),
              ("ragged E=13 B=128 NNZ=7 fp32 int64", "float32", 13, 128, 7, "int64", "uniform"))
COLD_ITERS, L2_FLUSH_FLOATS = 20, 32 << 20  # 128 MB read before each call: over 2x the L2


def cold_forward(embedding_bag, dev, gen) -> dict:
    """Each COLD_CASES lookup's kernel device time (ms), by ``torch.profiler``
    over COLD_ITERS calls, each after a read of 128 MB that flushes the 50 MB
    L2, so the selected rows come from device memory as a new batch's do:
    one clock for every tree's kernel, whatever its checks time.  A session
    that records fewer than COLD_ITERS launches of the kernel (the profiler
    drops events now and then) is run again, up to twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    T, R = 8, 10**7
    flush = torch.zeros(L2_FLUSH_FLOATS, device=dev)
    out = {}
    for table in dict.fromkeys((dtype, E) for _, dtype, E, *_ in COLD_CASES):
        tables = torch.randn(T, R, table[1], generator=gen, device=dev,
                             dtype=getattr(torch, table[0]))
        for label, dtype, E, B, nnz, id_dtype, kind in COLD_CASES:
            if (dtype, E) != table:
                continue
            if kind == "past":
                past = torch.tensor([R, R + 5, -1, -R, -R - 3, 2**31 - 1, -(2**31), 0],
                                    device=dev).repeat(B // 8)
                ids = past[:, None, None].expand(-1, T, nnz)
            else:
                low = R - 1000 if kind == "near_end" else 0
                ids = torch.randint(low, R, (B, T, nnz), generator=gen, device=dev)
            ids = ids.to(getattr(torch, id_dtype))
            embedding_bag(tables, ids)
            torch.cuda.synchronize()
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(COLD_ITERS):
                        flush.sum()
                        embedding_bag(tables, ids)
                    torch.cuda.synchronize()
                hits = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and "embedding_bag_kernel" in e.key]
                if sum(e.count for e in hits) == COLD_ITERS:
                    break
            else:
                raise RuntimeError(f"time_bag_checks: the profiler missed launches, {label}")
            out[label] = sum(e.self_device_time_total for e in hits) / 1e3 / COLD_ITERS
        del tables
        torch.cuda.empty_cache()
    return out


HOST_CALLS = 2000


def wrapper_host_us(embedding_bag, dev, gen) -> float:
    """The host's µs a call of the forward wrapper at the serving lookup (B
    = 128, T = 8, NNZ = 1, E = 128 fp32; tables cut to R = 1e5, which the
    host's work does not depend on): HOST_CALLS calls back to back, the
    least of 5 rounds.  Its kernel takes about 2 µs of the card, so the
    host's launch path sets the pace."""
    import torch

    tables = torch.randn(8, 100_000, 128, generator=gen, device=dev)
    ids = torch.randint(0, 100_000, (128, 8, 1), generator=gen, device=dev, dtype=torch.int32)
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            embedding_bag(tables, ids)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
    return best


def one(tree: Path) -> dict:
    """Runs the bag checks of the checkout at ``tree`` once; their seconds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts tree/src first on sys.path
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_bwd
    from repro_torch.kernels.ref import ref_embedding_bag, ref_embedding_bag_bwd
    from repro_torch.models import dlrm

    if not torch.cuda.is_available():
        raise SystemExit("time_bag_checks: no CUDA device")
    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    for name in ("embedding_bag", "embedding_bag_bwd"):
        _build.load(name)
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    cs.kernel_device_ms(lambda: torch.zeros(1, device=dev), 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        cs.check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cs.check_bag_bwd(embedding_bag_bwd, ref_embedding_bag_bwd, gen, dev, smi)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        cold = cold_forward(embedding_bag, dev, gen)
        host_us = wrapper_host_us(embedding_bag, dev, gen)
        cs.score_dlrm(dlrm, ops, ref_embedding_bag, dev, smi)
    return dict(tree=str(tree), check_bag_s=t1 - t0, check_bag_bwd_s=t2 - t1,
                bag_checks_s=t2 - t0, card=smi, **parse(tee.getvalue().splitlines()),
                fwd_device_cold_ms=cold, wrapper_host_us=host_us)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]))))
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(argv[1:]):
        log = out.parent / f"{out.stem}.{i}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--one", tree], stdout=f,
                                  stderr=subprocess.STDOUT, text=True)
        last = log.read_text().strip().splitlines()[-1:]
        if proc.returncode != 0 or not last:
            print(f"time_bag_checks: {tree} failed ({proc.returncode}); see {log}",
                  file=sys.stderr)
            return 1
        print(last[0], flush=True)
        with open(out, "a") as f:
            f.write(last[0] + "\n")
        runs.append(json.loads(last[0]))
    print("forward wrapper host µs a call at B=128: "
          + " ".join(str(r["wrapper_host_us"]) for r in runs))
    for key, what in (("fwd_device_ms", "forward device ms by case (back to back, the checks')"),
                      ("fwd_device_cold_ms", "forward device ms by case (cold, this tool's)"),
                      ("score_ms", "phase 4e forward wall ms by batch (median of 20)")):
        print(f"{what}; runs: " + ", ".join(r["tree"] for r in runs))
        for label in dict.fromkeys(k for r in runs for k in r[key]):
            print(f"  {label}: " + " ".join(str(r[key].get(label)) for r in runs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
