"""Times ``chip_smoke.py``'s embedding-bag checks (phase 3's ``check_bag`` and
``check_bag_bwd``), or with ``--gmm`` its grouped-matmul backward check, of
one or more checkouts on one CUDA card, each checkout in a process of its
own, so that two versions of the checks compare on the same card in one run:

    python3 tools/time_bag_checks.py [--gmm | --gmm-moe | --scan | --scan-ssm | --lru | --lru-hyb \
        | --attn | --attn-au | --bits | --overhead] OUT.jsonl TREE ...

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

``--gmm`` runs the tree's ``check_gmm_bwd`` instead (its ``GMM_BWD_CASES``)
and records each case's call, dx and dw times beside ``torch.bmm``'s and the
bound (``gmm_bwd``, by case), then the SHA-256 of dx's and dw's bits at the two bf16
training shapes (qwen3-moe-30b-a3b, C = 1280: gate/up and down) on inputs
this tool makes from one seed for every tree (``digests``), and prints
whether every run's bits agree.  ``--gmm-moe`` also trains phase 5c's
model (``train_full`` and ``trace_train_step`` of the tree's
``chip_smoke.py``: 2 + 8 steps, 6 on a fixed batch, one traced) and records
its step times, peak memory and the traced step's grouped-matmul backward
(``moe_step``).

``--scan`` runs the tree's ``check_mamba_bwd`` (its ``MAMBA_BWD_CASES``;
each case's backward, plain and bound times, ``scan_bwd``), then times on
every tree alike, by CUDA events: the serving forward at falcon-mamba-7b's
prefill (``SCAN_PREFILL``, bf16, ``prefill_ms``), the forward at the training
shape (``SCAN_TRAIN``, ``train_fwd_ms``), and one layer's scans as a remat
step runs them through the tree's ``SelectiveScanFn`` (non-reentrant
``torch.utils.checkpoint``: the forward twice, then the backward,
``pair_ms``); then the SHA-256 of the serving call's y and h bits at the
prefill shape on inputs this tool makes from one seed (``digests``), and
prints whether every run's bits agree.  ``--scan-ssm`` also trains phase
5d's model (the tree's ``train_ssm``: 2 + 8 steps, 6 on a fixed batch, one
traced) and records its step times, tokens/s, model FLOPs share, peak
memory and the traced step's scan forward and backward (``ssm_step``).

``--lru`` runs the tree's ``check_lru_bwd`` (its ``LRU_BWD_CASES``; each
case's backward, plain and bound times, ``lru_bwd``), then times on every
tree alike, by CUDA events, through the tree's own wrappers on inputs this
tool makes from one seed (fp32, as the layer passes them): the forward at
recurrentgemma-9b's training shape (``LRU_TRAIN``, B = 1, ``train_fwd_ms``)
and at its prefill (``LRU_PREFILL``, B = 4, ``prefill_ms``), the backward at
the training shape (``train_bwd_ms``; with bf16 a, ``train_bwd_bf16_ms``),
and one layer's scans as a remat step runs them through the tree's
``LruScanFn`` (non-reentrant ``torch.utils.checkpoint``: the forward twice,
then the backward, ``pair_ms``: its host's autograd and checkpoint work
shows); each beside its bound.  Beside them two elementwise passes over the
same tensors give the rate the card's own kernels reach for a like mix of
reads and writes: ``torch.add(a, b, out=h)`` moves exactly the forward's
bytes (``add_ms``), ``torch.addcmul(dh, a, h, out=da)`` three reads and a
write (``addcmul_ms``).  Then the SHA-256 of
the forward's and the backward's bits at the training shape (``digests``),
and prints whether the runs of each tree agree.  ``--lru-hyb`` also trains
phase 5e's model (the tree's ``train_hybrid``: 2 + 8 steps, 6 on a fixed
batch, one traced) and records its step times, tokens/s, model FLOPs share,
peak memory and the traced step's RG-LRU forward and backward
(``hyb_step``).

``--attn`` times, on every tree alike, through the tree's own wrappers and
on inputs this tool makes from one seed, the attention forward (without and
with lse) and backward at ``ATTN_CASES`` (hubert-xlarge's training and
serving shapes at head dim 80, the other D = 80 shapes of phase 3, and the
D = 64, 128 and 256 and fp32 shapes (D 32 among them) whose kernels must not
move) by CUDA
events and, the kernels alone, by ``torch.profiler`` (``fwd_device_ms``,
``bwd_device_ms``), SDPA's forward and backward beside the hubert shapes,
and the SHA-256 of each case's o, lse, dq, dk and dv bits (``attn``, by
case); it prints each case's times by run and whether the runs' bits
agree.
``--attn-au`` also trains phase 5g's model (the tree's
``train_vlm_or_encoder`` on hubert-xlarge: 2 + 8 steps, 6 on a fixed batch,
one traced) and records its step times, tokens/s, model FLOPs share, peak
memory and the traced step's attention forward and backward (``au_step``).

``--bits`` calls the tree's public kernel functions on inputs this tool
makes from one seed (``BITS_*``): ``flash_attention`` with ``lse`` and
``flash_attention_bwd`` (head dims 64, 80, 128 and 256, a window, fp32 at
each head dim with fma instances of its own),
``moe_gmm`` on its three tilings and ``moe_gmm_bwd`` (dw alone too),
``mamba_scan`` with and without checkpoints and ``mamba_scan_bwd``,
``rglru_scan`` and ``rglru_scan_bwd``, and records the SHA-256 of each
case's outputs (``digests``); it prints whether every run's digests agree
and exits 1 where they do not.

``--overhead`` times the host's work a launch and what it costs a served
token.  First each ``kernels.ops`` wrapper at decode-sized shapes, where the
host's work outweighs the kernel's (``OVERHEAD_CASES``: the grouped matmul on
qwen3-moe-30b-a3b's decode buffer, 32 of 128 experts live, skinny;
attention at B 4, H 32, KV 4, S 16, D 128; both scans at B 4, L 16):
``OVERHEAD_CALLS`` calls back to back without a synchronise, ``OVERHEAD_ROUNDS``
times, the median host µs a call (``host_us``).  Then phase 4's and 4b's
serving (granite-8b and qwen3-moe-30b-a3b at full width and depth, the
tree's ``served`` on its prompts) ``DECODE_REPEATS`` times each after a
warm-up, the decode's ms a token each time (``decode_ms``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import inspect
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

# --bits: (B, H, KV, S, D, dtype, causal, window)
BITS_ATTENTION = ((2, 8, 2, 512, 64, "bfloat16", True, 0),
                  (2, 8, 2, 512, 128, "bfloat16", True, 0), (2, 8, 8, 500, 80, "bfloat16", False, 0),
                  (1, 8, 1, 512, 256, "bfloat16", True, 128), (2, 4, 2, 256, 64, "float32", True, 0),
                  # the fma tiling's other head dims with instances of their own
                  (2, 8, 4, 128, 32, "float32", True, 0), (2, 4, 4, 200, 80, "float32", False, 0),
                  (2, 4, 2, 256, 128, "float32", True, 0), (1, 4, 1, 300, 256, "float32", True, 64))
# (E, C, D, F, dtype): the wgmma, fma and skinny tilings
BITS_GMM = ((8, 320, 512, 256, "bfloat16"), (8, 100, 96, 72, "float32"),
            (8, 4, 512, 256, "bfloat16"))
BITS_MAMBA = (2, 300, 256, 16)  # B, L, DI, ST in bf16
BITS_LRU = ((2, 1000, 512, "float32"), (1, 700, 96, "bfloat16"))  # B, L, D, dtype
# --overhead
OVERHEAD_CALLS, OVERHEAD_ROUNDS, DECODE_REPEATS = 500, 7, 3


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


# The grouped matmul backward's bf16 training shapes (E, C, D, F) whose bits
# every tree's kernel must give alike, on this tool's inputs.
GMM_DIGEST_SHAPES = (("gate_up", 128, 1280, 2048, 768), ("down", 128, 1280, 768, 2048))


def gmm_digests(moe_gmm_bwd, dev) -> dict:
    """SHA-256 of dx's and dw's bits at GMM_DIGEST_SHAPES, on bf16 inputs
    made from seed 26 on the card (the same for every tree)."""
    import hashlib

    import torch

    out = {}
    for name, E, C, D, F in GMM_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(26)
        x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = (torch.randn(E, D, F, generator=gen, device=dev) / D**0.5).bfloat16()
        dy = torch.randn(E, C, F, generator=gen, device=dev).bfloat16()
        for part, t in zip(("dx", "dw"), moe_gmm_bwd(x, w, dy)):
            bits = t.view(torch.int16).cpu().numpy().tobytes()
            out[f"{name} {part}"] = hashlib.sha256(bits).hexdigest()
        del x, w, dy
        torch.cuda.empty_cache()
    return out


def moe_step(cs, dev, smi) -> dict:
    """Phase 5c of the tree's ``chip_smoke.py``: qwen3-moe-30b-a3b at 4
    layers trained on the card, then one traced step."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_train import group_of
    from repro_torch.models import lm
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config(cs.MOE_TRAIN_ARCH), n_layers=cs.MOE_TRAIN_LAYERS)
    L = cfg.n_layers
    want = {n: 0 for n in cs.COUNTERS}
    want.update(attention_launches=2 * L, attention_wgmma_launches=2 * L,
                attention_bwd_launches=L, attention_bwd_wgmma_launches=L,
                grouped_matmul_launches=6 * L, grouped_matmul_wgmma_launches=6 * L,
                grouped_matmul_bwd_launches=3 * L, grouped_matmul_bwd_wgmma_launches=3 * L)
    run = cs.train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi, "5c", want,
                        ("blocks.0.moe.wg", f"blocks.{L - 1}.moe.wd"), warmup=cs.MOE_WARMUP,
                        loss0_tol=1.0)
    trace = cs.trace_train_step(lm, run, cfg, group_of, "5c", smi)
    numbers = {k: run[k] for k in ("step_ms", "step_ms_all", "peak_gb", "losses",
                                   "launches_per_step")}
    cs.release(run)
    return dict(numbers, traced_ms=trace["traced_ms"], busy_ms=trace["busy_ms"],
                idle_share=trace["idle_share"],
                gmm_bwd_traced_ms=trace["split_ms"]["grouped matmul backward"],
                gmm_fwd_traced_ms=trace["split_ms"]["grouped matmul forward"])


def one_gmm(cs, tree: Path, moe: bool) -> dict:
    """The grouped matmul backward's check of the checkout at ``tree``, its
    bits at the training shapes, and with ``moe`` phase 5c."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import gmm_bwd_tiling, moe_gmm_bwd
    from repro_torch.kernels.ref import ref_moe_gmm_bwd

    kernels = ["moe_gmm_bwd"]
    if moe:
        kernels += ["moe_gmm", "flash_attention", "flash_attention_bwd"]
    _build.load_all(kernels)
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    cases = cs.check_gmm_bwd(moe_gmm_bwd, ref_moe_gmm_bwd, gmm_bwd_tiling, gen, dev, smi)
    seconds = time.perf_counter() - t0
    keys = ("kernel_ms", "dx_ms", "dw_ms", "library_ms", "bound_ms", "plain_ms")
    out = dict(tree=str(tree), card=smi, check_gmm_bwd_s=seconds,
               gmm_bwd={name: {k: c[k] for k in keys} for name, c in cases.items()},
               digests=gmm_digests(moe_gmm_bwd, dev))
    if moe:
        out["moe_step"] = moe_step(cs, dev, smi)
    return out


# falcon-mamba-7b's scan at its prefill and at its training shape: (B, L, DI,
# ST, R), b and c strided as the layer makes them, bf16.
SCAN_PREFILL, SCAN_TRAIN = (4, 1000, 8192, 16, 256), (4, 4096, 8192, 16, 256)


def scan_inputs(dev, B, L, DI, ST, R, seed):
    """The scan's inputs in bf16 as the Mamba layer makes them (``xdbc`` the
    projection b and c are slices of), made on the card from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    xc = torch.randn(B, L, DI, generator=gen, device=dev).bfloat16()
    dt = torch.rand(B, L, DI, generator=gen, device=dev) * 0.099 + 0.001
    a = -torch.arange(1, ST + 1, dtype=torch.float32, device=dev).repeat(DI, 1)
    xdbc = torch.randn(B, L, R + 2 * ST, generator=gen, device=dev).bfloat16()
    return xc, dt, a, xdbc, torch.randn(DI, generator=gen, device=dev)


def scan_times(cs, dev) -> dict:
    """The tree's serving forward at SCAN_PREFILL, its forward at SCAN_TRAIN
    and a layer's remat pair there through its SelectiveScanFn (ms a call,
    CUDA events), and the serving call's y and h bits at SCAN_PREFILL."""
    import hashlib

    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.mamba_scan import SelectiveScanFn, mamba_scan

    xc, dt, a, xdbc, d = scan_inputs(dev, *SCAN_PREFILL, seed=28)
    R, ST = SCAN_PREFILL[4], SCAN_PREFILL[3]
    args = (xc, dt, a, xdbc[..., R:R + ST], xdbc[..., R + ST:], d)
    out = dict(prefill_ms=cs.time_ms(lambda: mamba_scan(*args), 20))
    out["digests"] = {n: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                      for n, t in zip(("y", "h"), mamba_scan(*args))}
    xc, dt, a, xdbc, d = scan_inputs(dev, *SCAN_TRAIN, seed=29)
    args = (xc, dt, a, xdbc[..., R:R + ST], xdbc[..., R + ST:], d)
    out["train_fwd_ms"] = cs.time_ms(lambda: mamba_scan(*args), 10)
    leaves = [t.requires_grad_(True) for t in (xc, dt, a, xdbc, d)]
    dy = torch.randn(xc.shape, device=dev)

    def pair():  # the checkpointed layer's scans: the forward, again, then the backward
        y, _ = checkpoint(SelectiveScanFn.apply, xc, dt, a, xdbc[..., R:R + ST],
                          xdbc[..., R + ST:], d, use_reentrant=False)
        torch.autograd.grad(y, leaves, dy)

    out["pair_ms"] = cs.time_ms(pair, 5, warmup=1)
    return out


def ssm_step(cs, dev, smi) -> dict:
    """Phase 5d of the tree's ``chip_smoke.py``: falcon-mamba-7b at 16 layers
    trained on the card, one step traced."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_train import group_of
    from repro_torch.models import lm
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config(cs.SSM_TRAIN_ARCH), n_layers=cs.SSM_TRAIN_LAYERS)
    run = cs.train_ssm(lm, ops, optim, make_train_step, data, group_of, cfg, dev, smi)
    trace = run["trace"]
    return dict({k: run[k] for k in ("step_ms", "step_ms_all", "tokens_per_s", "mfu", "peak_gb",
                                     "launches_per_step")},
                traced_ms=trace["traced_ms"], idle_share=trace["idle_share"],
                scan_fwd_traced_ms=trace["split_ms"]["selective scan forward"],
                scan_bwd_traced_ms=trace["split_ms"]["selective scan backward"])


def one_scan(cs, tree: Path, ssm: bool) -> dict:
    """The scan backward's check of the checkout at ``tree`` (whatever its
    signature), this tool's timings of its scans, and with ``ssm`` phase 5d."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.ref import ref_mamba_scan, ref_mamba_scan_bwd

    _build.load_all(["mamba_scan", "mamba_scan_bwd"])
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    have = dict(mamba_scan=mamba_scan, mamba_scan_bwd=mamba_scan_bwd, ref_mamba_scan=ref_mamba_scan,
                ref_mamba_scan_bwd=ref_mamba_scan_bwd, gen=gen, dev=dev, smi=smi)
    check = cs.check_mamba_bwd
    t0 = time.perf_counter()
    cases = check(**{n: have[n] for n in inspect.signature(check).parameters})
    seconds = time.perf_counter() - t0
    keys = ("kernel_ms", "plain_ms", "bound_ms", "fwd_ms", "fwd_ckpt_ms", "pair_ms")
    out = dict(tree=str(tree), card=smi, check_mamba_bwd_s=seconds,
               scan_bwd={name: {k: c[k] for k in keys if k in c} for name, c in cases.items()},
               **scan_times(cs, dev))
    torch.cuda.empty_cache()
    if ssm:
        out["ssm_step"] = ssm_step(cs, dev, smi)
    return out


# recurrentgemma-9b's RG-LRU scan at its training shape and its prefill: (B, L, D).
LRU_TRAIN, LRU_PREFILL = (1, 4096, 4096), (4, 2048, 4096)


def lru_inputs(dev, B, L, D, seed):
    """a in the layer's range (0.1..0.99), b, the cotangent of h_all, fp32,
    made on the card from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(B, L, D, generator=gen, device=dev) * 0.89 + 0.1,
            torch.randn(B, L, D, generator=gen, device=dev),
            torch.randn(B, L, D, generator=gen, device=dev))


def lru_times(cs, dev) -> dict:
    """The tree's forward at LRU_TRAIN and LRU_PREFILL, its backward at
    LRU_TRAIN (fp32 and bf16 a) and a layer's remat pair there through its
    LruScanFn (ms a call, CUDA events), each beside its bound, and the bits
    of the forward and the backward at LRU_TRAIN."""
    import hashlib

    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.rglru_scan import LruScanFn, rglru_scan, rglru_scan_bwd

    a, b, dh = lru_inputs(dev, *LRU_PREFILL, seed=30)
    out = dict(prefill_ms=cs.time_ms(lambda: rglru_scan(a, b), 20),
               prefill_bound_ms=cs.lru_bound(a, b)[0])
    a, b, dh = lru_inputs(dev, *LRU_TRAIN, seed=31)
    h_all = rglru_scan(a, b)[0]
    a16 = a.bfloat16()
    out.update(train_fwd_ms=cs.time_ms(lambda: rglru_scan(a, b), 20),
               train_fwd_bound_ms=cs.lru_bound(a, b)[0],
               train_bwd_ms=cs.time_ms(lambda: rglru_scan_bwd(a, h_all, dh), 20),
               train_bwd_bound_ms=cs.lru_bwd_bound(a, None)[0],
               train_bwd_bf16_ms=cs.time_ms(lambda: rglru_scan_bwd(a16, h_all, dh), 20),
               train_bwd_bf16_bound_ms=cs.lru_bwd_bound(a16, None)[0])
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]

    def pair():  # the checkpointed layer's scans: the forward, again, then the backward
        h, _ = checkpoint(LruScanFn.apply, *leaves, use_reentrant=False)
        torch.autograd.grad(h, leaves, dh)

    out["pair_ms"] = cs.time_ms(pair, 10, warmup=2)
    scratch = torch.empty_like(h_all)
    out.update(add_ms=cs.time_ms(lambda: torch.add(a, b, out=scratch), 20),
               addcmul_ms=cs.time_ms(lambda: torch.addcmul(dh, a, h_all, out=scratch), 20))
    del scratch
    bits = dict(zip(("h_all", "h_final"), rglru_scan(a, b)))
    bits.update(zip(("da", "db"), rglru_scan_bwd(a, h_all, dh)))
    out["digests"] = {n: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                      for n, t in bits.items()}
    return out


def hyb_step(cs, dev, smi) -> dict:
    """Phase 5e of the tree's ``chip_smoke.py``: recurrentgemma-9b at 5
    layers trained on the card, one step traced."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_train import group_of
    from repro_torch.models import lm
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_config(cs.HYB_TRAIN_ARCH), n_layers=cs.HYB_TRAIN_LAYERS)
    run = cs.train_hybrid(lm, ops, optim, make_train_step, data, group_of, cfg, dev, smi)
    trace = run["trace"]
    return dict({k: run[k] for k in ("step_ms", "step_ms_all", "tokens_per_s", "mfu", "peak_gb",
                                     "launches_per_step", "losses", "fixed_losses")},
                traced_ms=trace["traced_ms"], idle_share=trace["idle_share"],
                lru_fwd_traced_ms=trace["split_ms"]["RG-LRU forward"],
                lru_bwd_traced_ms=trace["split_ms"]["RG-LRU backward"])


def one_lru(cs, tree: Path, hyb: bool) -> dict:
    """The RG-LRU backward's check of the checkout at ``tree`` (whatever its
    signature), this tool's timings of its scans, and with ``hyb`` phase 5e."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import ref_rglru_scan_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd

    kernels = ["rglru_scan", "rglru_scan_bwd"]
    if hyb:
        kernels += ["flash_attention", "flash_attention_bwd"]
    _build.load_all(kernels)
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    have = dict(rglru_scan=rglru_scan, rglru_scan_bwd=rglru_scan_bwd,
                ref_rglru_scan_bwd=ref_rglru_scan_bwd, gen=gen, dev=dev, smi=smi)
    check = cs.check_lru_bwd
    t0 = time.perf_counter()
    cases = check(**{n: have[n] for n in inspect.signature(check).parameters})
    seconds = time.perf_counter() - t0
    keys = ("kernel_ms", "plain_ms", "bound_ms", "fwd_ms", "pair_ms")
    out = dict(tree=str(tree), card=smi, check_lru_bwd_s=seconds,
               lru_bwd={name: {k: c[k] for k in keys if k in c} for name, c in cases.items()},
               **lru_times(cs, dev))
    torch.cuda.empty_cache()
    if hyb:
        out["hyb_step"] = hyb_step(cs, dev, smi)
    return out


# (label, B, H, KV, Sq, Sk, D, dtype, causal, window): hubert-xlarge's training
# and serving attention first, then phase 3's other D = 80 shapes, then the
# shapes of the kernels this tool shows unmoved (D = 64, 128 and 256 on
# wgmma, fp32 on fma).
ATTN_CASES = (
    ("hubert train", 4, 16, 16, 4096, 4096, 80, "bfloat16", False, 0),
    ("hubert serve", 4, 16, 16, 1000, 1000, 80, "bfloat16", False, 0),
    ("hubert serve fp16", 4, 16, 16, 1000, 1000, 80, "float16", False, 0),
    ("d80 causal GQA", 2, 16, 4, 1000, 1000, 80, "bfloat16", True, 0),
    ("d80 Sq 1000 Sk 777", 2, 16, 16, 1000, 777, 80, "bfloat16", False, 0),
    ("d80 127 causal", 4, 16, 16, 127, 127, 80, "bfloat16", True, 0),
    ("d80 129 causal", 4, 16, 16, 129, 129, 80, "bfloat16", True, 0),
    ("d80 Sq 127 Sk 129", 4, 16, 16, 127, 129, 80, "bfloat16", False, 0),
    ("d80 fp32 fma", 2, 16, 16, 1000, 1000, 80, "float32", False, 0),
    ("granite prefill d128", 4, 32, 8, 1000, 1000, 128, "bfloat16", True, 0),
    ("minicpm train d64", 4, 36, 36, 4096, 4096, 64, "bfloat16", True, 0),
    ("granite train d128", 4, 32, 8, 2048, 2048, 128, "bfloat16", True, 0),
    ("recurrentgemma d256", 1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048),
    ("vlm cross d128", 4, 32, 8, 4096, 1601, 128, "bfloat16", False, 0),
    ("minicpm fp32 d64 fma", 4, 36, 36, 1024, 1024, 64, "float32", True, 0),
    ("d32 fp32 fma", 4, 8, 4, 2048, 2048, 32, "float32", True, 0),
)


def attn_times(cs, dev) -> dict:
    """Each of ATTN_CASES through the tree's wrappers: the forward without
    and with lse, the backward, SDPA's forward and backward at the hubert
    shapes, and the SHA-256 of the bits of o, lse, dq, dk and dv."""
    import hashlib

    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    out = {}
    for label, B, H, KV, Sq, Sk, D, dtype, causal, window in ATTN_CASES:
        gen = torch.Generator(device=dev).manual_seed(40)
        dt = getattr(torch, dtype)
        q, do = (torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dt) for _ in "qd")
        k, v = (torch.randn(B, KV, Sk, D, generator=gen, device=dev).to(dt) for _ in "kv")
        lse = torch.empty(B, H, Sq, device=dev)
        o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        grads = flash_attention_bwd(q, k, v, o, lse, do, causal, window)
        digest = hashlib.sha256()
        for t in (o, lse, *grads):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        case = dict(
            fwd_ms=cs.time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 20),
            fwd_lse_ms=cs.time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window,
                                                          lse=lse), 20),
            bwd_ms=cs.time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, window),
                              10),
            # The kernels' own device time (torch.profiler): at the small
            # shapes the CUDA events above also time the host's launches.
            fwd_device_ms=sum(cs.kernel_device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window), 20).values()),
            bwd_device_ms=sum(cs.kernel_device_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, window), 10).values()),
            digest=digest.hexdigest())
        if label.startswith("hubert") and dt == torch.bfloat16:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            case["sdpa_fwd_ms"] = cs.time_ms(lambda: sdpa(q, k, v), 20)
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            y = sdpa(qr, kr, vr)
            case["sdpa_bwd_ms"] = cs.time_ms(
                lambda: torch.autograd.grad(y, (qr, kr, vr), do, retain_graph=True), 10)
            del y, qr, kr, vr
        out[label] = case
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return out


def au_step(cs, dev, smi) -> dict:
    """Phase 5g of the tree's ``chip_smoke.py``: hubert-xlarge trained whole
    on the card, one step traced."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_train import group_of
    from repro_torch.models import lm
    from repro_torch.train.steps import make_train_step

    run = cs.train_vlm_or_encoder(lm, ops, optim, make_train_step, data, group_of,
                                  get_config(cs.AU_TRAIN_ARCH), dev, smi, "5g",
                                  "global batch 256 -> 4 (sequence 4096 kept; every layer)")
    trace = run["trace"]
    return dict({k: run[k] for k in ("step_ms", "step_ms_all", "tokens_per_s", "mfu", "peak_gb",
                                     "launches_per_step", "losses", "fixed_losses")},
                traced_ms=trace["traced_ms"], idle_share=trace["idle_share"],
                attn_fwd_traced_ms=trace["split_ms"]["attention forward"],
                attn_bwd_traced_ms=trace["split_ms"]["attention backward"])


def one_attn(cs, tree: Path, au: bool) -> dict:
    """This tool's attention timings and bits of the checkout at ``tree``,
    and with ``au`` phase 5g."""
    import torch

    from repro_torch.kernels import _build

    _build.load_all(["flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    out = dict(tree=str(tree), card=smi, attn=attn_times(cs, dev))
    if au:
        out["au_step"] = au_step(cs, dev, smi)
    return out


def kernel_digests(dev) -> dict:
    """The SHA-256 of each ``BITS_*`` case's outputs through the public
    kernel functions, on inputs made from one seed."""
    import hashlib

    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype="float32"):
        return torch.randn(shape, generator=gen).to(getattr(torch, dtype)).to(dev)

    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            if t is not None:
                h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                         .tobytes())
        return h.hexdigest()

    out = {}
    for B, H, KV, S, D, dt, causal, window in BITS_ATTENTION:
        q, do = rand(B, H, S, D, dtype=dt), rand(B, H, S, D, dtype=dt)
        k, v = rand(B, KV, S, D, dtype=dt), rand(B, KV, S, D, dtype=dt)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        label = f"attention B{B} H{H} KV{KV} S{S} D{D} {dt} causal{int(causal)} w{window}"
        out[label] = digest(o, lse)
        out[label + " bwd"] = digest(*flash_attention_bwd(q, k, v, o, lse, do, causal, window))
    for E, C, D, F, dt in BITS_GMM:
        x, w, dy = rand(E, C, D, dtype=dt), rand(E, D, F, dtype=dt), rand(E, C, F, dtype=dt)
        label = f"gmm E{E} C{C} D{D} F{F} {dt}"
        out[label] = digest(moe_gmm(x, w))
        if C > 16:
            out[label + " bwd"] = digest(*moe_gmm_bwd(x, w, dy))
            out[label + " bwd dw"] = digest(*moe_gmm_bwd(x, w, dy, need_dx=False))
    B, L, DI, ST = BITS_MAMBA
    xc, dt_, a = rand(B, L, DI, dtype="bfloat16"), rand(B, L, DI).abs() * 0.1, -rand(DI, ST).abs()
    bc = rand(B, L, 2 * ST, dtype="bfloat16")
    b, c, d_skip = bc[..., :ST], bc[..., ST:], rand(DI)
    out["mamba"] = digest(*mamba_scan(xc, dt_, a, b, c, d_skip))
    y, h, ckpt = mamba_scan(xc, dt_, a, b, c, d_skip, checkpoints=True)
    out["mamba ckpt"] = digest(y, h, ckpt)
    out["mamba bwd"] = digest(*mamba_scan_bwd(xc, dt_, a, b, c, d_skip, rand(B, L, DI),
                                              rand(B, DI, ST), ckpt))
    for B, L, D, dt in BITS_LRU:
        a, b = torch.sigmoid(rand(B, L, D)).to(getattr(torch, dt)), rand(B, L, D, dtype=dt)
        h_all, h_fin = rglru_scan(a, b)
        out[f"lru B{B} L{L} D{D} {dt}"] = digest(h_all, h_fin)
        out[f"lru B{B} L{L} D{D} {dt} bwd"] = digest(*rglru_scan_bwd(a, h_all, rand(B, L, D),
                                                                     rand(B, D)))
    return out


def overhead_host_us(ops, dev) -> dict:
    """The median host µs a call of each ``kernels.ops`` wrapper at decode-sized
    shapes, calls issued back to back (the card keeps up)."""
    import statistics

    import torch

    bf16 = torch.bfloat16
    x = torch.zeros(128, 1, 2048, device=dev, dtype=bf16)
    w = torch.randn(128, 2048, 768, device=dev, dtype=bf16)
    x[:32] = torch.randn(32, 1, 2048, device=dev, dtype=bf16)  # 4 tokens x top 8 live
    q = torch.randn(4, 32, 16, 128, device=dev, dtype=bf16)
    k = torch.randn(4, 4, 16, 128, device=dev, dtype=bf16)
    xc, dt = torch.randn(4, 16, 1024, device=dev, dtype=bf16), torch.rand(4, 16, 1024, device=dev)
    a, bc = -torch.rand(1024, 16, device=dev), torch.randn(4, 16, 16, device=dev, dtype=bf16)
    d_skip = torch.randn(1024, device=dev)
    la, lb = torch.rand(4, 16, 1024, device=dev), torch.randn(4, 16, 1024, device=dev)
    calls = {
        "grouped_matmul": lambda: ops.grouped_matmul(x, w),
        "attention": lambda: ops.attention(q, k, k),
        "selective_scan": lambda: ops.selective_scan(xc, dt, a, bc, bc, d_skip),
        "lru_scan": lambda: ops.lru_scan(la, lb),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(OVERHEAD_ROUNDS):
                t0 = time.perf_counter()
                for _ in range(OVERHEAD_CALLS):
                    fn()
                times.append((time.perf_counter() - t0) / OVERHEAD_CALLS * 1e6)
                torch.cuda.synchronize()
            out[name] = statistics.median(times)
    return out


def decode_ms(cs, ops, dev) -> dict:
    """Phase 4's and 4b's decode ms a token, ``DECODE_REPEATS`` times each,
    through the tree's ``served`` at full width and depth."""
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    out = {}
    for arch in ("granite-8b", "qwen3-moe-30b-a3b"):
        cfg = get_config(arch)
        model = lm.init(0, cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab, (cs.B, cs.PROMPT), generator=gen, device=dev)
        generate(model, tokens[:, :64], 2)  # warm-up: cuBLAS handles and heuristics
        out[arch] = []
        for _ in range(DECODE_REPEATS):
            timings = cs.served(lm, ops, generate, model, tokens)[1]
            out[arch].append(timings["decode_s"] / (cs.DECODE_STEPS - 1) * 1e3)
        del model, tokens
        gc.collect()
        torch.cuda.empty_cache()
    return out


def overhead_summary(runs: list[dict]) -> None:
    """Each wrapper's host µs a call and each model's decode ms a token by run."""
    print("host µs a wrapper call; runs: " + ", ".join(r["tree"] for r in runs))
    for name in runs[0]["host_us"]:
        print(f"  {name}: " + " ".join(str(r["host_us"][name]) for r in runs))
    print("decode ms a token (each repeat); runs: " + ", ".join(r["tree"] for r in runs))
    for arch in runs[0]["decode_ms"]:
        print(f"  {arch}: " + " | ".join(" ".join(str(t) for t in r["decode_ms"][arch])
                                          for r in runs))


def bits_summary(runs: list[dict]) -> int:
    """Whether every run's digests agree; 1 where they do not."""
    differ = sorted({k for r in runs for k in r["digests"]
                     if r["digests"].get(k) != runs[0]["digests"].get(k)})
    print(f"kernel bits: {len(runs[0]['digests'])} cases on {len(runs)} runs: "
          + ("every digest agrees" if not differ else f"digests differ at {differ}"))
    return 1 if differ else 0


def one(tree: Path, what: str = "bag") -> dict:
    """Runs the bag checks (``what`` "bag"), or another mode's (the module
    docstring's flags without their dashes), of the checkout at ``tree`` once."""
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
    if what in ("scan", "scan-ssm"):
        return one_scan(cs, tree, ssm=what == "scan-ssm")
    if what in ("lru", "lru-hyb"):
        return one_lru(cs, tree, hyb=what == "lru-hyb")
    if what in ("attn", "attn-au"):
        return one_attn(cs, tree, au=what == "attn-au")
    if what in ("bits", "overhead"):
        _build.load_all(("flash_attention", "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd",
                         "mamba_scan", "mamba_scan_bwd", "rglru_scan", "rglru_scan_bwd"))
        dev = torch.device("cuda")
        out = dict(tree=str(tree), card=cs.nvidia_smi_line())
        if what == "bits":
            return dict(out, digests=kernel_digests(dev))
        return dict(out, host_us=overhead_host_us(ops, dev), decode_ms=decode_ms(cs, ops, dev))
    if what != "bag":
        return one_gmm(cs, tree, moe=what == "gmm-moe")
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


def gmm_summary(runs: list[dict]) -> None:
    """Each case's times by run, phase 5c's numbers, and whether every run's
    bits agree at the training shapes."""
    print("grouped matmul backward ms by case, call (dx, dw) / torch.bmm; runs: "
          + ", ".join(r["tree"] for r in runs))
    for name in dict.fromkeys(k for r in runs for k in r["gmm_bwd"]):
        cells = []
        for r in runs:
            c = r["gmm_bwd"].get(name)
            cells.append("-" if c is None else
                         f"{c['kernel_ms']} ({c['dx_ms']}, {c['dw_ms']}) / {c['library_ms']}")
        print(f"  {name}: " + " | ".join(cells))
    if all("moe_step" in r for r in runs):
        for key in ("step_ms", "gmm_bwd_traced_ms", "gmm_fwd_traced_ms", "traced_ms", "idle_share",
                    "peak_gb"):
            print(f"phase 5c {key}: " + " ".join(str(r["moe_step"][key]) for r in runs))
    digests = {json.dumps(r["digests"], sort_keys=True) for r in runs}
    print(f"dx and dw bits at the bf16 training shapes equal across the runs: {len(digests) == 1}"
          + ("" if len(digests) == 1 else
             "; " + "; ".join(f"{r['tree']}: {r['digests']}" for r in runs)))


def scan_summary(runs: list[dict]) -> None:
    """Each case's backward by run, this tool's scan timings, phase 5d's
    numbers, and whether every run's serving bits agree."""
    print("scan backward ms a call by case / plain / bound; runs: "
          + ", ".join(r["tree"] for r in runs))
    for name in dict.fromkeys(k for r in runs for k in r["scan_bwd"]):
        cells = []
        for r in runs:
            c = r["scan_bwd"].get(name)
            cells.append("-" if c is None else f"{c['kernel_ms']} / {c['plain_ms']} / "
                                               f"{c['bound_ms']}")
        print(f"  {name}: " + " | ".join(cells))
    for key in ("prefill_ms", "train_fwd_ms", "pair_ms"):
        print(f"{key}: " + " ".join(str(r[key]) for r in runs))
    if all("ssm_step" in r for r in runs):
        for key in ("step_ms", "tokens_per_s", "mfu", "peak_gb", "scan_fwd_traced_ms",
                    "scan_bwd_traced_ms", "traced_ms", "idle_share"):
            print(f"phase 5d {key}: " + " ".join(str(r["ssm_step"][key]) for r in runs))
    digests = {json.dumps(r["digests"], sort_keys=True) for r in runs}
    print(f"serving y and h bits at the prefill equal across the runs: {len(digests) == 1}"
          + ("" if len(digests) == 1 else
             "; " + "; ".join(f"{r['tree']}: {r['digests']}" for r in runs)))


def lru_summary(runs: list[dict]) -> None:
    """Each backward case by run, this tool's scan timings, phase 5e's
    numbers, and whether the runs of each tree give the same bits."""
    print("RG-LRU backward ms a call by case / plain / bound; runs: "
          + ", ".join(r["tree"] for r in runs))
    for name in dict.fromkeys(k for r in runs for k in r["lru_bwd"]):
        cells = []
        for r in runs:
            c = r["lru_bwd"].get(name)
            cells.append("-" if c is None else f"{c['kernel_ms']} / {c['plain_ms']} / "
                                               f"{c['bound_ms']}")
        print(f"  {name}: " + " | ".join(cells))
    for key in ("train_fwd_ms", "prefill_ms", "train_bwd_ms", "train_bwd_bf16_ms", "pair_ms",
                "add_ms", "addcmul_ms"):
        bound = runs[0].get(key.replace("_ms", "_bound_ms"))
        print(f"{key}: " + " ".join(str(r[key]) for r in runs)
              + ("" if bound is None else f" (bound {bound})"))
    if all("hyb_step" in r for r in runs):
        for key in ("step_ms", "tokens_per_s", "mfu", "peak_gb", "lru_fwd_traced_ms",
                    "lru_bwd_traced_ms", "traced_ms", "idle_share", "launches_per_step"):
            print(f"phase 5e {key}: " + " ".join(str(r["hyb_step"][key]) for r in runs))
    by_tree: dict = {}
    for r in runs:
        by_tree.setdefault(r["tree"], set()).add(json.dumps(r["digests"], sort_keys=True))
    print("the forward's and backward's bits at the training shape equal across the runs of "
          "each tree: " + ", ".join(f"{t}: {len(d) == 1}" for t, d in by_tree.items()))


def attn_summary(runs: list[dict]) -> None:
    """Each case's times by run, whether the runs' bits agree, and phase 5g's
    numbers."""
    print("attention ms by case, forward / with lse / backward [the kernels' device time, "
          "forward / backward] (SDPA forward / backward); runs: "
          + ", ".join(r["tree"] for r in runs))
    for label in dict.fromkeys(k for r in runs for k in r["attn"]):
        cells = []
        for r in runs:
            c = r["attn"].get(label, {})
            cell = (f"{c.get('fwd_ms')} / {c.get('fwd_lse_ms')} / {c.get('bwd_ms')} [device "
                    f"{c.get('fwd_device_ms')} / {c.get('bwd_device_ms')}]")
            if "sdpa_fwd_ms" in c:
                cell += f" ({c['sdpa_fwd_ms']} / {c['sdpa_bwd_ms']})"
            cells.append(cell)
        digests = {r["attn"].get(label, {}).get("digest") for r in runs}
        print(f"  {label}: " + " | ".join(cells)
              + f"; bits {'agree' if len(digests) == 1 else 'differ'} across runs")
    if any("au_step" in r for r in runs):
        print("phase 5g by run:")
        for key in ("step_ms", "tokens_per_s", "mfu", "peak_gb", "attn_fwd_traced_ms",
                    "attn_bwd_traced_ms", "traced_ms", "idle_share", "launches_per_step"):
            print(f"  {key}: " + " ".join(str(r.get("au_step", {}).get(key)) for r in runs))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]), *argv[2:])))
        return 0
    what = "bag"
    if argv[:1] in (["--gmm"], ["--gmm-moe"], ["--scan"], ["--scan-ssm"], ["--lru"],
                    ["--lru-hyb"], ["--attn"], ["--attn-au"], ["--bits"], ["--overhead"]):
        what, argv = argv[0][2:], argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(argv[1:]):
        log = out.parent / f"{out.stem}.{i}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--one", tree, what], stdout=f,
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
    if what in ("scan", "scan-ssm"):
        scan_summary(runs)
        return 0
    if what in ("lru", "lru-hyb"):
        lru_summary(runs)
        return 0
    if what in ("attn", "attn-au"):
        attn_summary(runs)
        return 0
    if what == "bits":
        return bits_summary(runs)
    if what == "overhead":
        overhead_summary(runs)
        return 0
    if what != "bag":
        gmm_summary(runs)
        return 0
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
