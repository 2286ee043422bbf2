#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name and power limit (``nvidia-smi``), its torch name
   and the device count;
2. build: every CUDA kernel of the serving and training paths, from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started together),
   with ptxas's registers, shared memory, spills and wgmma serialisation
   warnings for each kernel; the warp-specialised wgmma kernels (attention
   forward, the attention backward's dk/dv and dq, the grouped matmul) must
   report the 168 registers their setmaxnreg split (240 x 256 + 24 x 128) is
   sized for (the forward's lse store included), and the skinny grouped
   matmul, the Mamba scan and every attention backward kernel must not spill;
3. kernels vs their plain PyTorch versions at the serving shapes, with times
   beside the bound and beside one PyTorch library call where one computes
   the same function, each case printing the tiling that served it (wgmma
   for bf16/fp16, fma for fp32, skinny for C <= 16), and the bf16 serving
   shapes also timed on the fma tiling: flash attention at granite-8b's and
   qwen3-moe-30b-a3b's attention (B=4, H=32, KV=8 or 4, D=128; S=1000 and
   2048) and at recurrentgemma-9b's (B=4, H=16, KV=1, S=2048, D=256, window
   2048), in bf16, fp16 and fp32, at hubert-xlarge's (B=4, H=KV=16, S=1000,
   D=80, both ways; a 128-wide compute on wgmma) and at llama-3.2-vision-11b's
   cross-attention (H=32, KV=8, Sq=1000, Sk=1601, D=128, unmasked), and at
   ragged edges of the 128-row q and 64-row k tiles (Sq = Sk = 127, 129;
   Sq != Sk; D = 128 and 80), and with rows that see no key (Sq 256, Sk 200,
   window 16) on both tilings; the grouped matmul at
   qwen3-moe-30b-a3b's expert products (E=128; C=312 at prefill in bf16,
   fp16 and fp32, C=1 at decode with every expert filled) and around its
   128 x 256 tiles (C = 129; D = 72, F = 136), and on a decode step's own
   buffers (``layers.moe`` at 4 requests: most experts' rows zero), timed
   against a bound that counts only the live experts' weights, with the
   live experts printed; the Mamba selective scan at
   falcon-mamba-7b's prefill (B=4, L=1000, DI=8192, ST=16) and the RG-LRU
   scan at recurrentgemma-9b's (B=4, L=2048, D=4096), each also at a ragged
   shape, and the embedding bag on the paper DLRM's tables (T=8, R=1e7,
   E=128, fp32: 40.96 GB) at its serving lookup (B=128, one id a bag), at
   B=4096, at a multi-hot shape (B=4096, 32 ids a bag), with bf16 tables,
   ids near the end of every table (offsets past 2^31) and ids past it
   (clamped and wrapped), and on ragged tables (E=13, int64 ids); then
   narrow fp32 granite, MoE, Mamba, Griffin and DLRM models on the card
   against the same models on the CPU, and a narrow fp32 VLM (head dim 128,
   two super-blocks, cross gates opened) and encoder (4 heads of 80); the
   attention backward and the forward's lse against autograd of the plain
   version (fp32) at minicpm-2b's training shape (B=4, H=KV=36, S=4096,
   D=64, causal, bf16), granite-8b's (H=32, KV=8, S=2048, D=128), in fp32
   on the fma forward and at a ragged non-causal shape, bf16 inputs on both
   backward tilings (wgmma and fma), timed beside SDPA's backward and the
   bound, and at the training shape the plain forward and SDPA's forward
   beside the forward kernel; and a narrow fp32 train step (head dim 64, 2
   layers, MHA and GQA) on the card against the CPU: loss, every gradient,
   AdamW's arithmetic and the parameters after one SGD step;
4. serve granite-8b at full width and depth in bf16 through
   ``repro_torch.launch.serve.generate`` (4 requests, prompt 1000, 16 decode
   steps), counting kernel launches (every prefill attention on the wgmma
   tiling), and hold its prefill against prefill-then-decode, which attends
   in plain PyTorch;
4b. serve qwen3-moe-30b-a3b the same way at full width and depth (30.5 B
   parameters in bf16), counting both kernels' launches in the prefill and
   in the decode loop (prefill attention and grouped matmuls on the wgmma
   tiling, decode grouped matmuls on the skinny one), then hold its first
   MoE layer on the card in bf16
   against the same layer on the CPU in fp32;
4c. serve falcon-mamba-7b the same way (64 Mamba layers, a selective-scan
   launch in each at prefill, plain steps at decode), and hold its prefill
   against prefill(S-1) plus a decode step;
4d. serve recurrentgemma-9b the same way at a 2048-token prompt, its
   attention window (26 RG-LRU scans and 12 flash-attention launches per
   prefill), and hold prefill(2049) against prefill(2048) plus a decode
   step on the ring-buffer cache;
4e. score the paper's DLRM (``models.dlrm.paper_config(8)``: 8 tables of
   1e7 x 128 fp32, a bottom MLP of 8 x 2048, a top MLP of 16 x 4096) at
   batches 128 and 4096, one embedding-bag launch per forward, and hold its
   logits against a forward whose lookup is the plain version (bitwise) and
   against 16 samples recomputed on the CPU;
4f. serve llama-3.2-vision-11b the same way (1601 image tokens drawn with
   numpy; its 8 cross gates set to 1 first, since tanh(0) = 0 at init
   throws the cross-attention away): 32 self and 8 cross flash-attention
   launches per prefill, all wgmma, none in decode, and prefill(1001)
   against prefill(1000) plus a decode step whose cross-attention is plain;
4g. encode 4 clips of 1000 frames with hubert-xlarge (48 flash-attention
   launches at D = 80 per forward, all wgmma), timing the forward, and hold
   its first layer (bf16, card) against the same layer in fp32 on the CPU;
5. train: a narrow fp32 run through ``train.loop.train`` that fails at step
   4 and resumes from its checkpoint, against an uninterrupted one; then
   minicpm-2b at full width and depth (bf16, fp32 AdamW state, WSD, remat
   "full", loss chunk 1024) for 8 steps of ``batch_for_step`` at 4 x 4096,
   each with 80 forward and 40 backward attention launches, all on the
   wgmma tilings, and no other kernel, with its step time, tokens/s, model
   FLOPs share and peak memory, then 6 steps on one fixed batch, whose loss
   must fall;
6. plan: the planner (``repro_torch.core``) on the card at the paper's
   128-server scale (degree 4, 100 Gbps links), each result held against
   the same call on the CPU or against the NumPy oracles: (6a) pricing 256
   pool demands of the paper's jobs with ``TorchPlanEvaluator`` (within
   1e-9 of the NumPy evaluator, two calls bitwise equal; its device busy
   time, wall time and idle share, beside one ``index_put_(accumulate=True)``
   over the same stream, the design it is held against); (6b) the flat and
   grid chain programs at the fused admission's shape (V of 4 candidates x
   4 tenants x 64 strategies x 416 links, the ladder 0.05-0.4, 16 chains,
   200 iterations) index for index against ``run_chains_reference`` /
   ``run_grid_reference`` on their first 4 chains, energies at rtol 1e-12,
   two runs bitwise equal; (6c) ``alternating_optimize`` of DLRM through
   its defaults, which plan on the card (2 rounds, 200 iterations, 32
   chains, pool 64), with the plan of the same
   call on the CPU (strategy ``hybrid``, topology, ``iter_time`` to the
   bit), and CANDLE staying ``dp``; (6d) the fused four-tenant admission
   ``co_optimize_jobset`` over 4 placements (16 chains, the default ladder,
   2 rounds) with the CPU's plan.  It prints wall times beside the NumPy
   backend's, and the chain programs' device time, launches and idle share
   (``torch.profiler``);
7. the script's wall time, one JSON line of per-kernel numbers, the
   ``nvidia-smi`` line, and the result line ``{"ok": true, "device": {...}}``
   last.

Each serving phase, and the training run, sets every kernel's launch count
to 0 just before its run and reads the counts just after.  Times come from CUDA events (kernels)
or the host clock after a synchronise (serving).  Bounds use the H100 SXM's
published peaks at 700 W: 989 TFLOP/s bf16/fp16 dense, 67 TFLOP/s fp32
without tensor cores, 3.35 TB/s; exps run on the special-function units,
16 a clock on each SM beside the 128 fp32 lanes, so at 1/8 of 67e12 / 2.
"""

from __future__ import annotations

import dataclasses
import gc
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
SFU_EXP_PER_S = PEAK_FLOPS[torch.float32] / 2 / 128 * 16  # 4.19e12 exps/s
# bf16/fp16: tests/test_kernels.py's fp16 bar.  fp32: sums of up to 2048
# terms run in another order on the card than in the plain version.
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
B, H, KV, D = 4, 32, 8, 128  # granite-8b's attention at the serving batch
PROMPT, DECODE_STEPS = 1000, 16
E_MOE, D_MOE, F_MOE = 128, 2048, 768  # qwen3-moe-30b-a3b's experts
C_PREFILL = int(1.25 * B * PROMPT * 8 / E_MOE)  # 312: capacity at the serving prefill
DI_MAMBA, ST_MAMBA, R_MAMBA = 8192, 16, 256  # falcon-mamba-7b's scan
PROMPT_RG, D_RG = 2048, 4096  # recurrentgemma-9b: prompt = attention window; LRU width
IMG_TOKENS = 1601  # llama-3.2-vision-11b's image: 1 CLS + 40 x 40 patches
H_AU, D_AU = 16, 80  # hubert-xlarge's heads (KV = H) and head dim
# Attention cases (Sq, Sk, D, dtype, causal, window, KV, H) of the new paths:
# hubert-xlarge's encoder at 1000 frames in bf16, fp16 and fp32, and
# llama-3.2-vision-11b's cross-attention from the prompt to the image.
HUBERT_CASES = tuple((PROMPT, PROMPT, D_AU, dt, False, 0, H_AU, H_AU)
                     for dt in (torch.bfloat16, torch.float16, torch.float32))
CROSS_CASE = (PROMPT, IMG_TOKENS, D, torch.bfloat16, False, 0, KV, H)
KERNEL_COUNTERS = ("attention_launches", "attention_bwd_launches", "grouped_matmul_launches",
                   "selective_scan_launches", "lru_scan_launches", "bag_lookup_launches")
# The same launches again, by the tiling that served them.
TILING_COUNTERS = ("attention_wgmma_launches", "attention_fma_launches",
                   "attention_bwd_wgmma_launches", "attention_bwd_fma_launches",
                   "grouped_matmul_wgmma_launches", "grouped_matmul_fma_launches",
                   "grouped_matmul_skinny_launches")
COUNTERS = KERNEL_COUNTERS + TILING_COUNTERS
T_DLRM, R_DLRM, E_DLRM = 8, 10_000_000, 128  # the paper DLRM's tables, one host's 8 of 64
DLRM_BATCHES = (128, 4096)  # workloads.DLRM.batch_per_gpu, and a large scoring batch
DLRM_PATH = "dlrm-paper-8t"
# Training (phase 5): minicpm-2b at full width and depth, TRAIN_4K's sequence
# and its global batch of 256 cut to 4 for one card; the chunked loss.
TRAIN_ARCH, TRAIN_B, TRAIN_S, LOSS_CHUNK = "minicpm-2b", 4, 4096, 1024
TRAIN_STEPS, FIXED_STEPS, TRAIN_LR = 8, 6, 3e-4
# The backward kernel's cases (B, H, KV, S, D, dtype, causal): minicpm-2b's
# and granite-8b's training attention (the first is the main path's), one
# fp32 case on the fma forward, and a ragged non-causal one.
BWD_CASES = (
    (TRAIN_B, 36, 36, TRAIN_S, 64, torch.bfloat16, True),
    (TRAIN_B, 32, 8, 2048, 128, torch.bfloat16, True),
    (TRAIN_B, 36, 36, 1024, 64, torch.float32, True),
    (TRAIN_B, 36, 36, 1000, 64, torch.bfloat16, False),
)


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Per kernel in an ``nvcc -Xptxas -v`` log: registers, static shared
    memory, spill bytes and whether ptxas serialised its wgmma instructions
    (warning C7512).  Kernels are named by their unmangled base and template
    arguments as they appear in the mangled name."""
    import re

    def short(mangled):
        m = re.search(r"([a-z_]+_kernel)(I.*?E)E?v", mangled)
        return m.group(1) + m.group(2) if m else mangled

    out: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = short(m.group(1))
            out.setdefault(fn, dict(registers=None, smem=0, spill_stores=0, spill_loads=0,
                                    serialised=False))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
            out[fn]["smem"] = int(m.group(2) or 0)
        m = re.search(r"C7512.*function '(\w+)'", line)
        if m:
            out.setdefault(short(m.group(1)), dict(registers=None, smem=0, spill_stores=0,
                                                   spill_loads=0, serialised=False))
            out[short(m.group(1))]["serialised"] = True
    return out


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
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


def attention_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """Least time for the card: the larger of operations over the dtype's peak
    and bytes (q, k, v read once, the output written once) over 3.35 TB/s.
    Operations count the (query, key) pairs the mask keeps on these shapes."""
    from repro_torch.kernels.ref import attention_mask

    Bq, Hq, Sq, Dq = q.shape
    pairs = int(attention_mask(Sq, k.shape[2], causal, window, q.device).sum())
    flops = 4.0 * Bq * Hq * Dq * pairs  # q.k and p.v: 2 flops per multiply-add each
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def gmm_bound(x, w) -> tuple[float, str, int]:
    """Least time for the card: x read once, the weights of each expert that
    holds a non-zero row of x read once, and the (E, C, F) output written
    once, against 2*D*F operations for each non-zero row, over the dtype's
    peak.  An expert whose rows are all zero needs no weight (0 * w = 0 for
    finite w): the work depends on the data.  Also the live experts."""
    E, C, Dx = x.shape
    F = w.shape[2]
    nonzero_rows = x.ne(0).any(dim=-1)  # (E, C)
    live = int(nonzero_rows.any(dim=-1).sum())
    flops = 2.0 * int(nonzero_rows.sum()) * Dx * F
    nbytes = (x.numel() + live * Dx * F + E * C * F) * x.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", live


def mamba_bound(xc, dt, a, b, c, d_skip) -> tuple[float, str, float, float]:
    """Least time for the card: the larger of the bytes (each input read once,
    b and c only where the scan reads them, y and h written once) over
    3.35 TB/s and the B*L*DI*ST exps over the SFU rate.  Also both times."""
    Bm, L, DI = xc.shape
    ST = a.shape[1]
    nbytes = (xc.numel() * xc.element_size() + (dt.numel() + a.numel() + d_skip.numel()) * 4
              + (b.numel() + c.numel()) * b.element_size() + (Bm * L * DI + Bm * DI * ST) * 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, Bm * L * DI * ST / SFU_EXP_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            t_bytes * 1e3, t_ops * 1e3)


def lru_bound(a, b) -> tuple[float, str]:
    """Least time for the card: a and b read once and h_all and h_final (fp32)
    written once, against 2 flops a step and lane over the fp32 peak."""
    Bm, L, Dl = a.shape
    nbytes = (a.numel() + b.numel()) * a.element_size() + (Bm * L * Dl + Bm * Dl) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2.0 * Bm * L * Dl / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bag_bound(tables, ids, out) -> tuple[float, str, int]:
    """Least time for the card: the distinct rows the ids select (after the
    clamp and wrap) read once, the ids read once and the output written once
    over 3.35 TB/s, against one fp32 add per value summed.  Also the rows."""
    T, R, E = tables.shape
    rows = ids.long()
    rows = torch.where(rows < 0, rows + R, rows).clamp_(0, R - 1)
    rows = rows + torch.arange(T, device=ids.device)[None, :, None] * R
    n_rows = int(torch.unique(rows).numel())
    nbytes = (n_rows * E * tables.element_size() + ids.numel() * ids.element_size()
              + out.numel() * out.element_size())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ids.numel() * E / PEAK_FLOPS[torch.float32]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", n_rows


def mamba_inputs(gen, Bm, L, DI, ST, dtype, R=None):
    """Inputs as the Mamba layer makes them: dt in softplus's range near
    0.01, A = -(1..ST) per channel as ``a_log`` starts; with ``R``, b and c
    are the strided slices of one (B, L, R + 2 ST) projection."""
    dev = gen.device
    xc = torch.randn(Bm, L, DI, generator=gen, device=dev).to(dtype)
    dt = torch.rand(Bm, L, DI, generator=gen, device=dev) * 0.099 + 0.001
    a = -torch.arange(1, ST + 1, dtype=torch.float32, device=dev).repeat(DI, 1)
    if R is None:
        b = torch.randn(Bm, L, ST, generator=gen, device=dev).to(dtype)
        c = torch.randn(Bm, L, ST, generator=gen, device=dev).to(dtype)
    else:
        xdbc = torch.randn(Bm, L, R + 2 * ST, generator=gen, device=dev).to(dtype)
        b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    return xc, dt, a, b, c, torch.randn(DI, generator=gen, device=dev)


def narrow_config(get_config, arch):
    """An arch's smoke config widened to d_model 256 and head dim 64 (the
    attention kernel's smallest; the VLM 128, the encoder 80 at d_model
    320), in fp32."""
    over = dict(d_model=256, param_dtype="float32", activation_dtype="float32")
    if arch == "granite-8b":
        over.update(n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512)
    elif arch == "qwen3-moe-30b-a3b":  # 8 experts at capacity 1.0: prefill drops entries
        over.update(n_heads=4, n_kv_heads=2, head_dim=64, d_ff=128, n_experts=8, top_k=2,
                    capacity_factor=1.0)
    elif arch == "falcon-mamba-7b":
        over.update(ssm_state=16, dt_rank=16)
    elif arch == "llama-3.2-vision-11b":  # two super-blocks of 4 self + 1 cross layer
        over.update(n_heads=4, n_kv_heads=2, head_dim=128, d_ff=512, n_layers=10,
                    cross_attn_every=5, img_tokens=100)
    elif arch == "hubert-xlarge":
        over.update(d_model=320, n_heads=4, n_kv_heads=4, head_dim=D_AU, d_ff=640, n_layers=2)
    else:  # recurrentgemma-9b: a 32-token window, which the 77-token prompts pass
        over.update(n_heads=4, n_kv_heads=1, head_dim=64, d_ff=512, lru_width=256,
                    attn_window=32)
    return dataclasses.replace(get_config(arch).smoke(), **over)


def served(lm, ops, generate, model, tokens, image_embeds=None):
    """``generate`` with every launch count set to 0 just before it and read
    just after, and again after the prefill; each step's logits are kept and
    checked after the run, so the loop never waits on the card.  The peak
    memory statistic is reset just before it too: the peak it leaves is the
    request's, not the random init's (whose fp32 draws are transients that
    loaded bf16 weights do not have).  Returns (ids, timings, prefill counts,
    decode-loop counts, logits)."""
    seen: dict = {"logits": []}
    real_prefill, real_decode = lm.prefill, lm.decode_step

    def counted_prefill(*args, **kwargs):
        logits, cache = real_prefill(*args, **kwargs)
        seen["prefill"] = {n: getattr(ops, n) for n in COUNTERS}
        seen["logits"].append(logits)
        return logits, cache

    def kept_decode(*args, **kwargs):
        logits, cache = real_decode(*args, **kwargs)
        seen["logits"].append(logits)
        return logits, cache

    lm.prefill, lm.decode_step = counted_prefill, kept_decode
    try:
        for n in COUNTERS:
            setattr(ops, n, 0)
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        ids = generate(model, tokens, DECODE_STEPS, timings, image_embeds)
        total = {n: getattr(ops, n) for n in COUNTERS}
    finally:
        lm.prefill, lm.decode_step = real_prefill, real_decode
    decode = {n: total[n] - seen["prefill"][n] for n in COUNTERS}
    return ids, timings, seen["prefill"], decode, seen["logits"]


def check_served(cfg, ids, logits) -> None:
    require(len(logits) == DECODE_STEPS, "one logits tensor per generated token")
    require(all(bool(torch.isfinite(t).all()) for t in logits), f"finite {cfg.name} logits")
    require(tuple(ids.shape) == (B, DECODE_STEPS), f"generated ids shape {tuple(ids.shape)}")
    require(bool(((ids >= 0) & (ids < cfg.vocab)).all()), "generated ids in the vocabulary")


def open_gates(model, value: float = 1.0) -> list:
    """Sets every cross block's gate to ``value`` and returns the gates: at
    init they are 0, and tanh(0) = 0 throws the cross-attention away, so no
    check could see it."""
    gates = [p for n, p in model.named_parameters() if n.endswith(".attn.gate")]
    for g in gates:
        g.fill_(value)
    return gates


def check_narrow_model(lm, cfg, dev, batch, label) -> dict:
    """A narrow fp32 model on the card against the same weights on the CPU:
    forward, prefill (logits and every cache entry) and, but for an encoder,
    two decode steps.  A VLM's cross gates are opened first."""
    m_cpu = lm.init(0, cfg, device="cpu")
    open_gates(m_cpu)
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    fc, _ = lm.forward(m_cpu, batch, cfg)
    fg, _ = lm.forward(m_gpu, gpu_batch, cfg)
    S = next(iter(batch.values())).shape[1]
    lc, cc = lm.prefill(m_cpu, batch, cfg, pad_to=S + 2)
    lg, cg = lm.prefill(m_gpu, gpu_batch, cfg, pad_to=S + 2)
    errs = {"forward": float((fg.cpu() - fc).abs().max()),
            "prefill": float((lg.cpu() - lc).abs().max())}
    errs.update({f"cache {n}": float((cg[n].cpu() - cc[n]).abs().max()) for n in cc})
    for pos in () if cfg.is_encoder else (S, S + 1):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(m_cpu, {"token": tok, "pos": pos, "cache": cc}, cfg)
        lg, cg = lm.decode_step(m_gpu, {"token": tok.to(dev), "pos": pos, "cache": cg}, cfg)
        errs[f"decode@{pos}"] = float((lg.cpu() - lc).abs().max())
    require(max(errs.values()) <= 1e-4, f"narrow {label}, card vs CPU: {errs}")
    return errs


def dispatch_like(x, gen):
    """Zeroes the rows of an (E, C, D) buffer past each expert's count, as
    the MoE layer's dispatch leaves them: counts from 4000 tokens' top-8 of
    128 random scores, capped at C."""
    E, C, _ = x.shape
    top = torch.rand(B * PROMPT, E, generator=gen, device=x.device).topk(8, dim=-1).indices
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, top.reshape(-1), torch.ones_like(top.reshape(-1)))
    rows = torch.arange(C, device=x.device)[None, :] < counts.clamp(max=C)[:, None]
    return x * rows[..., None].to(x.dtype)


def moe_decode_buffers(layers, ops, cfg, dev, gen):
    """What ``layers.moe`` passes to the grouped matmul at one decode step of
    the B served requests (one token each) on a full-width MoE layer of
    ``cfg`` with random weights (seed 0): [("gate", x (E, 1, D), wg),
    ("down", h (E, 1, F), wd)].  Experts that no token picked hold zero rows."""
    moe = layers.MoE(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randn(B, 1, cfg.d_model, generator=gen, device=dev).to(moe.wg.dtype)
    x = layers.rms_norm(tokens, moe.norm)
    seen = []
    real = ops.grouped_matmul

    def capture(xb, w):
        seen.append((xb, w))
        return real(xb, w)

    ops.grouped_matmul = capture
    try:
        layers.moe(moe, x, cfg)
    finally:
        ops.grouped_matmul = real
    (xg, wg), _, (hd, wd) = seen
    return [("gate", xg, wg), ("down", hd, wd)]


def attention_bwd_bound(q, k, causal: bool) -> tuple[float, str]:
    """Least time for the card: 5 products of 2*D flops a kept (query, key)
    pair (half the pairs under a causal mask) over the dtype's peak, against
    q, k, v, o, do and lse read once and dq, dk, dv written once over
    3.35 TB/s."""
    from repro_torch.kernels.ref import attention_mask

    Bq, Hq, Sq, Dq = q.shape
    pairs = int(attention_mask(Sq, k.shape[2], causal, 0, q.device).sum())
    flops = 10.0 * Bq * Hq * Dq * pairs
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + Bq * Hq * Sq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def plain_attention_grads(ref_flash_attention, q, k, v, do, causal: bool):
    """Autograd of the plain version in fp32, one batch row at a time: the
    fp32 scores of a row of minicpm-2b's shape (36 x 4096 x 4096) take 2.4 GB
    and autograd keeps several such tensors."""
    grads = []
    for b in range(q.shape[0]):
        qf, kf, vf = (t[b:b + 1].float().requires_grad_(True) for t in (q, k, v))
        out = ref_flash_attention(qf, kf, vf, causal=causal)
        grads.append(torch.autograd.grad(out, (qf, kf, vf), do[b:b + 1].float()))
    return [torch.cat(g) for g in zip(*grads)]


def check_attention_bwd(case, gen, dev, smi) -> dict:
    """Phase 3: the forward's lse against the plain one and the backward
    kernel against autograd of the plain version (fp32) on the same inputs,
    on the tiling that serves the dtype and, for bf16/fp16 inputs, on the fma
    tiling too, with times: each tiling, the forward with and without lse,
    plain, SDPA's backward (a yardstick only) and the bound.  At the main
    path's shape (``train_shape``) also the plain forward and SDPA's
    forward, row 1's yardsticks at the training shape."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_tiling, attention_tiling, flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.ref import ref_flash_attention, ref_flash_attention_lse

    Bc, Hc, KVc, S, Dc, dtype, causal = case
    q = torch.randn(Bc, Hc, S, Dc, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(Bc, KVc, S, Dc, generator=gen, device=dev).to(dtype) for _ in "kv")
    do = torch.randn(Bc, Hc, S, Dc, generator=gen, device=dev).to(dtype)
    lse = torch.empty(Bc, Hc, S, dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, causal=causal, lse=lse)
    tiling = attention_bwd_tiling(dtype, Dc)
    tilings = (tiling, "fma") if tiling != "fma" else (tiling,)
    grads = {t: flash_attention_bwd(q, k, v, o, lse, do, causal, tiling=t) for t in tilings}
    torch.cuda.synchronize()
    label = (f"B={Bc} H={Hc} KV={KVc} S={S} D={Dc} {str(dtype)[6:]} causal={causal} "
             f"forward tiling={attention_tiling(dtype, Dc)}")
    ref_lse = torch.cat([ref_flash_attention_lse(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal)
                         for b in range(Bc)])
    lse_err = float((lse - ref_lse).abs().max())
    lse_tol = 1e-4 * max(1.0, float(ref_lse.abs().max()))
    require(lse_err <= lse_tol, f"forward lse vs plain, {label}: max|err| {lse_err} > {lse_tol}")
    want = plain_attention_grads(ref_flash_attention, q, k, v, do, causal)
    errs, bars = {t: {} for t in tilings}, {}
    for t in tilings:
        for name, got, ref in zip(("dq", "dk", "dv"), grads[t], want):
            require(bool(torch.isfinite(got).all()), f"finite {name}, {label}, tiling {t}")
            errs[t][name] = float((got.float() - ref).abs().max())
            bars[name] = TOL[dtype] * float(ref.abs().max())
            require(errs[t][name] <= bars[name],
                    f"flash_attention_bwd {name} vs autograd of plain, {label}, tiling {t}: "
                    f"max|err| {errs[t][name]} > {bars[name]} ({TOL[dtype]} max|ref|)")
    del want, grads
    kernel_ms = {t: time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, tiling=t),
                            10) for t in tilings}
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), 10)
    fwd_lse_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, lse=lse), 10)
    plain_ms = time_ms(
        lambda: plain_attention_grads(ref_flash_attention, q, k, v, do, causal), 2, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                                           enable_gqa=True)
    library_ms = time_ms(
        lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True), 10)
    del out, qr, kr, vr
    bound_ms, bound_by = attention_bwd_bound(q, k, causal)
    extra = {}
    if tiling != "fma":
        extra = dict(fma_kernel_ms=kernel_ms["fma"], fma_max_abs_err=max(errs["fma"].values()))
    fwd_yardsticks = ""
    if case == BWD_CASES[0]:  # the training forward: plain (a batch row at a time) and SDPA
        extra["fwd_plain_ms"] = time_ms(lambda: [ref_flash_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal) for b in range(Bc)], 2, warmup=1)
        extra["fwd_library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 10)
        fwd_yardsticks = (f", plain forward {extra['fwd_plain_ms']} ms (a batch row at a time), "
                          f"SDPA's forward {extra['fwd_library_ms']} ms")
    print(f"phase 3 kernel: flash_attention_bwd {label}: lse max|err| {lse_err} (tol {lse_tol}); "
          f"max|err| by tiling {errs} (bars {bars}) kernel_ms by tiling {kernel_ms} plain_ms "
          f"{plain_ms} (autograd of the plain version, fp32, a batch row at a time) library_ms "
          f"{library_ms} (SDPA's backward) bound_ms {bound_ms} ({bound_by}; 7 products where "
          f"the bound counts 5, so at most 5/7 of its rate); forward {fwd_ms} ms, with lse "
          f"{fwd_lse_ms} ms{fwd_yardsticks}; on {smi}")
    return dict(tiling=tiling, max_abs_err=max(errs[tiling].values()),
                max_abs_err_by_grad=errs[tiling], lse_max_abs_err=lse_err,
                kernel_ms=kernel_ms[tiling], plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms, **extra)


def train_config(get_config, kv: int):
    """minicpm-2b's smoke config (tied embeddings, vocab 256) at d_model 256,
    2 layers of 4 heads of 64 (MHA at kv = 4, GQA at kv = 2), in fp32."""
    return dataclasses.replace(
        get_config(TRAIN_ARCH).smoke(), d_model=256, n_heads=4, n_kv_heads=kv, head_dim=64,
        d_ff=512, n_layers=2, param_dtype="float32", activation_dtype="float32")


def max_rel_err(got: dict, want: dict) -> float:
    """max over the names of max|got - want| / max|want|."""
    return max(float((got[n].detach().cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for n, w in want.items())


def check_train_step(lm, make_train_step, optim, ops, cfg, dev) -> dict:
    """Phase 3 model: the loss and every gradient of a narrow fp32 model on
    the card (the attention kernels, forward and backward) against the same
    model on the CPU (plain versions), then one ``make_train_step`` on each.
    The step uses SGD with momentum, whose update is linear in the gradient,
    so the parameters' bar follows from the gradients'; AdamW's update,
    about lr * sign(g) at step 0, turns a gradient entry within rounding of
    0 into a 2 lr difference, so AdamW is held on the card to the CPU's
    arithmetic on the same gradients instead."""
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks}
    gpu_batch = {"tokens": toks.to(dev)}
    for m in (m_cpu, m_gpu):
        m.requires_grad_(True)
    lc, _ = lm.loss_fn(m_cpu, batch, cfg, loss_chunk=32)
    grads_cpu = dict(zip(dict(m_cpu.named_parameters()),
                         torch.autograd.grad(lc, list(m_cpu.parameters()))))
    for n in COUNTERS:
        setattr(ops, n, 0)
    lg, _ = lm.loss_fn(m_gpu, gpu_batch, cfg, loss_chunk=32)
    grads_gpu = dict(zip(dict(m_gpu.named_parameters()),
                         torch.autograd.grad(lg, list(m_gpu.parameters()))))
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=2 * cfg.n_layers, attention_fma_launches=2 * cfg.n_layers,
                attention_bwd_launches=cfg.n_layers,  # remat "full": forward twice
                attention_bwd_fma_launches=cfg.n_layers)  # fp32: exact products
    require(counts == want, f"narrow train step launches {counts}, want {want}")
    errs = {"loss": abs(float(lg.detach()) - float(lc.detach())) / abs(float(lc.detach())),
            "grads": max_rel_err(grads_gpu, grads_cpu)}
    # AdamW's arithmetic on the card, on the CPU's gradients.
    opt = optim.adamw(optim.wsd(1e-3, 10))
    params_cpu = {n: p.detach().clone() for n, p in m_cpu.named_parameters()}
    params_gpu = {n: p.to(dev) for n, p in params_cpu.items()}
    state_cpu, state_gpu = opt.init(params_cpu), opt.init(params_gpu)
    for step in range(2):
        opt.update(grads_cpu, state_cpu, params_cpu, step)
        opt.update({n: g.to(dev) for n, g in grads_cpu.items()}, state_gpu, params_gpu, step)
    errs["adamw update, same grads"] = max_rel_err(params_gpu, params_cpu)
    # One train step each, SGD with momentum.
    sgd = optim.sgd_momentum(optim.constant(0.1))
    step_fn = make_train_step(cfg, sgd, loss_chunk=32)
    _, _, mc = step_fn(m_cpu, sgd.init(dict(m_cpu.named_parameters())), batch, 0)
    _, _, mg = step_fn(m_gpu, sgd.init(dict(m_gpu.named_parameters())), gpu_batch, 0)
    errs["step loss"] = abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    errs["step grad_norm"] = (abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
                              / float(mc["grad_norm"]))
    errs["step params"] = max_rel_err(dict(m_gpu.named_parameters()),
                                      {n: p.detach() for n, p in m_cpu.named_parameters()})
    require(max(errs.values()) <= 1e-4, f"narrow train step, card vs CPU: {errs} (tol 1e-4)")
    return errs


def resume_check(train_loop, optim, cfg, dev) -> dict:
    """Phase 5 resume: ``train.loop.train`` on the card with a checkpoint
    every 2 steps and an injected failure at step 4, resumed to step 8,
    against an uninterrupted run; the checkpoints go to a temporary
    directory under ``build/`` and are removed."""
    import tempfile

    from repro_torch.configs.base import ShapeSpec

    shape = ShapeSpec("resume", 64, 4, "train")
    opt = optim.adamw(optim.wsd(1e-3, 8))
    quiet = dict(log_every=100, logger=lambda *a: None, device=dev, loss_chunk=32)
    whole = train_loop.train(cfg, shape, opt, total_steps=8, **quiet)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as ckpt_dir:
        try:
            train_loop.train(cfg, shape, opt, total_steps=8, ckpt_dir=ckpt_dir, ckpt_every=2,
                             fail_at=4, **quiet)
            raise RuntimeError("chip_smoke: the injected failure did not happen")
        except train_loop.InjectedFailure:
            pass
        resumed = train_loop.train(cfg, shape, opt, total_steps=8, ckpt_dir=ckpt_dir,
                                   ckpt_every=2, **quiet)
    require(resumed.final_step == 8 and len(resumed.losses) == 4,
            f"resumed from step 4: final {resumed.final_step}, {len(resumed.losses)} losses")
    errs = [abs(a - b) / abs(b) for a, b in zip(resumed.losses, whole.losses[4:])]
    require(max(errs) <= 1e-5, f"resumed losses {resumed.losses} vs {whole.losses[4:]}: {errs}")
    return dict(whole=whole.losses, resumed=resumed.losses, max_rel_err=max(errs))


def train_full(lm, ops, optim, make_train_step, data, cfg, dev, smi) -> dict:
    """Phase 5: trains minicpm-2b at full width and depth on the card (bf16,
    fp32 AdamW state, WSD) for TRAIN_STEPS steps of ``batch_for_step`` at
    TRAIN_B x TRAIN_S, then FIXED_STEPS steps on one fixed batch, with remat
    "full" and the chunked loss.  Every count is set to 0 just before the
    TRAIN_STEPS steps and read just after.  Returns the numbers of the run."""
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs.base import ShapeSpec

    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    opt = optim.adamw(optim.wsd(TRAIN_LR, TRAIN_STEPS + FIXED_STEPS))
    params = dict(model.named_parameters())
    state = opt.init(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    state_gb = sum(t.numel() * t.element_size() for group in state.values()
                   for t in group.values() if t.data_ptr() not in
                   {p.data_ptr() for p in params.values()}) / 1e9
    print(f"phase 5 train: {cfg.name} init on the card: {n_params} parameters ({cfg.param_dtype}, "
          f"{n_params * 2 / 1e9} GB), AdamW state m, v, fp32 master {state_gb} GB, in "
          f"{time.perf_counter() - t0:.2f} s; batch {TRAIN_B} x {TRAIN_S}, remat full, loss chunk "
          f"{LOSS_CHUNK}, lr {TRAIN_LR} (wsd)")
    step_fn = make_train_step(cfg, opt, remat="full", loss_chunk=LOSS_CHUNK)
    spec = data.DataSpec(cfg=cfg, shape=ShapeSpec("train_4k_b4", TRAIN_S, TRAIN_B, "train"))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_for_step(spec, i).items()}
               for i in range(TRAIN_STEPS + 1)]
    probe = {n: params[n].detach().clone() for n in ("embed", "blocks.0.attn.wq", "final_norm")}
    torch.cuda.synchronize()

    for n in COUNTERS:
        setattr(ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, per_step = [], [], [], []
    for step in range(TRAIN_STEPS):
        before = {n: getattr(ops, n) for n in COUNTERS}
        t0 = time.perf_counter()
        _, _, metrics = step_fn(model, state, batches[step], step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        per_step.append({n: getattr(ops, n) - before[n] for n in COUNTERS})
        print(f"phase 5 train: step {step} loss {losses[-1]} grad_norm {norms[-1]} "
              f"{times[-1] * 1e3} ms")
    counts = {n: getattr(ops, n) for n in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L_ = cfg.n_layers
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=2 * L_, attention_wgmma_launches=2 * L_,
                attention_bwd_launches=L_, attention_bwd_wgmma_launches=L_)
    require(all(c == want for c in per_step), f"launches per step {per_step}, want {want}")
    require(all(math.isfinite(x) for x in losses + norms), f"finite losses {losses}, norms {norms}")
    ln_v = math.log(cfg.vocab)
    require(abs(losses[0] - ln_v) <= 0.5, f"step 0 loss {losses[0]} not within 0.5 of ln V {ln_v}")
    changed = {n: float((params[n].detach() - t).abs().max()) for n, t in probe.items()}
    require(all(c > 0 for c in changed.values()), f"parameters changed: {changed}")

    step_ms = float(np.median(times)) * 1e3
    tokens = TRAIN_B * TRAIN_S
    pairs = TRAIN_S * (TRAIN_S + 1) // 2
    flops = 6.0 * n_params * tokens + 12.0 * L_ * TRAIN_B * cfg.n_heads * cfg.hd * pairs
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    print(f"phase 5 train: {TRAIN_STEPS} steps, median {step_ms} ms a step (min "
          f"{min(times) * 1e3}, max {max(times) * 1e3}), {tokens / step_ms * 1e3} tokens/s, "
          f"model FLOPs {flops / 1e12} TFLOP a step (6 N T + attention), {mfu} of 989 TFLOP/s, "
          f"peak memory {peak_gb} GB, launches per step {per_step[0]} (total {counts}), on {smi}")

    fixed = []
    for i in range(FIXED_STEPS):
        _, _, metrics = step_fn(model, state, batches[TRAIN_STEPS], TRAIN_STEPS + i)
        fixed.append(float(metrics["loss"]))
    require(all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
            f"{FIXED_STEPS} steps on one fixed batch lower its loss: {fixed}")
    print(f"phase 5 train: {FIXED_STEPS} steps on one fixed batch, losses {fixed}")
    del model, params, state, batches, probe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, step_ms=step_ms, step_ms_all=times,
                tokens_per_s=tokens / step_ms * 1e3, mfu=mfu, peak_gb=peak_gb,
                launches_per_step=per_step[0], counts=counts, fixed_losses=fixed,
                n_params=n_params)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import (
        attention_tiling, first_masked_row, flash_attention,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.moe_gmm import gmm_tiling, moe_gmm
    from repro_torch.kernels.ref import (
        ref_embedding_bag, ref_flash_attention, ref_mamba_scan, ref_moe_gmm, ref_rglru_scan,
    )
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch import optim
    from repro_torch.data import pipeline as data
    from repro_torch.launch.serve import generate
    from repro_torch.models import dlrm, layers, lm
    from repro_torch.train import loop as train_loop
    from repro_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"phase 1 device: nvidia-smi: {smi}")
    print(f"phase 1 device: torch: {kind}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    kernels = ["flash_attention", "flash_attention_bwd", "moe_gmm", "mamba_scan", "rglru_scan",
               "embedding_bag"]
    t0 = time.perf_counter()
    _build.load_all(kernels)
    print(f"phase 2 build: {', '.join(k + '.cu' for k in kernels)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in kernels:
        for fn, info in ptxas_report(_build.build_logs.get(name, "")).items():
            print(f"phase 2 build: ptxas {name}: {fn}: {info['registers']} registers, "
                  f"{info['smem']} bytes static smem, spill stores {info['spill_stores']} "
                  f"loads {info['spill_loads']} bytes, wgmma serialised: {info['serialised']}")
            if "wgmma_kernel" in fn:  # forward, backward (dkdv_, dq_) and grouped matmul
                # setmaxnreg moves registers within the block's launch-time
                # allotment: consumers at 240 and the producer at 24 need 168.
                require(info["registers"] == 168,
                        f"{fn} uses {info['registers']} registers, want the 168 that its "
                        "setmaxnreg split (2 x 128 x 240 + 128 x 24) is sized for")
                require(info["spill_stores"] == info["spill_loads"] == 0
                        and not info["serialised"], f"{fn} spills or serialises: {info}")
            if ("skinny_kernel" in fn or "mamba_scan_kernel" in fn  # the streams and the scan
                    or name == "flash_attention_bwd"):
                require(info["spill_stores"] == info["spill_loads"] == 0 and not info["serialised"],
                        f"{fn} spills: {info}")
    bwd_report = ptxas_report(_build.build_logs.get("flash_attention_bwd", ""))
    if bwd_report:  # built in this run: the checks above saw both tilings' kernels
        for base in ("dkdv_wgmma_kernel", "dq_wgmma_kernel", "dkdv_kernel", "dq_kernel"):
            require(any(fn.startswith(base) for fn in bwd_report), f"ptxas reports no {base}")

    # Phase 3: the kernel against its plain version at the serving shapes.
    gen = torch.Generator(device=dev).manual_seed(0)

    cases = [  # (Sq, Sk, D, dtype, causal, window, KV, H)
        (PROMPT, PROMPT, D, torch.bfloat16, True, 0, KV, H),  # granite-8b's prefill
        (PROMPT, PROMPT, D, torch.float16, True, 0, KV, H),
        (PROMPT, PROMPT, D, torch.float32, True, 0, KV, H),
        (2048, 2048, D, torch.bfloat16, True, 0, KV, H),
        (2048, 2048, D, torch.float32, True, 0, KV, H),
        (PROMPT, PROMPT, 64, torch.bfloat16, True, 128, KV, H),
        (PROMPT, PROMPT, D, torch.bfloat16, False, 0, KV, H),
        (PROMPT, PROMPT, D, torch.bfloat16, True, 0, 4, H),  # qwen3-moe-30b-a3b's prefill
        (PROMPT_RG, PROMPT_RG, 256, torch.bfloat16, True, PROMPT_RG, 1, 16),  # recurrentgemma-9b's
        (PROMPT_RG, PROMPT_RG, 256, torch.float16, True, PROMPT_RG, 1, 16),
        (PROMPT_RG, PROMPT_RG, 256, torch.float32, True, PROMPT_RG, 1, 16),
        # Ragged edges of the 128-row q tiles and 64-row k tiles.
        (127, 127, D, torch.bfloat16, True, 0, KV, H),
        (129, 129, D, torch.bfloat16, True, 0, KV, H),
        (129, 129, 256, torch.float16, True, 64, 1, 16),
        (100, 300, D, torch.bfloat16, False, 0, KV, H),
        (300, 100, 64, torch.bfloat16, True, 0, KV, H),
        *HUBERT_CASES, CROSS_CASE,
        # Head dim 80 at the ragged edges, Sq != Sk among them.
        (127, 127, D_AU, torch.bfloat16, True, 0, H_AU, H_AU),
        (129, 129, D_AU, torch.bfloat16, True, 0, H_AU, H_AU),
        (127, 129, D_AU, torch.bfloat16, False, 0, H_AU, H_AU),
        (129, 127, D_AU, torch.float32, False, 0, H_AU, H_AU),
    ]
    attn = {}  # numbers of each case, by its tuple
    for Sq, Sk, dh, dtype, causal, window, kv, h in cases:
        q = torch.randn(B, h, Sq, dh, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, kv, Sk, dh, generator=gen, device=dev).to(dtype) for _ in "kv")
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = ref_flash_attention(q, k, v, causal=causal, window=window)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        tiling = attention_tiling(dtype, dh)
        label = (f"H={h} KV={kv} Sq={Sq} Sk={Sk} D={dh} {str(dtype)[6:]} causal={causal} "
                 f"window={window} tiling={tiling}")
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 20)
        plain_ms = time_ms(lambda: ref_flash_attention(q, k, v, causal=causal, window=window), 5)
        library_ms = fma_ms = None
        # SDPA has no sliding window (a window of S or more is none); a
        # yardstick only, never on the port's path.
        if window == 0 or window >= max(Sq, Sk):
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 20)
        if tiling == "wgmma" and Sq >= PROMPT:  # the earlier tiling, on the same inputs
            fma_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window,
                                                     tiling="fma"), 20)
        bound_ms, bound_by = attention_bound(q, k, causal, window)
        print(f"phase 3 kernel: flash_attention {label}: max|err| {err} (tol {tol}) "
              f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}) fma_ms {fma_ms} on {smi}")
        attn[(Sq, Sk, dh, dtype, causal, window, kv, h)] = dict(
            tiling=tiling, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms)
        del q, k, v, out, ref
    # Rows that see no key (Sq 256, Sk 200, causal, window 16: rows 215 on)
    # take the mean of v over all Sk keys, as in the plain version, on both
    # tilings; the rows that see a key are held to the same bar.
    masked_rows = {}
    for dtype, tiling in ((torch.bfloat16, "wgmma"), (torch.bfloat16, "fma"),
                          (torch.float32, "fma")):
        q = torch.randn(B, H, 256, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, KV, 200, D, generator=gen, device=dev).to(dtype) for _ in "kv")
        out = flash_attention(q, k, v, causal=True, window=16, tiling=tiling)
        torch.cuda.synchronize()
        ref = ref_flash_attention(q, k, v, causal=True, window=16)
        first = first_masked_row(256, 200, True, 16)
        err = float((out.float() - ref.float()).abs().max())
        masked_err = float((out[:, :, first:].float() - ref[:, :, first:].float()).abs().max())
        tol = TOL[dtype]
        label = f"Sq=256 Sk=200 D={D} {str(dtype)[6:]} causal window=16 tiling={tiling}"
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        print(f"phase 3 kernel: flash_attention fully masked rows {first}..255, {label}: "
              f"max|err| {err}, on the masked rows {masked_err} (tol {tol})")
        masked_rows[f"{str(dtype)[6:]} {tiling}"] = err
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    # The backward kernel, and the forward's lse, at the training shapes.
    bwd = [check_attention_bwd(case, gen, dev, smi) for case in BWD_CASES]
    torch.cuda.empty_cache()
    main_case, rg_case = attn[cases[0]], attn[cases[8]]
    main_fp32, rg_fp32 = attn[cases[2]], attn[cases[10]]
    au_case, au_fp16, au_fp32 = (attn[c] for c in HUBERT_CASES)
    cross_case = attn[CROSS_CASE]

    # The grouped matmul against its plain version at qwen3-moe-30b-a3b's
    # expert products: gate/up (D, F) = (2048, 768) and down (768, 2048).
    gmm_cases = [  # (E, C, D, F, dtype, dispatch-like buffer)
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.bfloat16, False),
        (E_MOE, C_PREFILL, F_MOE, D_MOE, torch.bfloat16, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.float16, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.float32, False),
        (E_MOE, C_PREFILL, F_MOE, D_MOE, torch.float32, False),
        (E_MOE, C_PREFILL, D_MOE, F_MOE, torch.bfloat16, True),
        (E_MOE, 1, D_MOE, F_MOE, torch.bfloat16, False),
        (E_MOE, 1, F_MOE, D_MOE, torch.bfloat16, False),
        (3, 77, 200, 136, torch.bfloat16, False),
        # Around the 128 x 256 tiles: one row past a tile; D and F ragged.
        (8, 129, D_MOE, F_MOE, torch.bfloat16, False),
        (4, 129, 72, 136, torch.bfloat16, False),
        (4, 129, 72, 136, torch.float16, False),
    ]
    gmm = {}
    for E, C, Dx, F, dtype, realistic in gmm_cases:
        x = torch.randn(E, C, Dx, generator=gen, device=dev).to(dtype)
        w = (torch.randn(E, Dx, F, generator=gen, device=dev) / Dx**0.5).to(dtype)
        if realistic:
            x = dispatch_like(x, gen)
        out = moe_gmm(x, w)
        torch.cuda.synchronize()
        ref = ref_moe_gmm(x, w)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        tiling = gmm_tiling(dtype, C, Dx, F)
        label = (f"E={E} C={C} D={Dx} F={F} {str(dtype)[6:]} tiling={tiling}"
                 + (" rows past each count zero" if realistic else ""))
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: moe_gmm(x, w), 20)
        plain_ms = time_ms(lambda: ref_moe_gmm(x, w), 5)
        # torch.bmm: a yardstick only, never on the port's path.
        library_ms = time_ms(lambda: torch.bmm(x, w), 20)
        fma_ms = None
        if tiling == "wgmma" and E == E_MOE:  # the earlier tiling, on the same inputs
            fma_ms = time_ms(lambda: moe_gmm(x, w, tiling="fma"), 20)
        bound_ms, bound_by, _ = gmm_bound(x, w)
        print(f"phase 3 kernel: moe_gmm {label}: max|err| {err} (tol {tol}) "
              f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}) fma_ms {fma_ms} on {smi}")
        gmm[(E, C, Dx, F, dtype, realistic)] = dict(
            tiling=tiling, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms)
        del x, w, out, ref
    torch.cuda.empty_cache()
    gmm_main, gmm_down, gmm_fp32 = gmm[gmm_cases[0]], gmm[gmm_cases[1]], gmm[gmm_cases[3]]
    gmm_decode, gmm_decode_down = gmm[gmm_cases[6]], gmm[gmm_cases[7]]

    # A decode step's own buffers: what layers.moe passes to the grouped
    # matmul for the 4 served requests on a full-width layer.  Experts that
    # no token picked hold zero rows, which the skinny tiling skips, and the
    # bound counts only the live experts' weights.
    decode_like = {}
    for name, x, w in moe_decode_buffers(layers, ops, get_config("qwen3-moe-30b-a3b"), dev, gen):
        out = moe_gmm(x, w)
        torch.cuda.synchronize()
        ref = ref_moe_gmm(x, w)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[x.dtype]
        E, C, Dx = x.shape
        F = w.shape[2]
        tiling = gmm_tiling(x.dtype, C, Dx, F)
        require(tiling == "skinny", f"decode-like {name} on the skinny tiling, not {tiling}")
        require(bool(torch.isfinite(out).all())
                and torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, decode-like {name}: max|err| {err}")
        kernel_ms = time_ms(lambda: moe_gmm(x, w), 20)
        plain_ms = time_ms(lambda: ref_moe_gmm(x, w), 5)
        library_ms = time_ms(lambda: torch.bmm(x, w), 20)
        bound_ms, bound_by, live = gmm_bound(x, w)
        print(f"phase 3 kernel: moe_gmm decode-like {name} E={E} C={C} D={Dx} F={F} "
              f"{str(x.dtype)[6:]} tiling={tiling}: live experts {live} of {E}, max|err| {err} "
              f"(tol {tol}) kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}; the live experts' weights) "
              f"share of bound {bound_ms / kernel_ms} on {smi}")
        decode_like[name] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, live=live,
                                 max_abs_err=err)
        del x, w, out, ref
    torch.cuda.empty_cache()

    # The selective scan at falcon-mamba-7b's prefill (b and c strided, as the
    # layer passes them) and at a ragged shape (L not a multiple of 16 or 32,
    # DI not of the 64-channel block), with bf16 inputs and in fp32.  The bar
    # is 1e-4 of max|y| in fp32 and 2e-2 with bf16 inputs.  No PyTorch call
    # computes a linear recurrence, so there is no library time.
    mamba_cases = [  # (B, L, DI, ST, R, dtype)
        (B, PROMPT, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.bfloat16),
        (B, PROMPT, DI_MAMBA, ST_MAMBA, R_MAMBA, torch.float32),
        (2, 37, 200, ST_MAMBA, None, torch.bfloat16),
        (2, 37, 200, ST_MAMBA, None, torch.float32),
    ]
    mamba_main = {}
    for Bm, L, DI, ST, R, dtype in mamba_cases:
        args = mamba_inputs(gen, Bm, L, DI, ST, dtype, R)
        y, h = mamba_scan(*args)
        torch.cuda.synchronize()
        ey, eh = ref_mamba_scan(*args)
        err, herr = float((y - ey).abs().max()), float((h - eh).abs().max())
        tol = 1e-4 * float(ey.abs().max()) if dtype == torch.float32 else TOL[dtype]
        htol = max(tol, 1e-4 * float(eh.abs().max()))
        label = f"B={Bm} L={L} DI={DI} ST={ST} {str(dtype)[6:]}" + (" b,c strided" if R else "")
        require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                f"finite kernel output, {label}")
        require(err <= tol and herr <= htol,
                f"kernel vs plain, {label}: max|err| y {err} (tol {tol}), h {herr} (tol {htol})")
        kernel_ms = time_ms(lambda: mamba_scan(*args), 20)
        plain_ms = time_ms(lambda: ref_mamba_scan(*args), 3, warmup=1)
        bound_ms, bound_by, bytes_ms, exp_ms = mamba_bound(*args)
        print(f"phase 3 kernel: mamba_scan {label}: max|err| y {err} (tol {tol}) h {herr} "
              f"(tol {htol}) kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms None "
              f"bound_ms {bound_ms} ({bound_by}; bytes {bytes_ms} ms, exps {exp_ms} ms) on {smi}")
        if (Bm, L, DI, ST, R, dtype) == mamba_cases[0]:
            mamba_main = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        del args, y, h, ey, eh

    # The RG-LRU scan at recurrentgemma-9b's prefill (fp32, as the layer
    # passes it) and at a ragged shape, in fp32 and with bf16 inputs.
    lru_cases = [  # (B, L, D, dtype)
        (B, PROMPT_RG, D_RG, torch.float32),
        (B, PROMPT_RG, D_RG, torch.bfloat16),
        (3, 1000, 200, torch.float32),
        (3, 1000, 200, torch.bfloat16),
    ]
    lru_main = {}
    for Bm, L, Dl, dtype in lru_cases:
        a = (torch.rand(Bm, L, Dl, generator=gen, device=dev) * 0.89 + 0.1).to(dtype)
        bb = torch.randn(Bm, L, Dl, generator=gen, device=dev).to(dtype)
        h_all, h_fin = rglru_scan(a, bb)
        torch.cuda.synchronize()
        e_all, e_fin = ref_rglru_scan(a, bb)
        err = max(float((h_all - e_all).abs().max()), float((h_fin - e_fin).abs().max()))
        tol = 1e-5  # fp32 arithmetic from the same inputs in both
        label = f"B={Bm} L={L} D={Dl} {str(dtype)[6:]}"
        require(bool(torch.isfinite(h_all).all()), f"finite kernel output, {label}")
        require(torch.allclose(h_all, e_all, rtol=tol, atol=tol)
                and torch.allclose(h_fin, e_fin, rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: rglru_scan(a, bb), 20)
        plain_ms = time_ms(lambda: ref_rglru_scan(a, bb), 3, warmup=1)
        bound_ms, bound_by = lru_bound(a, bb)
        print(f"phase 3 kernel: rglru_scan {label}: max|err| {err} (tol {tol}) kernel_ms "
              f"{kernel_ms} plain_ms {plain_ms} library_ms None bound_ms {bound_ms} "
              f"({bound_by}) on {smi}")
        if (Bm, L, Dl, dtype) == lru_cases[0]:
            lru_main = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        del a, bb, h_all, h_fin, e_all, e_fin
    torch.cuda.empty_cache()

    bag_main, bag_multi = check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi)
    torch.cuda.empty_cache()

    # A narrow granite in fp32 (head dim 64): kernel prefill on the card vs the
    # plain model on the CPU, same weights and prompts.
    small = narrow_config(get_config, "granite-8b")
    m_cpu = lm.init(0, small, device="cpu")
    m_gpu = lm.init(0, small, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, small.vocab, (2, 77), generator=torch.Generator().manual_seed(0))
    lc, _ = lm.prefill(m_cpu, {"tokens": toks}, small)
    lg, _ = lm.prefill(m_gpu, {"tokens": toks.to(dev)}, small)
    err = float((lg.cpu() - lc).abs().max())
    require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4),
            f"narrow fp32 model, card vs CPU: max|err| {err}")
    print(f"phase 3 model: narrow fp32 granite prefill, card vs CPU plain: max|err| {err} "
          "(tol 1e-4)")
    del m_cpu, m_gpu

    # A narrow qwen3-moe in fp32 (head dim 64, 8 experts, top 2) at capacity
    # 1.0, so prefill drops entries: both kernels on the card vs the CPU.
    small_moe = narrow_config(get_config, "qwen3-moe-30b-a3b")
    m_cpu = lm.init(0, small_moe, device="cpu")
    m_gpu = lm.init(0, small_moe, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    fc, ac = lm.forward(m_cpu, {"tokens": toks}, small_moe)
    fg, ag = lm.forward(m_gpu, {"tokens": toks.to(dev)}, small_moe)
    lc, cc = lm.prefill(m_cpu, {"tokens": toks}, small_moe, pad_to=80)
    lg, cg = lm.prefill(m_gpu, {"tokens": toks.to(dev)}, small_moe, pad_to=80)
    errs = {"forward": float((fg.cpu() - fc).abs().max()), "aux": abs(float(ag) - float(ac)),
            "prefill": float((lg.cpu() - lc).abs().max())}
    require(torch.allclose(fg.cpu(), fc, rtol=1e-4, atol=1e-4), f"narrow MoE forward: {errs}")
    require(abs(float(ag) - float(ac)) <= 1e-4 * (1 + abs(float(ac))), f"narrow MoE aux: {errs}")
    require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4), f"narrow MoE prefill: {errs}")
    for pos in (77, 78):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(m_cpu, {"token": tok, "pos": pos, "cache": cc}, small_moe)
        lg, cg = lm.decode_step(m_gpu, {"token": tok.to(dev), "pos": pos, "cache": cg}, small_moe)
        errs[f"decode@{pos}"] = float((lg.cpu() - lc).abs().max())
        require(torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4), f"narrow MoE decode: {errs}")
    print(f"phase 3 model: narrow fp32 MoE (capacity 1.0), card vs CPU plain: max|err| {errs} "
          "(tol 1e-4)")
    del m_cpu, m_gpu, cg

    # Narrow fp32 falcon-mamba and Griffin: the scans (and Griffin's windowed
    # attention at head dim 64) on the card vs the plain models on the CPU.
    # Then a narrow VLM (self and cross attention at head dim 128, gates
    # opened) and a narrow encoder (head dim 80, both ways).
    cpu_gen = torch.Generator().manual_seed(1)
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b", "llama-3.2-vision-11b",
                 "hubert-xlarge"):
        small = narrow_config(get_config, arch)
        batch = {"tokens": toks}
        if small.family == "vlm":
            batch["image_embeds"] = torch.randn(2, small.img_tokens, small.d_model,
                                                generator=cpu_gen)
        elif small.family == "audio":
            batch = {"frames": torch.randn(2, 77, small.d_model, generator=cpu_gen)}
        errs = check_narrow_model(lm, small, dev, batch, arch)
        print(f"phase 3 model: narrow fp32 {arch} (head dim {small.hd}), card vs CPU plain: "
              f"max|err| {errs} (tol 1e-4)")

    # A narrow fp32 DLRM: the embedding bag on the card vs the plain lookup
    # on the CPU, same weights and batch (forward and loss).
    small_dlrm = dlrm.DLRMConfig(n_tables=4, rows_per_table=1000, embed_dim=16,
                                 bottom_mlp=(32, 32), top_mlp=(32, 32, 1))
    m_cpu = dlrm.init(0, small_dlrm, device="cpu")
    m_gpu = dlrm.init(0, small_dlrm, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    batch = dlrm_batch(np.random.default_rng(0), small_dlrm, 64, "cpu")
    fc = dlrm.forward(m_cpu, batch["dense"], batch["sparse"], small_dlrm)
    lc, _ = dlrm.loss_fn(m_cpu, batch, small_dlrm)
    gb = {k: v.to(dev) for k, v in batch.items()}
    fg = dlrm.forward(m_gpu, gb["dense"], gb["sparse"], small_dlrm)
    lg, _ = dlrm.loss_fn(m_gpu, gb, small_dlrm)
    errs = {"forward": float((fg.cpu() - fc).abs().max()), "loss": abs(float(lg) - float(lc))}
    require(torch.allclose(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
            and torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4),
            f"narrow DLRM, card vs CPU: {errs}")
    print(f"phase 3 model: narrow fp32 DLRM (T=4, R=1000, E=16, MLPs of 32), card vs CPU "
          f"plain: max|err| {errs} (tol 1e-4)")
    del m_cpu, m_gpu, gb

    # A narrow fp32 dense train step (head dim 64, 2 layers, d_model 256),
    # MHA and GQA: the attention kernels, forward and backward, on the card
    # against the plain versions on the CPU.
    for kv in (4, 2):
        small = train_config(get_config, kv)
        errs = check_train_step(lm, make_train_step, optim, ops, small, dev)
        print(f"phase 3 model: narrow fp32 train step ({TRAIN_ARCH} smoke, d_model 256, 2 layers, "
              f"H=4 KV={kv} D=64), card vs CPU plain: max relative err {errs} (tol 1e-4)")

    # Phase 4: serve granite-8b at full width and depth.
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4 serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2)  # warm-up: cuBLAS handles and heuristics

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens)
    check_served(cfg, ids, logits)
    launches = pre["attention_launches"] + dec["attention_launches"]
    require(launches == cfg.n_layers and pre["attention_launches"] == cfg.n_layers,
            f"flash_attention launches: {pre} in the prefill, {dec} in the decode loop, "
            f"want {cfg.n_layers} in the prefill and none after")
    require(pre["attention_wgmma_launches"] == cfg.n_layers,
            f"every prefill attention on the wgmma tiling: {pre}")
    require(sum(pre[n] + dec[n] for n in KERNEL_COUNTERS) == launches
            and sum(pre[n] + dec[n] for n in TILING_COUNTERS) == launches,
            f"granite-8b runs no other kernel: {pre}, {dec}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase 4 serve: {B}x{PROMPT} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"flash_attention launches {launches} ({pre['attention_wgmma_launches']} on wgmma), "
          f"on {smi}")
    print(f"phase 4 serve: generated ids (first request): {ids[0].tolist()}")

    full, _ = lm.prefill(model, {"tokens": tokens}, cfg)
    part, cache = lm.prefill(model, {"tokens": tokens[:, :-1]}, cfg, pad_to=PROMPT)
    step, _ = lm.decode_step(
        model, {"token": tokens[:, -1], "pos": PROMPT - 1, "cache": cache}, cfg
    )
    for name, t in (("prefill", full), ("prefill S-1", part), ("decode", step)):
        require(bool(torch.isfinite(t).all()), f"finite {name} logits")
    diff = float((step.float() - full.float()).abs().max())
    bar = 5e-2 * float(full.float().abs().max())
    require(diff <= bar, f"prefill vs prefill+decode: max|diff| {diff} > {bar}")
    agree = int((full.argmax(-1) == step.argmax(-1)).sum())
    print(f"phase 4 consistency: last-token logits, kernel prefill vs prefill(S-1)+plain "
          f"decode: max|diff| {diff} <= {bar} (5e-2 max|logits|); argmax agrees {agree}/{B}")
    granite_attention_launches = launches

    # Phase 4b: serve qwen3-moe-30b-a3b at full width and depth.  Its 61 GB
    # of weights need the room granite's model and caches hold.
    del model, full, part, step, cache, tokens, ids, logits
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4b serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}; routers fp32) in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2)  # warm-up

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens)
    check_served(cfg, ids, logits)
    att_prefill, gmm_prefill = pre["attention_launches"], pre["grouped_matmul_launches"]
    att_total = att_prefill + dec["attention_launches"]
    gmm_decode_loop = dec["grouped_matmul_launches"]
    gmm_total = gmm_prefill + gmm_decode_loop
    per_layer = 3 * cfg.n_layers  # gate, up and down products in every layer
    require(att_prefill == cfg.n_layers and att_total == cfg.n_layers,
            f"flash_attention launches: {att_prefill} in the prefill, {att_total} in all, "
            f"want {cfg.n_layers} and {cfg.n_layers}")
    require(gmm_prefill == per_layer, f"{gmm_prefill} moe_gmm launches in the prefill, "
            f"want {per_layer}")
    require(gmm_decode_loop == per_layer * (DECODE_STEPS - 1),
            f"{gmm_decode_loop} moe_gmm launches in {DECODE_STEPS - 1} decode steps, "
            f"want {per_layer * (DECODE_STEPS - 1)}")
    require(pre["selective_scan_launches"] + pre["lru_scan_launches"]
            + dec["selective_scan_launches"] + dec["lru_scan_launches"] == 0,
            "qwen3-moe-30b-a3b runs no scan")
    require(pre["attention_wgmma_launches"] == att_prefill
            and pre["grouped_matmul_wgmma_launches"] == gmm_prefill,
            f"every prefill attention and grouped matmul on the wgmma tiling: {pre}")
    require(dec["grouped_matmul_skinny_launches"] == gmm_decode_loop,
            f"every decode grouped matmul on the skinny tiling: {dec}")
    require(pre["attention_fma_launches"] + dec["attention_fma_launches"]
            + pre["grouped_matmul_fma_launches"] + dec["grouped_matmul_fma_launches"] == 0,
            f"no bf16 launch on an fma tiling: {pre}, {dec}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase 4b serve: {B}x{PROMPT} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"flash_attention launches {att_prefill} (prefill, wgmma), moe_gmm launches "
          f"{gmm_prefill} (prefill, wgmma) + {gmm_decode_loop} ({DECODE_STEPS - 1} decode "
          f"steps, skinny), on {smi}")
    print(f"phase 4b serve: generated ids (first request): {ids[0].tolist()}")
    del logits

    # The served model's first MoE layer, bf16 on the card, against an fp32
    # copy on the CPU, on 64 tokens (N = 64, C = 5): dispatch, the kernel and
    # the combine at full width against the plain path.
    moe0 = model.blocks[0].moe
    moe_cpu = SimpleNamespace(**{n: t.float().cpu() for n, t in moe0.named_parameters()})
    x_in = layers.rms_norm(model.embed[tokens[:1, :64]], moe0.norm)  # (1, 64, 2048) bf16
    ops.grouped_matmul_launches = 0
    y_gpu, aux_gpu = layers.moe(moe0, x_in, cfg)
    require(ops.grouped_matmul_launches == 3, "the layer ran three moe_gmm launches")
    y_cpu, aux_cpu = layers.moe(moe_cpu, x_in.float().cpu(), cfg)
    err = float((y_gpu.float().cpu() - y_cpu).abs().max())
    require(torch.allclose(y_gpu.float().cpu(), y_cpu, rtol=2e-2, atol=2e-2),
            f"full-width MoE layer, bf16 card vs fp32 CPU: max|err| {err}")
    print(f"phase 4b layer: full-width MoE layer 0, 64 tokens (C = "
          f"{max(1, int(cfg.capacity_factor * 64 * cfg.top_k / cfg.n_experts))}), bf16 card "
          f"vs fp32 CPU: max|err| {err} (tol 2e-2), max|out| {float(y_cpu.abs().max())}, "
          f"aux {float(aux_gpu)} vs {float(aux_cpu)}")
    qwen_name = cfg.name
    del model, moe0, moe_cpu, x_in, y_gpu, y_cpu, tokens, ids

    # Phases 4c and 4d: the recurrent families, each after the previous model
    # is freed.  Each layer's scan runs the kernel at prefill and a plain step
    # at decode.  Then DLRM (4e), the VLM (4f) and the audio encoder (4g).
    falcon = serve_checked(lm, ops, generate, get_config("falcon-mamba-7b"), PROMPT, gen,
                           dev, smi, "4c")
    griffin = serve_checked(lm, ops, generate, get_config("recurrentgemma-9b"), PROMPT_RG,
                            gen, dev, smi, "4d")
    bag_launches = score_dlrm(dlrm, ops, ref_embedding_bag, dev, smi)
    vlm = serve_checked(lm, ops, generate, get_config("llama-3.2-vision-11b"), PROMPT, gen,
                        dev, smi, "4f")
    hubert = encode_audio(lm, ops, get_config("hubert-xlarge"), dev, smi)

    # Phase 5: training.  The narrow config's resume first, then minicpm-2b
    # at full width and depth.
    resume = resume_check(train_loop, optim, train_config(get_config, 4), dev)
    print(f"phase 5 resume: narrow fp32 {TRAIN_ARCH}, checkpoint every 2 steps, failure at step "
          f"4, resumed to 8: last four losses {resume['resumed']} vs uninterrupted "
          f"{resume['whole'][4:]}, max relative err {resume['max_rel_err']} (tol 1e-5)")
    trained = train_full(lm, ops, optim, make_train_step, data, get_config(TRAIN_ARCH), dev, smi)
    train_fwd = trained["counts"]["attention_launches"]
    train_bwd = trained["counts"]["attention_bwd_launches"]
    summary = {k: trained[k] for k in ("n_params", "step_ms", "tokens_per_s", "mfu", "peak_gb")}
    print(f"phase 5 summary: {json.dumps(summary)} on {smi}")

    # Phase 6: the planner on the card.
    planned = plan_phase(dev, smi)
    print(f"phase 6 summary: {json.dumps(planned)} on {smi}")

    print(f"chip_smoke: wall time {time.perf_counter() - T_START} s, the kernels' build "
          "included")

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "tpu_ref": "kernels/flash_attention.py:84",
        "tiling": main_case["tiling"],
        "launches": (granite_attention_launches + att_total + griffin["attention_launches"]
                     + vlm["attention_launches"] + hubert["attention_launches"] + train_fwd),
        "launches_by_path": {"granite-8b": granite_attention_launches, qwen_name: att_total,
                             "recurrentgemma-9b": griffin["attention_launches"],
                             "llama-3.2-vision-11b": vlm["attention_launches"],
                             "hubert-xlarge": hubert["attention_launches"],
                             f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps": train_fwd},
        "max_abs_err": main_case["max_abs_err"],
        "max_err_bf16": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "bf16_fma_ms": main_case["fma_ms"],
        "fp32_tiling": main_fp32["tiling"],
        "fp32_fma_ms": main_fp32["kernel_ms"],
        "d256_kernel_ms": rg_case["kernel_ms"],
        "d256_plain_ms": rg_case["plain_ms"],
        "d256_bound_ms": rg_case["bound_ms"],
        "d256_library_ms": rg_case["library_ms"],
        "d256_max_abs_err": rg_case["max_abs_err"],
        "d256_bf16_fma_ms": rg_case["fma_ms"],
        "d256_fp32_fma_ms": rg_fp32["kernel_ms"],
        "masked_rows_max_abs_err": masked_rows,
        "d80_tiling": au_case["tiling"],
        "d80_kernel_ms": au_case["kernel_ms"],
        "d80_plain_ms": au_case["plain_ms"],
        "d80_bound_ms": au_case["bound_ms"],
        "d80_bound_by": au_case["bound_by"],
        "d80_library_ms": au_case["library_ms"],
        "d80_max_abs_err": au_case["max_abs_err"],
        "d80_bf16_fma_ms": au_case["fma_ms"],
        "d80_fp16_kernel_ms": au_fp16["kernel_ms"],
        "d80_fp32_fma_ms": au_fp32["kernel_ms"],
        "cross_kernel_ms": cross_case["kernel_ms"],
        "cross_plain_ms": cross_case["plain_ms"],
        "cross_bound_ms": cross_case["bound_ms"],
        "cross_bound_by": cross_case["bound_by"],
        "cross_library_ms": cross_case["library_ms"],
        "cross_max_abs_err": cross_case["max_abs_err"],
        "cross_bf16_fma_ms": cross_case["fma_ms"],
        "train_fwd_ms": bwd[0]["fwd_ms"],
        "train_fwd_lse_ms": bwd[0]["fwd_lse_ms"],
        "train_fwd_plain_ms": bwd[0]["fwd_plain_ms"],
        "train_fwd_library_ms": bwd[0]["fwd_library_ms"],
        "train_lse_max_abs_err": bwd[0]["lse_max_abs_err"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "tiling": bwd[0]["tiling"],
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": None,  # the TPU side has no backward kernel (jax.grad of XLA code)
        "launches": train_bwd,
        "launches_by_path": {f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps": train_bwd},
        "launches_per_step": trained["launches_per_step"]["attention_bwd_launches"],
        "launches_wgmma": trained["counts"]["attention_bwd_wgmma_launches"],
        "ms": bwd[0]["kernel_ms"],
        **{k: bwd[0][k] for k in ("max_abs_err", "max_abs_err_by_grad", "kernel_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by", "fma_kernel_ms",
                                  "fma_max_abs_err")},
        **{f"gqa_d128_{k}": bwd[1][k] for k in ("tiling", "max_abs_err", "kernel_ms", "plain_ms",
                                                 "library_ms", "bound_ms", "fma_kernel_ms")},
        **{f"fp32_{k}": bwd[2][k] for k in ("tiling", "max_abs_err", "kernel_ms", "library_ms",
                                             "bound_ms")},
    }, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:40",
        "tpu_ref": "kernels/moe_gmm.py:40",
        "tiling": gmm_main["tiling"],
        "decode_tiling": gmm_decode["tiling"],
        "launches": gmm_total,
        "launches_prefill": gmm_prefill,
        "launches_per_decode_step": gmm_decode_loop // (DECODE_STEPS - 1),
        "max_abs_err": gmm_main["max_abs_err"],
        "max_err_bf16": gmm_main["max_abs_err"],
        "ms": gmm_main["kernel_ms"],
        "kernel_ms": gmm_main["kernel_ms"],
        "plain_ms": gmm_main["plain_ms"],
        "bound_ms": gmm_main["bound_ms"],
        "bound_by": gmm_main["bound_by"],
        "library_ms": gmm_main["library_ms"],
        "bf16_fma_ms": gmm_main["fma_ms"],
        "fp32_tiling": gmm_fp32["tiling"],
        "fp32_fma_ms": gmm_fp32["kernel_ms"],
        "down_kernel_ms": gmm_down["kernel_ms"],
        "down_bound_ms": gmm_down["bound_ms"],
        "down_library_ms": gmm_down["library_ms"],
        "decode_kernel_ms": gmm_decode["kernel_ms"],
        "decode_bound_ms": gmm_decode["bound_ms"],
        "decode_library_ms": gmm_decode["library_ms"],
        "decode_down_kernel_ms": gmm_decode_down["kernel_ms"],
        "decode_down_bound_ms": gmm_decode_down["bound_ms"],
        "decode_down_library_ms": gmm_decode_down["library_ms"],
        "skinny_decode_like_kernel_ms": decode_like["gate"]["kernel_ms"],
        "skinny_decode_like_bound_ms": decode_like["gate"]["bound_ms"],
        "skinny_decode_like_library_ms": decode_like["gate"]["library_ms"],
        "skinny_decode_like_max_abs_err": decode_like["gate"]["max_abs_err"],
        "skinny_live_experts": decode_like["gate"]["live"],
        "skinny_decode_like_down_kernel_ms": decode_like["down"]["kernel_ms"],
        "skinny_decode_like_down_bound_ms": decode_like["down"]["bound_ms"],
        "skinny_decode_like_down_library_ms": decode_like["down"]["library_ms"],
        "skinny_live_experts_down": decode_like["down"]["live"],
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "tiling": "sequential",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:57",
        "tpu_ref": "kernels/mamba_scan.py:57",
        "launches": falcon["selective_scan_launches"],
        "launches_by_path": {"falcon-mamba-7b": falcon["selective_scan_launches"]},
        "ms": mamba_main["kernel_ms"],
        **mamba_main,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "tiling": "sequential",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "tpu_ref": "kernels/rglru_scan.py:42",
        "launches": griffin["lru_scan_launches"],
        "launches_by_path": {"recurrentgemma-9b": griffin["lru_scan_launches"]},
        "ms": lru_main["kernel_ms"],
        **lru_main,
    }, {
        "name": "embedding_bag",
        "route": "cuda",
        "tiling": "gather",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:33",
        "tpu_ref": "kernels/embedding_bag.py:33",
        "launches": sum(bag_launches.values()),
        "launches_by_path": {DLRM_PATH: sum(bag_launches.values())},
        "launches_per_forward": bag_launches,
        "ms": bag_main["kernel_ms"],
        **bag_main,
        **{f"multihot_{k}": v for k, v in bag_multi.items()},
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def check_bag(embedding_bag, ref_embedding_bag, gen, dev, smi):
    """The embedding bag against its plain version on the paper DLRM's
    tables; returns the numbers at the serving lookup and the multi-hot
    shape.  One id a bag sums one row, so those cases must be bitwise equal;
    otherwise test_kernels.py's bars (fp32: rtol 1e-6 and NNZ ulps of the
    largest term; bf16: 2e-2)."""
    T, R, E = T_DLRM, R_DLRM, E_DLRM

    def ids(Bb, nnz, low=0, high=R, dtype=torch.int32):
        return torch.randint(low, high, (Bb, T, nnz), generator=gen, device=dev).to(dtype)

    def case(label, tab, idx, exact=False) -> dict:
        out = embedding_bag(tab, idx)
        torch.cuda.synchronize()
        ref = ref_embedding_bag(tab, idx)
        err = float((out.float() - ref.float()).abs().max())
        if exact:
            ok, tol = torch.equal(out, ref), 0.0
        elif tab.dtype == torch.float32:
            lo, hi = tab.aminmax()  # no (T, R, E) temporary, as abs() would make
            tol = idx.shape[2] * torch.finfo(torch.float32).eps * max(-float(lo), float(hi))
            ok = torch.allclose(out, ref, rtol=1e-6, atol=tol)
        else:
            tol = 2e-2
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(ok, f"embedding_bag vs plain, {label}: max|err| {err} (tol {tol})")
        numbers = bag_times(embedding_bag, ref_embedding_bag, tab, idx, out)
        numbers["max_abs_err"] = err
        print(f"phase 3 kernel: embedding_bag {label}: max|err| {err} (tol {tol}"
              f"{', bitwise' if exact else ''}) kernel_ms {numbers['kernel_ms']} plain_ms "
              f"{numbers['plain_ms']} library_ms {numbers['library_ms']} (max|err| "
              f"{numbers['library_err']}) bound_ms {numbers['bound_ms']} "
              f"({numbers['bound_by']}; {numbers['rows_read']} distinct rows) on {smi}")
        return {k: numbers[k] for k in BAG_KEYS}

    tables = torch.randn(T, R, E, generator=gen, device=dev)  # 40.96 GB
    main = case("serving B=128 NNZ=1 fp32 int32", tables, ids(128, 1), exact=True)
    case("B=4096 NNZ=1 fp32 int32", tables, ids(4096, 1), exact=True)
    multi = case("multi-hot B=4096 NNZ=32 fp32 int32", tables, ids(4096, 32))
    case("ids near R-1 B=128 NNZ=4 fp32 int32", tables, ids(128, 4, R - 1000))
    # Ids past the table read the rows the reference's gather clamps and wraps to.
    rows = {R: R - 1, R + 5: R - 1, -1: R - 1, -R: 0, -R - 3: 0, 2**31 - 1: R - 1,
            -(2**31): 0, 0: 0}
    past = torch.tensor(list(rows), device=dev).repeat(16)
    want = torch.tensor([rows[int(i)] for i in past.tolist()], device=dev)
    past = past[:, None, None].expand(-1, T, 1).to(torch.int32)
    require(torch.equal(embedding_bag(tables, past),
                        tables[torch.arange(T, device=dev)[None, :], want[:, None]]),
            "ids R, -1 and beyond read the clamped and wrapped rows")
    case("ids past the table B=128 NNZ=1 fp32 int32", tables, past, exact=True)
    del tables
    torch.cuda.empty_cache()

    tables = torch.randn(T, R, E, generator=gen, device=dev, dtype=torch.bfloat16)
    case("serving B=128 NNZ=1 bf16 int32", tables, ids(128, 1), exact=True)
    case("multi-hot B=4096 NNZ=32 bf16 int32", tables, ids(4096, 32))
    del tables
    torch.cuda.empty_cache()
    # Rows of 52 bytes (E = 13: the scalar kernel), with int64 ids.
    tables = torch.randn(T, R, 13, generator=gen, device=dev)
    case("ragged E=13 B=128 NNZ=7 fp32 int64", tables, ids(128, 7, dtype=torch.int64))
    del tables
    return main, multi


BAG_KEYS = ("max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def bag_times(embedding_bag, ref_embedding_bag, tables, ids, out) -> dict:
    """Kernel, plain and library times (CUDA events) and the bound.  The
    library call is ``F.embedding_bag`` over the tables seen as one (T*R, E)
    table, with ids in range offset by t*R: a yardstick only, never on the
    port's path."""
    T, R, E = tables.shape
    B, _, nnz = ids.shape
    iters = 20 if B * nnz > 4096 else 200
    kernel_ms = time_ms(lambda: embedding_bag(tables, ids), iters)
    plain_ms = time_ms(lambda: ref_embedding_bag(tables, ids), 5)
    library_ms = library_err = None
    if bool(((ids >= 0) & (ids < R)).all()):
        flat = (ids.long() + torch.arange(T, device=ids.device)[None, :, None] * R)
        flat = flat.view(B * T, nnz)
        table2d = tables.view(T * R, E)
        lib = torch.nn.functional.embedding_bag(flat, table2d, mode="sum").view(B, T, E)
        library_err = float((lib.float() - out.float()).abs().max())
        library_ms = time_ms(
            lambda: torch.nn.functional.embedding_bag(flat, table2d, mode="sum"), iters)
    bound_ms, bound_by, n_rows = bag_bound(tables, ids, out)
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_err=library_err, bound_ms=bound_ms, bound_by=bound_by,
                rows_read=n_rows)


def dlrm_batch(rng, cfg, batch, device):
    """Dense features and ids drawn with numpy from ``rng``; labels are
    ``sparse[:, 0] % 2``, as ``examples/dlrm_testbed.py`` makes them."""
    sparse = rng.integers(0, cfg.rows_per_table, (batch, cfg.n_tables)).astype(np.int32)
    dense = rng.standard_normal((batch, cfg.dense_features)).astype(np.float32)
    return {"dense": torch.from_numpy(dense).to(device),
            "sparse": torch.from_numpy(sparse).to(device),
            "label": torch.from_numpy((sparse[:, 0] % 2).astype(np.float32)).to(device)}


def score_dlrm(dlrm, ops, ref_embedding_bag, dev, smi) -> dict:
    """Phase 4e: scores the paper's DLRM (8 tables) at full width on the
    freed card, at each batch of ``DLRM_BATCHES``; returns the embedding-bag
    launches of each batch's request."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dlrm.paper_config(T_DLRM)
    before_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left allocated
    t0 = time.perf_counter()
    model = dlrm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_mlp = sum(p.numel() for n, p in model.named_parameters() if n != "tables")
    print(f"phase 4e score: {DLRM_PATH} init on the card: tables {tuple(model.tables.shape)} "
          f"fp32 ({model.tables.numel() * 4 / 1e9} GB), MLPs {n_mlp} parameters "
          f"({n_mlp * 4 / 1e9} GB) in {time.perf_counter() - t0:.2f} s; allocated before "
          f"the init {before_gb} GB, after it {torch.cuda.memory_allocated() / 1e9} GB")
    rng = np.random.default_rng(0)
    launches = {}
    for batch_size in DLRM_BATCHES:
        batch = dlrm_batch(rng, cfg, batch_size, dev)
        dense, sparse = batch["dense"], batch["sparse"]
        for _ in range(3):  # warm-up: cuBLAS handles and heuristics
            dlrm.forward(model, dense, sparse, cfg)
        torch.cuda.synchronize()
        # The request, with every count set to 0 just before it.
        for n in COUNTERS:
            setattr(ops, n, 0)
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 1e9
        logits = dlrm.forward(model, dense, sparse, cfg)
        torch.cuda.synchronize()
        counts = {n: getattr(ops, n) for n in COUNTERS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {n: int(n == "bag_lookup_launches") for n in COUNTERS}
        require(counts == want, f"{DLRM_PATH} B={batch_size} launches {counts}, want {want}")
        launches[f"B={batch_size}"] = counts["bag_lookup_launches"]
        loss, _ = dlrm.loss_fn(model, batch, cfg)
        require(tuple(logits.shape) == (batch_size,) and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(loss)), f"finite {DLRM_PATH} logits and loss")
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            dlrm.forward(model, dense, sparse, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fwd_ms = float(np.median(times)) * 1e3
        print(f"phase 4e score: B={batch_size} forward {fwd_ms} ms (median of 20, min "
              f"{min(times) * 1e3}, max {max(times) * 1e3}), {batch_size / fwd_ms * 1e3} "
              f"samples/s, bag_lookup launches {counts['bag_lookup_launches']} per forward, "
              f"loss {float(loss)}, max|logit| {float(logits.abs().max())}, peak memory "
              f"{peak_gb} GB ({start_gb} GB allocated at the request's start), on {smi}")

        # (a) The same forward with the plain lookup on the card: bitwise.
        real = ops.bag_lookup
        ops.bag_lookup = ref_embedding_bag
        try:
            plain_logits = dlrm.forward(model, dense, sparse, cfg)
        finally:
            ops.bag_lookup = real
        diff = float((plain_logits - logits).abs().max())
        require(torch.equal(plain_logits, logits),
                f"{DLRM_PATH} B={batch_size} kernel vs plain lookup: max|diff| {diff}")
        # (b) 16 samples recomputed on the CPU from the rows they gather.
        n = 16
        rows = model.tables[torch.arange(T_DLRM, device=dev)[None, :], sparse[:n].long()]
        cpu = SimpleNamespace(
            tables=rows.transpose(0, 1).contiguous().cpu(),  # (T, 16, E): row i is sample i's
            bottom=[SimpleNamespace(w=m.w.cpu(), b=m.b.cpu()) for m in model.bottom],
            top=[SimpleNamespace(w=m.w.cpu(), b=m.b.cpu()) for m in model.top])
        cfg_cpu = dataclasses.replace(cfg, rows_per_table=n)
        sub = {"dense": dense[:n].cpu(), "label": batch["label"][:n].cpu(),
               "sparse": torch.arange(n)[:, None].expand(n, T_DLRM)}
        logits_cpu = dlrm.forward(cpu, sub["dense"], sub["sparse"], cfg_cpu)
        loss_cpu, _ = dlrm.loss_fn(cpu, sub, cfg_cpu)
        loss_card, _ = dlrm.loss_fn(model, {"dense": dense[:n], "sparse": sparse[:n],
                                            "label": batch["label"][:n]}, cfg)
        bar = 1e-4 * float(logits_cpu.abs().max())
        # The loss sits near log 2, where one fp32 ulp (6e-8) can exceed the
        # logits' bar: its 16 terms are summed in another order on the card.
        loss_bar = bar + 8 * torch.finfo(torch.float32).eps * abs(float(loss_cpu))
        err = float((logits[:n].cpu() - logits_cpu).abs().max())
        loss_err = abs(float(loss_card) - float(loss_cpu))
        require(err <= bar and loss_err <= loss_bar,
                f"{DLRM_PATH} B={batch_size} card vs CPU on {n} samples: logits {err} "
                f"(bar {bar}), loss {loss_err} (bar {loss_bar})")
        print(f"phase 4e consistency: B={batch_size} kernel vs plain lookup on the card: "
              f"bitwise (max|diff| {diff}); {n} samples recomputed on the CPU in fp32: logits "
              f"max|err| {err} <= {bar} (1e-4 max|logit|), loss {float(loss_card)} vs "
              f"{float(loss_cpu)}, |err| {loss_err} <= {loss_bar}")
        del batch, dense, sparse, logits, plain_logits, rows, cpu
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_checked(lm, ops, generate, cfg, prompt, gen, dev, smi, phase) -> dict:
    """Serves a recurrent model or the VLM at full width and depth after
    freeing the card, checks its launch counts and outputs, holds
    prefill(S + 1) against prefill(S) plus a decode step, and returns the
    prefill's launch counts.  The VLM's cross gates are set to 1 first, and
    its image (``launch.serve.image_draw``, numpy seed 0) goes into every
    prefill."""
    from repro_torch.launch.serve import image_draw

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    fp32 = "" if cfg.family == "vlm" else "; scan parameters fp32"
    print(f"phase {phase} serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}{fp32}) in {time.perf_counter() - t0:.2f} s")
    extra = {}
    if cfg.family == "vlm":
        gates = open_gates(model)
        extra["image_embeds"] = image_draw(np.random.default_rng(0), cfg, B).to(dev)
        print(f"phase {phase} serve: cross gates {[float(g) for g in gates]} (tanh "
              f"{math.tanh(1.0)}; 0 at init, where tanh(0) = 0 throws the cross-attention "
              f"away), image {tuple(extra['image_embeds'].shape)} drawn with numpy")
    image = extra.get("image_embeds")
    tokens = torch.randint(0, cfg.vocab, (B, prompt + 1), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2, image_embeds=image)  # warm-up

    ids, timings, pre, dec, logits = served(lm, ops, generate, model, tokens[:, :prompt], image)
    check_served(cfg, ids, logits)
    if cfg.family == "ssm":
        want = {"selective_scan_launches": cfg.n_layers}
    elif cfg.family == "vlm":  # 32 self and 8 cross layers
        want = {"attention_launches": cfg.n_layers, "attention_wgmma_launches": cfg.n_layers}
    else:
        n_blocks = cfg.n_layers // len(cfg.block_pattern)  # each: rec, rec, attn
        want = {"lru_scan_launches": 2 * n_blocks + len(cfg.tail_pattern),
                "attention_launches": n_blocks, "attention_wgmma_launches": n_blocks}
    want = {n: want.get(n, 0) for n in COUNTERS}
    require(pre == want, f"{cfg.name} prefill launches {pre}, want {want}")
    require(not any(dec.values()), f"{cfg.name} decode loop launched {dec}, want none")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase {phase} serve: {B}x{prompt} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"launches: prefill {pre}, decode loop {dec}, on {smi}")
    print(f"phase {phase} serve: generated ids (first request): {ids[0].tolist()}")
    del logits

    # prefill(S) is exact for the next step at S: falcon's states at any S,
    # Griffin's ring-buffer cache at S = its window, the VLM's KV cache with
    # room for one more key (its step attends to the image in plain PyTorch).
    full, _ = lm.prefill(model, {"tokens": tokens, **extra}, cfg)
    part, cache = lm.prefill(model, {"tokens": tokens[:, :prompt], **extra}, cfg,
                             pad_to=prompt + 1)
    step, _ = lm.decode_step(
        model, {"token": tokens[:, prompt], "pos": prompt, "cache": cache}, cfg
    )
    for name, t in (("prefill S+1", full), ("prefill", part), ("decode", step)):
        require(bool(torch.isfinite(t).all()), f"finite {name} logits")
    diff = float((step.float() - full.float()).abs().max())
    bar = 5e-2 * float(full.float().abs().max())
    require(diff <= bar, f"{cfg.name} prefill vs prefill+decode: max|diff| {diff} > {bar}")
    agree = int((full.argmax(-1) == step.argmax(-1)).sum())
    print(f"phase {phase} consistency: last-token logits, kernel prefill(S+1) vs prefill(S)"
          f"+plain decode: max|diff| {diff} <= {bar} (5e-2 max|logits|); argmax agrees "
          f"{agree}/{B}")
    return pre


def encode_audio(lm, ops, cfg, dev, smi) -> dict:
    """Phase 4g: encodes B clips of PROMPT frames (20 s each at HuBERT's
    20 ms frame rate; standard normal from numpy seed 0) with the encoder
    at full width and depth on the freed card: one flash-attention launch a
    layer, all wgmma at D = 80, logits finite of shape (B, PROMPT, vocab),
    the forward timed (host clock after a synchronise, median of 10 after a
    warm-up), and layer 0 in bf16 on the card held against the same layer
    in fp32 on the CPU.  Returns the forward's launch counts."""
    from repro_torch.models import transformer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4g encode: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    draw = np.random.default_rng(0).standard_normal((B, PROMPT, cfg.d_model))
    frames = torch.from_numpy(draw).to(torch.bfloat16).to(dev)
    lm.forward(model, {"frames": frames[:, :64]}, cfg)  # warm-up
    torch.cuda.synchronize()

    for n in COUNTERS:
        setattr(ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    logits, _ = lm.forward(model, {"frames": frames}, cfg)
    torch.cuda.synchronize()
    counts = {n: getattr(ops, n) for n in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in COUNTERS}
    want.update(attention_launches=cfg.n_layers, attention_wgmma_launches=cfg.n_layers)
    require(counts == want, f"{cfg.name} forward launches {counts}, want {want}")
    require(tuple(logits.shape) == (B, PROMPT, cfg.vocab) and bool(torch.isfinite(logits).all()),
            f"finite {cfg.name} logits of shape {(B, PROMPT, cfg.vocab)}: {tuple(logits.shape)}")
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        lm.forward(model, {"frames": frames}, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd_ms = float(np.median(times)) * 1e3
    print(f"phase 4g encode: {B}x{PROMPT} frames forward {fwd_ms} ms (median of 10, min "
          f"{min(times) * 1e3}, max {max(times) * 1e3}), peak memory {peak_gb} GB, "
          f"flash_attention launches {counts['attention_launches']} "
          f"({counts['attention_wgmma_launches']} on wgmma at D = {cfg.hd}), logits "
          f"{tuple(logits.shape)}, on {smi}")

    # Layer 0 at full width on one clip: the kernel's bf16 encoder attention
    # against the plain layer in fp32 on the CPU.
    blk = model.blocks[0]
    x = frames[:1]
    positions = torch.arange(PROMPT, device=dev)[None, :]
    ops.attention_launches = 0
    y_gpu, _, _, _ = transformer._self_block_apply(blk, x, cfg, positions)
    require(ops.attention_launches == 1, "layer 0 ran one flash_attention launch")
    blk_cpu = copy.deepcopy(blk).float().cpu()
    y_cpu, _, _, _ = transformer._self_block_apply(blk_cpu, x.float().cpu(), cfg,
                                                   positions.cpu())
    err = float((y_gpu.float().cpu() - y_cpu).abs().max())
    bar = 2e-2 * float(y_cpu.abs().max())
    require(err <= bar, f"{cfg.name} layer 0, bf16 card vs fp32 CPU: max|err| {err} > {bar}")
    print(f"phase 4g layer: {cfg.name} layer 0 at full width, 1x{PROMPT} frames, bf16 card vs "
          f"fp32 CPU: max|err| {err} <= {bar} (2e-2 max|ref|)")
    del model, blk, blk_cpu, frames, logits, y_gpu
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Phase 6 (the planner): the paper's 128-server simulations (§5) at degree 4
# and 100 Gbps links; the fused admission's four tenants (32 servers each)
# over four placements shifted by 8 servers.
PLAN_N, PLAN_DEGREE, PLAN_LINK_BW = 128, 4, 12.5e9
PLAN_DEMANDS = 256
PLAN_ROUNDS, PLAN_ITERS, PLAN_CHAINS, PLAN_POOL = 2, 200, 32, 64
ADMIT_CHAINS, ADMIT_SEED, ADMIT_SHIFTS = 16, 3, (0, 8, 16, 24)
ORACLE_CHAINS = 4  # the NumPy oracles replay the first 4 chains


def admission_candidates(wl, n: int = PLAN_N) -> list:
    """DLRM (weight 2), BERT, CANDLE and VGG16 on 32 servers each, under
    each placement shift."""
    specs = ((wl.DLRM, 2.0), (wl.BERT, 1.0), (wl.CANDLE, 1.0), (wl.VGG16, 1.0))
    return [
        wl.JobSet(n=n, tenants=[
            wl.TenantJob(spec=spec, weight=w, name=spec.name,
                         servers=tuple((32 * i + j + off) % n for j in range(32)))
            for i, (spec, w) in enumerate(specs)
        ])
        for off in ADMIT_SHIFTS
    ]


def device_trace(fn) -> dict:
    """Runs ``fn`` once under ``torch.profiler``; returns its result, the
    traced host wall time, the summed device time of its kernels, the
    kernel launches and the copies (memcpy and memset) it made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    return dict(out=out, traced_wall_s=wall,
                busy_ms=sum(e.self_device_time_total for e in events) / 1e3,
                launches=sum(e.count for e in events) - sum(e.count for e in copies),
                copies=sum(e.count for e in copies))


def program_stats(call, parts: dict) -> dict:
    """Runs ``call`` three times: cold, then steady with each of ``parts``
    (label -> (owner, method name)) wrapped to sum its calls' host wall
    time between synchronises, then under ``torch.profiler``.  The first
    part is the device program: its idle share is 1 - its traced device
    time / its steady wall time.  Returns the steady run's result and the
    numbers."""
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    spent = {label: [0.0, 0] for label in parts}
    real = {label: getattr(owner, name) for label, (owner, name) in parts.items()}

    def wrap(label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[label][0] += time.perf_counter() - t0
            spent[label][1] += 1
            return res
        return timed

    try:
        for label, (owner, name) in parts.items():
            setattr(owner, name, wrap(label, real[label]))
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for label, (owner, name) in parts.items():
            setattr(owner, name, real[label])
    tr = device_trace(call)
    program = next(iter(parts))
    program_ms = spent[program][0] * 1e3
    return dict(out=out, first_s=first_s, wall_s=wall,
                parts_ms={label: t * 1e3 for label, (t, _) in spent.items()},
                programs=spent[program][1], program_wall_ms=program_ms,
                busy_ms=tr["busy_ms"], launches=tr["launches"], copies=tr["copies"],
                idle_share=1.0 - tr["busy_ms"] / program_ms,
                traced_wall_s=tr["traced_wall_s"])


def plan_phase(dev, smi) -> dict:
    """Phase 6: the planner at the paper's 128-server scale on the card
    (see the module docstring); returns its numbers."""
    from repro_torch.core import alternating as alt
    from repro_torch.core import planeval_torch as pt
    from repro_torch.core import workloads as wl
    from repro_torch.core.netsim import HardwareSpec
    from repro_torch.core.planeval import plan_evaluator
    from repro_torch.core.strategy_search import default_strategy
    from repro_torch.core.topology_finder import topology_finder

    hw = HardwareSpec(link_bandwidth=PLAN_LINK_BW, degree=PLAN_DEGREE)
    n = PLAN_N
    out: dict = {}

    # 6a: pricing.
    topo = topology_finder(default_strategy(wl.DLRM).demand(wl.DLRM, n), hw.degree)
    jobs = list(wl.PAPER_JOBS.values())
    per_job = -(-PLAN_DEMANDS // len(jobs))
    demands = [s.demand(job, n) for j, job in enumerate(jobs)
               for s in pt.strategy_pool(job, n, per_job, seed=j)][:PLAN_DEMANDS]
    ev = plan_evaluator(topo, hw)
    t0 = time.perf_counter()
    want = np.array([ev.comm_time(d) for d in demands])
    numpy_s = time.perf_counter() - t0
    tev = pt.TorchPlanEvaluator(topo, hw, dev)
    t0 = time.perf_counter()
    got = tev.comm_times(demands)
    card_s = time.perf_counter() - t0
    again = tev.comm_times(demands)
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
    require(rel <= pt.TORCH_EQUIV_RTOL, f"pricing vs NumPy: max rel err {rel}")
    require(np.array_equal(got, again), "two pricing calls differ")
    pk = tev.pack(demands)
    occ = int(pk.seg.numel())
    # The event span of back-to-back calls is the host's launch rate for
    # this loop of small launches; the profiler's busy time is the device's.
    wall_ms = time_ms(lambda: tev.bottlenecks(pk), iters=20)
    tr = device_trace(lambda: tev.bottlenecks(pk))
    bound_ms = (occ * 16 + pk.n_links * 8 + len(demands) * 8) / PEAK_BYTES_PER_S * 1e3
    seg_len = np.bincount(pk.seg.cpu().numpy())
    # The design the rank loop is held against: one index_put_(accumulate=
    # True) over the whole stream (CUDA's sort-based accumulate, no float
    # atomics).  Measured here, used nowhere in the port.
    caps_t = torch.from_numpy(np.ascontiguousarray(tev.ev.caps)).to(dev)

    def put_pricing():
        acc = torch.zeros(pk.rows * pk.n_links * 2, dtype=torch.float64, device=dev)
        acc.index_put_((pk.seg,), pk.share, accumulate=True)
        acc = acc.view(pk.rows, pk.n_links, 2)
        return ((acc[:, :, 0] + acc[:, :, 1]) / caps_t).amax(dim=1)

    put = put_pricing().cpu().numpy()
    put_again = put_pricing().cpu().numpy()
    put_rel = float((np.abs(put - want) / np.maximum(np.abs(want), 1e-30)).max())
    put_ms = time_ms(put_pricing, iters=20)
    put_tr = device_trace(put_pricing)
    out["pricing"] = dict(demands=len(demands), links=pk.n_links, occurrences=occ,
                          ranks=len(pk.bounds) - 1, max_rel_err=rel,
                          bitwise_numpy=bool(np.array_equal(got, want)),
                          device_ms=tr["busy_ms"], wall_ms=wall_ms,
                          idle_share=1.0 - tr["busy_ms"] / wall_ms,
                          launches=tr["launches"], copies=tr["copies"],
                          bound_ms=bound_ms, bound_by="bytes", call_s=card_s,
                          numpy_s=numpy_s, segments_32_or_more=int((seg_len >= 32).sum()),
                          index_put=dict(bitwise_numpy=bool(np.array_equal(put, want)),
                                         repeatable=bool(np.array_equal(put, put_again)),
                                         max_rel_err=put_rel, device_ms=put_tr["busy_ms"],
                                         wall_ms=put_ms, launches=put_tr["launches"]))
    print(f"phase 6a pricing: {len(demands)} demands of {len(jobs)} paper jobs on {n} "
          f"servers ({pk.n_links} links, {occ} occurrences in {len(pk.bounds) - 1} ranks, "
          f"{out['pricing']['segments_32_or_more']} segments of 32 or more): max rel err vs "
          f"NumPy {rel} (bar {pt.TORCH_EQUIV_RTOL}; bitwise {out['pricing']['bitwise_numpy']}), "
          f"two calls bitwise equal; device {tr['busy_ms']} ms busy ({tr['launches']} "
          f"launches, torch.profiler) in {wall_ms} ms wall a batch (CUDA events over 20 "
          f"calls), idle {out['pricing']['idle_share']:.2%}; bound {bound_ms} ms (bytes); "
          f"call {card_s} s with the host pack, NumPy {numpy_s} s; one index_put_ "
          f"(accumulate) instead: bitwise vs NumPy {out['pricing']['index_put']['bitwise_numpy']}"
          f", max rel err {put_rel}, repeatable {out['pricing']['index_put']['repeatable']}, "
          f"{put_tr['busy_ms']} ms busy ({put_tr['launches']} launches) in {put_ms} ms wall, "
          f"on {smi}")

    # 6b: the chain programs at the fused admission's shape.
    cands = admission_candidates(wl, n)
    init = {t.label: default_strategy(t.spec) for t in cands[0].tenants}
    pools = [pt.strategy_pool(t.spec, t.k, PLAN_POOL, ADMIT_SEED + pt._POOL_SEED_OFFSET + i,
                              init=init[t.label])
             for i, t in enumerate(cands[0].tenants)]
    topos = [topology_finder(js.union_for(init), hw.degree, pack="per_node") for js in cands]
    V, caps, comps, weights, _, _ = pt.pack_jobset_grid(cands, topos, hw, pools)
    C, T, S, L = V.shape
    require((C, T, S) == (len(ADMIT_SHIFTS), 4, PLAN_POOL), f"grid shape {V.shape}")
    ladder = np.array(pt.DEFAULT_TEMPER_LADDER)
    M, K, iters, k = len(ladder), ADMIT_CHAINS, PLAN_ITERS, ORACLE_CHAINS
    t_idx, s_idx, u = pt.draw_grid_streams(ADMIT_SEED, C, K, M, iters, T, S)
    su = pt.draw_swap_streams(ADMIT_SEED, C, K, M, iters)
    init_a = np.zeros((C, T), dtype=np.int64)
    grid = pt.TorchChainKernel(V, caps, comps, weights, device=dev)
    g_args = (init_a, ladder, t_idx, s_idx, u, su)
    g1, g2 = grid.run_grid(*g_args), grid.run_grid(*g_args)
    require(all(np.array_equal(a, b) for a, b in zip(g1, g2)), "two grid runs differ")
    t0 = time.perf_counter()
    gref = pt.run_grid_reference(V, caps, comps, weights, 0.0, "union", init_a, ladder,
                                 t_idx[:, :k], s_idx[:, :k], u[:, :k], su[:, :k])
    oracle_s = time.perf_counter() - t0
    require(np.array_equal(g1[0][:, :k], gref[0]), "grid chains vs run_grid_reference")
    g_err = float(np.abs(g1[1][:, :k] / gref[1] - 1).max())
    h_err = float(np.abs(g1[2][:, :k] / gref[2] - 1).max())
    require(g_err <= 1e-12 and h_err <= 1e-12, f"grid energies rel err {g_err}, {h_err}")
    flat = pt.TorchChainKernel(V[0], caps[0], comps, weights, device=dev)
    f_t, f_s, f_u = pt.draw_proposal_streams(ADMIT_SEED, K, iters, T, S)
    f_args = (np.zeros(T, dtype=np.int64), np.full(K, 0.1), f_t, f_s, f_u)
    f1, f2 = flat.run(*f_args), flat.run(*f_args)
    require(all(np.array_equal(a, b) for a, b in zip(f1, f2)), "two flat runs differ")
    fref = pt.run_chains_reference(V[0], caps[0], comps, weights, 0.0, "union",
                                   f_args[0], f_args[1][:k], f_t[:k], f_s[:k], f_u[:k])
    require(np.array_equal(f1[0][:k], fref[0]), "flat chains vs run_chains_reference")
    f_err = float(max(np.abs(f1[1][:k] / fref[1] - 1).max(),
                      np.abs(f1[2][:k] / fref[2] - 1).max()))
    require(f_err <= 1e-12, f"flat energies rel err {f_err}")
    for name, kern, fn, rows in (
        ("grid", grid, lambda: grid.run_grid(*g_args), C * K * M * T),
        ("flat", flat, lambda: flat.run(*f_args), K * T),
    ):
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tr = device_trace(fn)
        gathered = rows * L * 8 * (iters + 1)  # bytes of V gathered, all steps
        stats = dict(shape=[C, T, S, L] if name == "grid" else [T, S, L], chains=K,
                     rungs=M if name == "grid" else 1, iters=iters, wall_ms=wall_ms,
                     device_ms=tr["busy_ms"], launches=tr["launches"], copies=tr["copies"],
                     idle_share=1.0 - tr["busy_ms"] / wall_ms,
                     bound_ms=gathered / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        out[f"chains_{name}"] = stats
        print(f"phase 6b chains: {name} program, V {tuple(stats['shape'])}, {K} chains x "
              f"{stats['rungs']} rungs, {iters} iterations: {wall_ms} ms wall (host clock), "
              f"{tr['busy_ms']} ms device ({tr['launches']} launches, {tr['copies']} copies, "
              f"{tr['launches'] / iters} launches an iteration), idle {stats['idle_share']:.2%}; "
              f"bound {stats['bound_ms']} ms (bytes of V gathered: {gathered})")
    print(f"phase 6b chains: first {k} chains index for index against the NumPy oracles "
          f"(grid energies rel err {g_err}, history {h_err}; flat {f_err}; bar 1e-12), two "
          f"runs of each bitwise equal; the grid oracle took {oracle_s} s on the host")

    # 6c: alternating optimization of one job.
    kw = dict(rounds=PLAN_ROUNDS, mcmc_iters=PLAN_ITERS, seed=0, chains=PLAN_CHAINS,
              pool_size=PLAN_POOL)
    card = program_stats(  # the defaults: backend="torch" on the card
        lambda: alt.alternating_optimize(wl.DLRM, n, hw, **kw),
        {"chain programs": (pt.TorchChainKernel, "run"), "pools": (pt, "strategy_pool"),
         "topology_finder": (alt, "topology_finder"), "evaluate": (alt, "evaluate")})
    plan = card.pop("out")
    t0 = time.perf_counter()
    on_cpu = alt.alternating_optimize(wl.DLRM, n, hw, backend="torch", device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_plan = alt.alternating_optimize(wl.DLRM, n, hw, rounds=PLAN_ROUNDS,
                                          mcmc_iters=PLAN_ITERS, seed=0, backend="numpy")
    numpy_s = time.perf_counter() - t0
    require(plan.strategy == on_cpu.strategy and plan.iter_time == on_cpu.iter_time
            and sorted(plan.topology.graph.edges()) == sorted(on_cpu.topology.graph.edges()),
            f"DLRM plan on the card {plan.strategy} {plan.iter_time} vs the CPU's "
            f"{on_cpu.strategy} {on_cpu.iter_time}")
    require(plan.strategy.mode == "hybrid", f"DLRM plan {plan.strategy}")
    candle = alt.alternating_optimize(wl.CANDLE, n, hw, **kw)
    require(candle.strategy.mode == "dp", f"CANDLE plan {candle.strategy}")
    out["alternating"] = dict(
        dlrm_mode=plan.strategy.mode, dlrm_iter_time=plan.iter_time, rounds=plan.rounds,
        candle_mode=candle.strategy.mode, candle_iter_time=candle.iter_time,
        cpu_s=cpu_s, numpy_s=numpy_s, numpy_iter_time=numpy_plan.iter_time, **card)
    print(f"phase 6c alternating: DLRM on {n} servers, {PLAN_ROUNDS} rounds x {PLAN_ITERS} "
          f"iterations, {PLAN_CHAINS} chains, pool {PLAN_POOL}: {plan.strategy.mode} "
          f"({len(plan.strategy.table_hosts)} table hosts), iter_time {plan.iter_time!r} "
          f"(rounds {plan.rounds}), the CPU's plan to the bit; CANDLE {candle.strategy.mode} "
          f"{candle.iter_time!r}; wall {card['wall_s']} s on the card, {cpu_s} s torch on "
          f"the CPU, NumPy backend {numpy_s} s (its plan {numpy_plan.strategy.mode} "
          f"{numpy_plan.iter_time!r}); first call on the card {card['first_s']} s; steady "
          f"host wall by part (ms) {card['parts_ms']}, the rest (pricing the pools, the "
          f"NumPy re-price) {card['wall_s'] * 1e3 - sum(card['parts_ms'].values())} ms; chain "
          f"programs: {card['programs']} runs, {card['busy_ms']} ms device, "
          f"{card['launches']} launches, {card['copies']} copies, idle "
          f"{card['idle_share']:.2%}, on {smi}")

    # 6d: the fused four-tenant admission.
    def admit(device=None):
        cs = admission_candidates(wl, n)
        return alt.co_optimize_jobset(
            cs[0], hw, rounds=PLAN_ROUNDS, mcmc_iters=PLAN_ITERS, seed=ADMIT_SEED,
            placement_candidates=cs, chains=ADMIT_CHAINS,
            temperatures=pt.DEFAULT_TEMPER_LADDER, device=device)

    steady = program_stats(admit, {
        "grid programs": (pt.TorchChainKernel, "run_grid"),
        "pool pricing": (pt, "pack_jobset_grid"),
        "topology_finder": (alt, "topology_finder"),
        "pools": (pt, "strategy_pool"),
    })
    fused = steady.pop("out")
    t0 = time.perf_counter()
    on_cpu = admit("cpu")
    cpu_s = time.perf_counter() - t0
    same = lambda a, b: (a.candidate_index == b.candidate_index  # noqa: E731
                         and a.strategies == b.strategies and a.iter_time == b.iter_time
                         and sorted(a.topology.graph.edges())
                         == sorted(b.topology.graph.edges()))
    require(same(fused, on_cpu),
            f"admission plans differ: card {fused.iter_time}, CPU {on_cpu.iter_time}")
    modes = {k: v.mode for k, v in fused.strategies.items()}
    out["admission"] = dict(candidate=fused.candidate_index, iter_time=fused.iter_time,
                            modes=modes, grid=[C, T, S, L], cpu_s=cpu_s, **steady)
    print(f"phase 6d admission: 4 tenants x {len(ADMIT_SHIFTS)} placements, ladder "
          f"{pt.DEFAULT_TEMPER_LADDER}, {ADMIT_CHAINS} chains, {PLAN_ROUNDS} rounds x "
          f"{PLAN_ITERS} iterations: candidate {fused.candidate_index}, {modes}, iter_time "
          f"{fused.iter_time!r}, the CPU's plan; wall {steady['first_s']} s first call, "
          f"{steady['wall_s']} s steady, {cpu_s} s torch on the CPU; steady host wall by "
          f"part (ms) {steady['parts_ms']}, the rest "
          f"{steady['wall_s'] * 1e3 - sum(steady['parts_ms'].values())} ms; grid programs: "
          f"{steady['programs']} runs, {steady['busy_ms']} ms device, {steady['launches']} "
          f"launches, {steady['copies']} copies, idle {steady['idle_share']:.2%}, on {smi}")
    return out


if __name__ == "__main__":
    sys.exit(main())
