#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name and power limit (``nvidia-smi``), its torch name
   and the device count;
2. build: every CUDA kernel of the serving paths, from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), with ptxas's registers,
   shared memory, spills and wgmma serialisation warnings for each kernel;
   the warp-specialised wgmma kernels must report the 168 registers their
   setmaxnreg split (240 x 256 + 24 x 128) is sized for, and the skinny
   grouped matmul and the Mamba scan must not spill;
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
   two super-blocks, cross gates opened) and encoder (4 heads of 80);
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
5. the script's wall time, one JSON line of per-kernel numbers, the ``nvidia-smi`` line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Each serving phase sets every kernel's launch count to 0 just before its
run and reads the counts just after.  Times come from CUDA events (kernels)
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
KERNEL_COUNTERS = ("attention_launches", "grouped_matmul_launches", "selective_scan_launches",
                   "lru_scan_launches", "bag_lookup_launches")
# The same launches again, by the tiling that served them.
TILING_COUNTERS = ("attention_wgmma_launches", "attention_fma_launches",
                   "grouped_matmul_wgmma_launches", "grouped_matmul_fma_launches",
                   "grouped_matmul_skinny_launches")
COUNTERS = KERNEL_COUNTERS + TILING_COUNTERS
T_DLRM, R_DLRM, E_DLRM = 8, 10_000_000, 128  # the paper DLRM's tables, one host's 8 of 64
DLRM_BATCHES = (128, 4096)  # workloads.DLRM.batch_per_gpu, and a large scoring batch
DLRM_PATH = "dlrm-paper-8t"


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
    from repro_torch.launch.serve import generate
    from repro_torch.models import dlrm, layers, lm

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"phase 1 device: nvidia-smi: {smi}")
    print(f"phase 1 device: torch: {kind}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    kernels = ["flash_attention", "moe_gmm", "mamba_scan", "rglru_scan", "embedding_bag"]
    t0 = time.perf_counter()
    _build.load_all(kernels)
    print(f"phase 2 build: {', '.join(k + '.cu' for k in kernels)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in kernels:
        for fn, info in ptxas_report(_build.build_logs.get(name, "")).items():
            print(f"phase 2 build: ptxas {name}: {fn}: {info['registers']} registers, "
                  f"{info['smem']} bytes static smem, spill stores {info['spill_stores']} "
                  f"loads {info['spill_loads']} bytes, wgmma serialised: {info['serialised']}")
            if "wgmma_kernel" in fn:
                # setmaxnreg moves registers within the block's launch-time
                # allotment: consumers at 240 and the producer at 24 need 168.
                require(info["registers"] == 168,
                        f"{fn} uses {info['registers']} registers, want the 168 that its "
                        "setmaxnreg split (2 x 128 x 240 + 128 x 24) is sized for")
                require(info["spill_stores"] == info["spill_loads"] == 0
                        and not info["serialised"], f"{fn} spills or serialises: {info}")
            if "skinny_kernel" in fn or "mamba_scan_kernel" in fn:  # the streams and the scan
                require(info["spill_stores"] == info["spill_loads"] == 0, f"{fn} spills: {info}")

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
                     + vlm["attention_launches"] + hubert["attention_launches"]),
        "launches_by_path": {"granite-8b": granite_attention_launches, qwen_name: att_total,
                             "recurrentgemma-9b": griffin["attention_launches"],
                             "llama-3.2-vision-11b": vlm["attention_launches"],
                             "hubert-xlarge": hubert["attention_launches"]},
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


if __name__ == "__main__":
    sys.exit(main())
