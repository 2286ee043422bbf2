#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. device: the card's name and power limit (``nvidia-smi``), its torch name
   and the device count;
2. build: every CUDA kernel of the serving path, from ``src/repro_torch/csrc``;
3. kernels vs their plain PyTorch versions at the serving shapes (granite-8b:
   B=4, H=32, KV=8, D=128; S=1000 and 2048), with times beside the bound and
   beside one PyTorch library call; then a narrow fp32 model on the card
   against the same model on the CPU;
4. serve granite-8b at full width and depth in bf16 through
   ``repro_torch.launch.serve.generate`` (4 requests, prompt 1000, 16 decode
   steps), counting kernel launches, and hold its prefill against
   prefill-then-decode, which attends in plain PyTorch;
5. one JSON line of per-kernel numbers, the ``nvidia-smi`` line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Times come from CUDA events (kernels) or the host clock after a synchronise
(serving).  Bounds use the H100 SXM's published peaks at 700 W: 989 TFLOP/s
bf16/fp16 dense, 67 TFLOP/s fp32 without tensor cores, 3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# bf16/fp16: tests/test_kernels.py's fp16 bar.  fp32: sums of up to 2048
# terms run in another order on the card than in the plain version.
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
B, H, KV, D = 4, 32, 8, 128  # granite-8b's attention at the serving batch
PROMPT, DECODE_STEPS = 1000, 16


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


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
    Bq, Hq, Sq, Dq = q.shape
    Sk = k.shape[2]
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kj <= qi
    if window > 0:
        keep &= kj > qi - window
    pairs = int(keep.sum())
    flops = 4.0 * Bq * Hq * Dq * pairs  # q.k and p.v: 2 flops per multiply-add each
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import ref_flash_attention
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"phase 1 device: nvidia-smi: {smi}")
    print(f"phase 1 device: torch: {kind}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load("flash_attention")
    print(f"phase 2 build: flash_attention.cu in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2 build: ptxas: {line.strip()}")

    # Phase 3: the kernel against its plain version at the serving shapes.
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(S, dh, dtype):
        return tuple(
            torch.randn(B, n, S, dh, generator=gen, device=dev).to(dtype)
            for n in (H, KV, KV)
        )

    cases = [  # (S, D, dtype, causal, window)
        (PROMPT, D, torch.bfloat16, True, 0),
        (PROMPT, D, torch.float32, True, 0),
        (2048, D, torch.bfloat16, True, 0),
        (2048, D, torch.float32, True, 0),
        (PROMPT, 64, torch.bfloat16, True, 128),
        (PROMPT, D, torch.bfloat16, False, 0),
    ]
    main_case = {}
    for S, dh, dtype, causal, window in cases:
        q, k, v = qkv(S, dh, dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = ref_flash_attention(q, k, v, causal=causal, window=window)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        label = f"S={S} D={dh} {str(dtype)[6:]} causal={causal} window={window}"
        require(bool(torch.isfinite(out).all()), f"finite kernel output, {label}")
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"kernel vs plain at {tol}, {label}: max|err| {err}")
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), 20)
        plain_ms = time_ms(lambda: ref_flash_attention(q, k, v, causal=causal, window=window), 5)
        library_ms = None
        if window == 0:  # SDPA has no sliding window; a yardstick only, never on the port's path
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 20)
        bound_ms, bound_by = attention_bound(q, k, causal, window)
        print(f"phase 3 kernel: flash_attention {label}: max|err| {err} (tol {tol}) "
              f"kernel_ms {kernel_ms} plain_ms {plain_ms} library_ms {library_ms} "
              f"bound_ms {bound_ms} ({bound_by}) on {smi}")
        if (S, dh, dtype, causal, window) == cases[0]:
            main_case = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # A narrow granite in fp32 (head dim 64): kernel prefill on the card vs the
    # plain model on the CPU, same weights and prompts.
    small = dataclasses.replace(
        get_config("granite-8b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, param_dtype="float32", activation_dtype="float32",
    )
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

    # Phase 4: serve granite-8b at full width and depth.
    cfg = get_config("granite-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4 serve: {cfg.name} init on the card: {n_params} parameters "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device=dev)
    generate(model, tokens[:, :64], 2)  # warm-up: cuBLAS handles and heuristics

    ops.attention_launches = 0
    timings: dict = {}
    ids = generate(model, tokens, DECODE_STEPS, timings)
    launches = ops.attention_launches
    require(launches == cfg.n_layers,
            f"{launches} flash_attention launches in one prefill, want {cfg.n_layers}")
    require(tuple(ids.shape) == (B, DECODE_STEPS), f"generated ids shape {tuple(ids.shape)}")
    require(bool(((ids >= 0) & (ids < cfg.vocab)).all()), "generated ids in the vocabulary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = timings["decode_s"] / (DECODE_STEPS - 1) * 1e3
    print(f"phase 4 serve: {B}x{PROMPT} prefill {timings['prefill_s'] * 1e3} ms, decode "
          f"{decode_ms} ms/token over {DECODE_STEPS - 1} steps, peak memory {peak_gb} GB, "
          f"flash_attention launches {launches}, on {smi}")
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

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "tpu_ref": "kernels/flash_attention.py:84",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "max_err_bf16": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
