"""The CUDA kernels (flash attention and its backward, grouped matmul, Mamba
selective scan, RG-LRU scan, embedding bag) against their plain versions,
the narrow models (and a narrow DLRM) on the card against the CPU, a
narrow train step on the card against the same on the CPU, and the
planner's device path (pricing and chains) against its NumPy oracles.

Run on a machine with a CUDA card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Every test here skips without one (decided in the fixture, never at import).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, first_masked_row, flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.ref import (
    ref_embedding_bag, ref_flash_attention, ref_flash_attention_lse, ref_mamba_scan, ref_moe_gmm,
    ref_rglru_scan,
)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch import optim
from repro_torch.core import planeval_torch as pt
from repro_torch.core import workloads as wl
from repro_torch.core.netsim import HardwareSpec
from repro_torch.core.planeval import plan_evaluator
from repro_torch.core.strategy_search import default_strategy
from repro_torch.core.topology_finder import remove_pair, topology_finder
from repro_torch.models import dlrm, lm
from repro_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several test processes share the cores

pytestmark = pytest.mark.gpu

# bf16/fp16: test_kernels.py's fp16 bar.  fp32: the card sums up to 2048
# terms in another order than the plain version, so 1e-4 rather than 2e-5.
TOL = {torch.float32: 1e-4, torch.float16: 2e-2, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(device, B, H, KV, Sq, Sk, D, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (
        torch.randn(B, H, Sq, D, generator=gen, device=device).to(dtype),
        torch.randn(B, KV, Sk, D, generator=gen, device=device).to(dtype),
        torch.randn(B, KV, Sk, D, generator=gen, device=device).to(dtype),
    )


@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window",
    [
        (2, 8, 2, 256, 256, 128, True, 0),
        (1, 4, 1, 1000, 1000, 128, True, 0),   # ragged tail, MQA
        (2, 4, 4, 222, 222, 64, True, 0),
        (1, 4, 2, 512, 512, 64, True, 128),    # sliding window
        (2, 4, 4, 300, 300, 64, False, 0),     # bidirectional
        (1, 4, 2, 100, 300, 128, False, 0),    # Sq != Sk
        (1, 2, 2, 1, 1, 64, True, 0),          # one token
        (1, 4, 1, 300, 300, 256, True, 0),     # recurrentgemma's head dim, MQA
        (2, 16, 1, 256, 256, 256, True, 128),  # head dim 256, sliding window
        (1, 2, 1, 100, 300, 256, False, 0),    # head dim 256, Sq != Sk
        # Around the wgmma tiling's 128-row q tiles and 64-row k tiles.
        (1, 4, 2, 127, 127, 128, True, 0),
        (1, 4, 2, 129, 129, 128, True, 0),
        (1, 4, 1, 129, 129, 256, True, 64),
        (1, 4, 2, 300, 100, 64, True, 0),      # causal, Sq > Sk
        (1, 4, 2, 65, 200, 128, True, 0),      # causal, Sq < Sk
        # hubert-xlarge's head dim 80 (a 128-wide compute on wgmma).
        (2, 16, 16, 300, 300, 80, False, 0),
        (1, 4, 2, 127, 127, 80, True, 0),
        (1, 4, 2, 129, 129, 80, True, 0),
        (1, 4, 1, 127, 129, 80, False, 0),     # Sq != Sk
        (1, 4, 2, 256, 256, 80, True, 64),
        # llama-3.2-vision-11b's cross-attention: Sk = 1601 image tokens.
        (1, 32, 8, 100, 1601, 128, False, 0),
        # Rows that see no key (q >= Sk + window - 1): the mean of v over Sk.
        (1, 4, 2, 256, 200, 128, True, 16),
        (1, 4, 1, 256, 200, 64, False, 16),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_kernel_matches_plain(cuda, B, H, KV, Sq, Sk, D, causal, window, dtype):
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    expect = ref_flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), expect.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("tiling,dtype", [("wgmma", torch.bfloat16), ("wgmma", torch.float16),
                                          ("fma", torch.bfloat16), ("fma", torch.float32)])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal,window",
    [
        (2, 8, 2, 256, 200, 128, True, 16),   # rows 215..255 see no key
        (1, 4, 1, 256, 200, 256, True, 16),
        (1, 4, 2, 219, 200, 64, False, 16),   # the last 4 rows, across a 64-row warpgroup
        (1, 4, 2, 300, 64, 64, True, 1),      # a window of one key: rows 64.. see none
    ],
)
def test_kernel_fully_masked_rows_on_both_tilings(cuda, tiling, dtype, B, H, KV, Sq, Sk, D,
                                                   causal, window):
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=3)
    out = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling)
    torch.cuda.synchronize()
    expect = ref_flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), expect.float(), rtol=TOL[dtype], atol=TOL[dtype])
    first = first_masked_row(Sq, Sk, causal, window)
    assert first < Sq
    mean = v.float().mean(dim=2).repeat_interleave(H // KV, dim=1)[:, :, None]
    torch.testing.assert_close(out[:, :, first:].float(), mean.expand(-1, -1, Sq - first, -1),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("tiling,dtype", [("wgmma", torch.bfloat16), ("wgmma", torch.float16),
                                          ("fma", torch.bfloat16), ("fma", torch.float32)])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,causal",
    [
        (2, 16, 16, 200, 200, 80, False),   # hubert-xlarge's attention, narrowed
        (1, 4, 2, 129, 127, 80, True),
        (1, 32, 8, 130, 1601, 128, False),  # the VLM's cross-attention
    ],
)
def test_kernel_head_dim_80_and_cross_shape_on_both_tilings(cuda, tiling, dtype, B, H, KV, Sq,
                                                             Sk, D, causal):
    """Head dim 80 and the cross-attention shape on each tiling; at D = 80 the
    columns past D stay untouched (the output holds exactly D of them)."""
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=5)
    out = flash_attention(q, k, v, causal=causal, tiling=tiling)
    torch.cuda.synchronize()
    expect = ref_flash_attention(q, k, v, causal=causal)
    assert out.shape == (B, H, Sq, D) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), expect.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_takes_strided_views(cuda):
    """(B, S, H, D) activations transposed to (B, H, S, D), as prefill passes them."""
    q, k, v = _qkv(cuda, 2, 8, 2, 200, 200, 128, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(flash_attention(qt, kt, vt), flash_attention(q, k, v),
                               rtol=0, atol=0)


def test_ops_counts_launches_and_rejects_bad_shapes(cuda, monkeypatch):
    monkeypatch.setattr(ops, "attention_launches", 0)
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, 64, torch.bfloat16)
    ops.attention(q, k, v)
    ops.attention(q, k, v, causal=False)
    assert ops.attention_launches == 2
    q32, k32, v32 = _qkv(cuda, 1, 4, 2, 64, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.attention(q32, k32, v32)
    with pytest.raises(ValueError):
        ops.attention(q, k.float(), v)
    assert ops.attention_launches == 2


def test_model_on_card_matches_plain_model_on_cpu(cuda):
    """A narrow granite-8b (head dim 64) in fp32: kernel prefill vs the CPU's."""
    cfg = dataclasses.replace(
        get_config("granite-8b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, param_dtype="float32", activation_dtype="float32",
    )
    model_cpu = lm.init(0, cfg, device="cpu")
    model_gpu = lm.init(0, cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(0))
    lc, cc = lm.prefill(model_cpu, {"tokens": tokens}, cfg, pad_to=80)
    lg, cg = lm.prefill(model_gpu, {"tokens": tokens.to(cuda)}, cfg, pad_to=80)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cg["k"].cpu(), cc["k"], rtol=1e-4, atol=1e-4)


def _narrow_vlm_and_encoder_configs():
    """llama-3.2-vision-11b at head dim 128 (two super-blocks of 4 self and 1
    cross layer, 100 image tokens) and hubert-xlarge at head dim 80, in fp32."""
    fp32 = dict(param_dtype="float32", activation_dtype="float32")
    vlm = dataclasses.replace(
        get_config("llama-3.2-vision-11b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, n_layers=10, cross_attn_every=5, img_tokens=100, **fp32)
    enc = dataclasses.replace(
        get_config("hubert-xlarge").smoke(), d_model=320, n_heads=4, n_kv_heads=4,
        head_dim=80, d_ff=640, n_layers=2, **fp32)
    return vlm, enc


def test_vlm_and_encoder_on_card_match_plain_models_on_cpu(cuda, monkeypatch):
    """Every attention of both (self, cross, encoder) on the kernel, with the
    VLM's cross gates opened (at 0 they throw the cross-attention away)."""
    vlm, enc = _narrow_vlm_and_encoder_configs()
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(ops, "attention_launches", 0)
    for cfg in (vlm, enc):
        model_cpu = lm.init(0, cfg, device="cpu")
        for blk in model_cpu.blocks:
            if hasattr(blk.attn, "gate"):
                blk.attn.gate.fill_(1.0)
        model_gpu = lm.init(0, cfg, device=cuda)
        model_gpu.load_state_dict(model_cpu.state_dict())
        if cfg.family == "vlm":
            batch = {"tokens": torch.randint(0, cfg.vocab, (2, 77), generator=gen),
                     "image_embeds": torch.randn(2, cfg.img_tokens, cfg.d_model, generator=gen)}
        else:
            batch = {"frames": torch.randn(2, 77, cfg.d_model, generator=gen)}
        gpu_batch = {k: v.to(cuda) for k, v in batch.items()}
        fc, _ = lm.forward(model_cpu, batch, cfg)
        fg, _ = lm.forward(model_gpu, gpu_batch, cfg)
        torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
        lc, cc = lm.prefill(model_cpu, batch, cfg, pad_to=80)
        lg, cg = lm.prefill(model_gpu, gpu_batch, cfg, pad_to=80)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        for name in cc:
            torch.testing.assert_close(cg[name].cpu(), cc[name], rtol=1e-4, atol=1e-4)
        if cfg.family == "vlm":
            tok = lc.argmax(-1)
            dc, _ = lm.decode_step(model_cpu, {"token": tok, "pos": 77, "cache": cc}, cfg)
            dg, _ = lm.decode_step(model_gpu, {"token": tok.to(cuda), "pos": 77, "cache": cg}, cfg)
            torch.testing.assert_close(dg.cpu(), dc, rtol=1e-4, atol=1e-4)
    # forward and prefill: 8 self + 2 cross layers each, then 2 encoder layers each
    assert ops.attention_launches == 2 * 10 + 2 * 2


def _xw(device, E, C, D, F, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(E, C, D, generator=gen, device=device).to(dtype)
    w = (torch.randn(E, D, F, generator=gen, device=device) / D**0.5).to(dtype)
    return x, w


@pytest.mark.parametrize(
    "E,C,D,F,dtype",
    [
        # qwen3-moe-30b-a3b's expert products at prefill (C = 312) and decode (C = 1).
        (128, 312, 2048, 768, torch.bfloat16),
        (128, 312, 768, 2048, torch.bfloat16),
        (128, 312, 2048, 768, torch.float32),
        (128, 312, 768, 2048, torch.float32),
        (128, 1, 2048, 768, torch.bfloat16),
        (128, 1, 768, 2048, torch.bfloat16),
        # Ragged on every axis; around the skinny/tiled switch at C = 16;
        # D and F off the vector widths (element-wise loads).
        (3, 77, 200, 136, torch.bfloat16),
        (3, 77, 200, 136, torch.float16),
        (3, 77, 200, 136, torch.float32),
        (5, 5, 64, 136, torch.bfloat16),
        (5, 16, 300, 520, torch.float32),
        (5, 17, 300, 520, torch.bfloat16),
        (2, 70, 201, 135, torch.bfloat16),
        (2, 3, 201, 135, torch.float32),
        # Around the wgmma tiling's 128 x 256 tiles: one row past a tile,
        # D and F off the 64-wide boxes; and fp16 at the prefill shape.
        (3, 129, 2048, 768, torch.bfloat16),
        (4, 129, 72, 136, torch.bfloat16),
        (4, 129, 72, 136, torch.float16),
        (128, 312, 2048, 768, torch.float16),
    ],
)
def test_gmm_kernel_matches_plain(cuda, E, C, D, F, dtype):
    x, w = _xw(cuda, E, C, D, F, dtype)
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (E, C, F)
    torch.testing.assert_close(out.float(), ref_moe_gmm(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_gmm_kernel_with_zero_rows_past_each_count(cuda):
    """A dispatch buffer as the MoE layer leaves it: rows past each expert's
    count are zero, so those rows of the output are zero too."""
    x, w = _xw(cuda, 16, 312, 2048, 768, torch.bfloat16)
    counts = torch.randint(0, 313, (16,), generator=torch.Generator().manual_seed(0))
    rows = torch.arange(312)[None, :] < counts[:, None]
    x = x * rows[..., None].to(cuda, x.dtype)
    out = moe_gmm(x, w)
    torch.testing.assert_close(out.float(), ref_moe_gmm(x, w).float(), rtol=2e-2, atol=2e-2)
    assert float(out[~rows.to(cuda)].abs().max()) == 0.0


def _with_empty_experts(x, C):
    """Experts 0..E/2-1 all zero (no token routed there); of the rest, expert
    E/2 keeps only its first row and E/2 + 1 only its last, so at C > 1
    some 4-row blocks are partly zero and must not be skipped."""
    E = x.shape[0]
    x = x.clone()
    x[: E // 2] = 0
    if C > 1:
        x[E // 2, 1:] = 0
        x[E // 2 + 1, :-1] = 0
    return x


@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize(
    "D,F,dtype",
    [
        (2048, 768, torch.bfloat16),  # qwen3-moe's gate/up and down widths
        (768, 2048, torch.bfloat16),
        (512, 384, torch.float16),
        (512, 384, torch.float32),
        (300, 135, torch.bfloat16),   # ragged D; F rows off 16 bytes: the non-bulk producer
        (301, 130, torch.float32),
    ],
)
def test_gmm_skinny_skips_empty_experts(cuda, C, D, F, dtype):
    """Blocks whose rows of x are all zero write zeros without reading w;
    with finite weights that is the plain version's result."""
    x, w = _xw(cuda, 8, C, D, F, dtype, seed=C)
    x = _with_empty_experts(x, C)
    out = moe_gmm(x, w, tiling="skinny")
    torch.cuda.synchronize()
    expect = ref_moe_gmm(x, w)
    torch.testing.assert_close(out.float(), expect.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert float(out[:4].float().abs().max()) == 0.0
    assert bool(out[4].ne(0).any()) and bool(out[5].ne(0).any())


def test_gmm_skinny_empty_expert_contract_is_for_finite_weights(cuda):
    """The wrapper's stated contract: an expert whose rows are all zero gets
    zeros without its weights being read, so a NaN or inf weight there gives
    0 where the plain version gives NaN; a live expert's NaN still shows."""
    x, w = _xw(cuda, 4, 1, 256, 128, torch.bfloat16)
    x[0] = 0
    w[0, 3, 5] = float("nan")
    w[1, 7, 9] = float("inf")
    w[2, 0, 1] = float("nan")
    out = moe_gmm(x, w, tiling="skinny")
    expect = ref_moe_gmm(x, w)
    assert bool(expect[0].isnan().any()) and float(out[0].float().abs().max()) == 0.0
    assert bool(out[1].isinf().any() or out[1].isnan().any())
    assert bool(out[2, 0, 1].isnan())
    torch.testing.assert_close(out[3].float(), expect[3].float(), rtol=2e-2, atol=2e-2)


def test_gmm_kernel_takes_strided_views(cuda):
    x, w = _xw(cuda, 8, 40, 256, 384, torch.bfloat16)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    wt = w.transpose(0, 1).contiguous().transpose(0, 1)
    assert not xt.is_contiguous() and not wt.is_contiguous()
    torch.testing.assert_close(moe_gmm(xt, wt), moe_gmm(x, w), rtol=0, atol=0)
    torch.testing.assert_close(moe_gmm(x[:, :1], w), moe_gmm(x[:, :1].contiguous(), w),
                               rtol=0, atol=0)


def test_ops_counts_gmm_launches_and_rejects_mixed_dtypes(cuda, monkeypatch):
    monkeypatch.setattr(ops, "grouped_matmul_launches", 0)
    x, w = _xw(cuda, 4, 20, 64, 32, torch.bfloat16)
    ops.grouped_matmul(x, w)
    ops.grouped_matmul(x[:, :1], w)
    assert ops.grouped_matmul_launches == 2
    with pytest.raises(ValueError, match="share"):
        ops.grouped_matmul(x, w.float())
    with pytest.raises(ValueError):
        ops.grouped_matmul(x, w[:, :32])
    assert ops.grouped_matmul_launches == 2


TILING_COUNTERS = ("attention_wgmma_launches", "attention_fma_launches",
                   "grouped_matmul_wgmma_launches", "grouped_matmul_fma_launches",
                   "grouped_matmul_skinny_launches")


def test_served_shapes_take_the_wgmma_tiling(cuda, monkeypatch):
    """bf16 prefill attention (granite-8b's D = 128, recurrentgemma-9b's
    D = 256, hubert-xlarge's D = 80) and the prefill grouped matmul count on the wgmma tiling, decode's
    grouped matmul on the skinny one, and the fma tiling's counts stay 0."""
    for name in TILING_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    ops.attention(*_qkv(cuda, 1, 32, 8, 300, 300, 128, torch.bfloat16))
    ops.attention(*_qkv(cuda, 1, 16, 1, 300, 300, 256, torch.bfloat16), window=2048)
    ops.attention(*_qkv(cuda, 1, 16, 16, 300, 300, 80, torch.bfloat16), causal=False)
    x, w = _xw(cuda, 8, 312, 2048, 768, torch.bfloat16)
    ops.grouped_matmul(x, w)
    ops.grouped_matmul(x[:, :1], w)
    counts = {name: getattr(ops, name) for name in TILING_COUNTERS}
    assert counts == {"attention_wgmma_launches": 3, "attention_fma_launches": 0,
                      "grouped_matmul_wgmma_launches": 1, "grouped_matmul_fma_launches": 0,
                      "grouped_matmul_skinny_launches": 1}
    ops.attention(*_qkv(cuda, 1, 4, 2, 64, 64, 64, torch.float32))
    ops.grouped_matmul(x.float(), w.float())
    assert ops.attention_fma_launches == 1 and ops.grouped_matmul_fma_launches == 1


def test_wrappers_refuse_a_tiling_that_does_not_take_the_input(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="tiling"):
        flash_attention(q, k, v, tiling="wgmma")
    x, w = _xw(cuda, 2, 40, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm(x, w, tiling="wgmma")
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm(x, w, tiling="skinny")
    xb, wb = _xw(cuda, 2, 40, 60, 32, torch.bfloat16)  # D % 8 != 0: no TMA stride
    with pytest.raises(ValueError, match="tiling"):
        moe_gmm(xb, wb, tiling="wgmma")


def _narrow_moe_config():
    """qwen3-moe's smoke config widened to head dim 64, in fp32, at capacity
    1.0 so that prefill drops entries."""
    return dataclasses.replace(
        get_config("qwen3-moe-30b-a3b").smoke(), d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=128, n_experts=8, top_k=2, capacity_factor=1.0,
        param_dtype="float32", activation_dtype="float32",
    )


def test_moe_model_on_card_matches_plain_model_on_cpu(cuda, monkeypatch):
    cfg = _narrow_moe_config()
    model_cpu = lm.init(0, cfg, device="cpu")
    model_gpu = lm.init(0, cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(ops, "grouped_matmul_launches", 0)
    fc, ac = lm.forward(model_cpu, {"tokens": tokens}, cfg)
    fg, ag = lm.forward(model_gpu, {"tokens": tokens.to(cuda)}, cfg)
    assert ops.grouped_matmul_launches == 3 * cfg.n_layers
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ag.cpu(), ac, rtol=1e-4, atol=1e-4)
    lc, cc = lm.prefill(model_cpu, {"tokens": tokens}, cfg, pad_to=80)
    lg, cg = lm.prefill(model_gpu, {"tokens": tokens.to(cuda)}, cfg, pad_to=80)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for pos in (77, 78):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(model_cpu, {"token": tok, "pos": pos, "cache": cc}, cfg)
        lg, cg = lm.decode_step(model_gpu, {"token": tok.to(cuda), "pos": pos, "cache": cg}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def test_moe_model_never_waits_on_the_card(cuda):
    """Prefill and decode enqueue their work without a host sync (no
    ``.item()``, no ``bincount``, no boolean-mask indexing): the decode step
    is bound by the host already."""
    cfg = _narrow_moe_config()
    model = lm.init(0, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (4, 100), device=cuda)
    logits, cache = lm.prefill(model, {"tokens": tokens}, cfg, pad_to=104)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = lm.prefill(model, {"tokens": tokens}, cfg, pad_to=104)
        lm.decode_step(model, {"token": logits.argmax(-1), "pos": 100, "cache": cache}, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# The recurrent scans and the recurrent models
# ---------------------------------------------------------------------------


def _mamba_inputs(device, B, L, DI, ST, dtype, seed=0, R=None):
    """Inputs as the Mamba layer makes them; with ``R``, b and c are strided
    slices of one (B, L, R + 2 ST) projection."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    xc = randn(B, L, DI).to(dtype)
    dt = torch.rand(B, L, DI, generator=gen, device=device) * 0.099 + 0.001
    a = -torch.arange(1, ST + 1, dtype=torch.float32, device=device).repeat(DI, 1)
    if R is None:
        b, c = randn(B, L, ST).to(dtype), randn(B, L, ST).to(dtype)
    else:
        xdbc = randn(B, L, R + 2 * ST).to(dtype)
        b, c = xdbc[..., R:R + ST], xdbc[..., R + ST:]
    return xc, dt, a, b, c, randn(DI)


@pytest.mark.parametrize(
    "B,L,DI,ST,R",
    [
        (4, 1000, 8192, 16, 256),  # falcon-mamba-7b's prefill, b and c strided
        (2, 37, 200, 16, None),    # L not a multiple of 16, DI not of the block
        (3, 64, 32, 4, None),      # fewer states than a thread holds
        (1, 50, 72, 24, 8),        # states padded to 32
        (2, 20, 40, 128, None),    # the most states the kernel takes
        (1, 1, 8, 5, None),        # one step
        # L off the 16-step staging chunk, every lanes-a-channel width
        # (1, 2, 4, 8 at 16 states a thread), b and c strided, and both
        # producers: TMA boxes, and plain loads where rows are off 16 bytes.
        (2, 33, 72, 1, None),      # one state
        (1, 45, 40, 64, None),     # 4 lanes a channel
        (2, 50, 96, 16, 8),        # b and c strided, on 16 bytes: TMA
        (1, 19, 33, 16, None),     # DI odd: plain loads
        (1, 20, 24, 5, 3),         # b and c rows off 16 bytes: plain loads
        (2, 17, 16, 128, 4),       # 8 lanes a channel, strided
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_kernel_matches_plain(cuda, B, L, DI, ST, R, dtype):
    """fp32 arithmetic either way; the bar is 1e-4 of max|y| (2e-2 with bf16
    inputs, the bf16 bar)."""
    args = _mamba_inputs(cuda, B, L, DI, ST, dtype, R=R)
    y, h = mamba_scan(*args)
    torch.cuda.synchronize()
    ey, eh = ref_mamba_scan(*args)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, L, DI) and h.shape == (B, DI, ST)
    tol = 1e-4 * float(ey.abs().max()) if dtype == torch.float32 else 2e-2
    assert float((y - ey).abs().max()) <= tol
    assert float((h - eh).abs().max()) <= max(tol, 1e-4 * float(eh.abs().max()))


@pytest.mark.parametrize(
    "B,L,D", [(4, 2048, 4096), (3, 1000, 200), (2, 17, 130), (1, 1, 5)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_rglru_kernel_matches_plain(cuda, B, L, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = (torch.rand(B, L, D, generator=gen, device=cuda) * 0.89 + 0.1).to(dtype)
    b = torch.randn(B, L, D, generator=gen, device=cuda).to(dtype)
    h, f = rglru_scan(a, b)
    torch.cuda.synchronize()
    eh, ef = ref_rglru_scan(a, b)
    assert h.dtype == f.dtype == torch.float32 and f.shape == (B, D)
    torch.testing.assert_close(h, eh, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f, ef, rtol=1e-5, atol=1e-5)


def test_ops_count_scan_launches_and_reject_bad_inputs(cuda, monkeypatch):
    monkeypatch.setattr(ops, "selective_scan_launches", 0)
    monkeypatch.setattr(ops, "lru_scan_launches", 0)
    xc, dt, a, b, c, d = _mamba_inputs(cuda, 1, 8, 16, 8, torch.float32)
    ops.selective_scan(xc, dt, a, b, c, d)
    ops.lru_scan(dt, xc)
    assert ops.selective_scan_launches == 1 and ops.lru_scan_launches == 1
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan(xc, dt.half(), a, b, c, d)
    with pytest.raises(ValueError, match="share"):
        ops.selective_scan(xc, dt, a, b.half(), c, d)
    with pytest.raises(ValueError, match="shapes"):
        ops.selective_scan(xc, dt, a, b[:, :4], c, d)
    with pytest.raises(ValueError, match="share"):
        ops.lru_scan(dt, xc.half())
    assert ops.selective_scan_launches == 1 and ops.lru_scan_launches == 1


def _narrow_recurrent_config(arch):
    """The smoke configs widened, in fp32; Griffin's attention at head dim 64
    with a 32-token window, which the 77-token prompts pass."""
    over = dict(d_model=256, param_dtype="float32", activation_dtype="float32")
    if arch == "falcon-mamba-7b":
        over.update(ssm_state=16, dt_rank=16)
    else:
        over.update(n_heads=4, n_kv_heads=1, head_dim=64, d_ff=512, lru_width=256,
                    attn_window=32)
    return dataclasses.replace(get_config(arch).smoke(), **over)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_model_on_card_matches_plain_model_on_cpu(cuda, arch, monkeypatch):
    cfg = _narrow_recurrent_config(arch)
    model_cpu = lm.init(0, cfg, device="cpu")
    model_gpu = lm.init(0, cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(ops, "selective_scan_launches", 0)
    monkeypatch.setattr(ops, "lru_scan_launches", 0)
    fc, _ = lm.forward(model_cpu, {"tokens": tokens}, cfg)
    fg, _ = lm.forward(model_gpu, {"tokens": tokens.to(cuda)}, cfg)
    scans = ops.selective_scan_launches + ops.lru_scan_launches
    n_rec = cfg.n_layers if arch == "falcon-mamba-7b" else 2 * (cfg.n_layers // 3) + 2
    assert scans == n_rec
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
    lc, cc = lm.prefill(model_cpu, {"tokens": tokens}, cfg)
    lg, cg = lm.prefill(model_gpu, {"tokens": tokens.to(cuda)}, cfg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name in cc:
        torch.testing.assert_close(cg[name].cpu(), cc[name], rtol=1e-4, atol=1e-4)
    for pos in (77, 78):
        tok = lc.argmax(-1)
        lc, cc = lm.decode_step(model_cpu, {"token": tok, "pos": pos, "cache": cc}, cfg)
        lg, cg = lm.decode_step(model_gpu, {"token": tok.to(cuda), "pos": pos, "cache": cg}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert ops.selective_scan_launches + ops.lru_scan_launches == 2 * n_rec  # none at decode


def _bag_inputs(device, T, R, E, B, NNZ, dtype, id_dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = torch.randn(T, R, E, generator=gen, device=device).to(dtype)
    ids = torch.randint(0, R, (B, T, NNZ), generator=gen, device=device).to(id_dtype)
    return tables, ids


def _assert_bag_close(out, expect, tables, NNZ):
    """test_kernels.py's bars: in fp32 rtol 1e-6 and an atol of NNZ ulps of
    the largest term (the sums run in another order); 2e-2 in bf16/fp16."""
    assert out.dtype == tables.dtype and out.shape == expect.shape
    if tables.dtype == torch.float32:
        atol = NNZ * torch.finfo(torch.float32).eps * float(tables.abs().max())
        torch.testing.assert_close(out, expect, rtol=1e-6, atol=atol)
    else:
        torch.testing.assert_close(out.float(), expect.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("NNZ", [1, 7, 32])
@pytest.mark.parametrize("E", [128, 16, 13, 200])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_bag_kernel_matches_plain(cuda, dtype, id_dtype, E, NNZ):
    tables, ids = _bag_inputs(cuda, 3, 1000, E, 5, NNZ, dtype, id_dtype)
    out = embedding_bag(tables, ids)
    torch.cuda.synchronize()
    _assert_bag_close(out, ref_embedding_bag(tables, ids), tables, NNZ)


def test_bag_kernel_with_one_id_equals_the_rows_bitwise(cuda):
    tables, ids = _bag_inputs(cuda, 4, 5000, 128, 64, 1, torch.float32, torch.int32)
    out = embedding_bag(tables, ids)
    rows = tables[torch.arange(4, device=cuda)[None, :], ids[:, :, 0].long()]
    assert torch.equal(out, rows)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_bag_kernel_clamps_and_wraps_ids_past_the_table(cuda, id_dtype):
    """An id >= R reads row R - 1, a negative id wraps by R (then clamps to 0),
    as the reference's XLA gather does."""
    R = 50
    tables, _ = _bag_inputs(cuda, 2, R, 16, 1, 1, torch.float32, id_dtype)
    raw = [R, R + 7, -1, -R, -R - 3, 2**31 - 1, -(2**31)]
    ids = torch.tensor(raw, device=cuda).to(id_dtype)[:, None, None].expand(-1, 2, 1)
    out = embedding_bag(tables, ids)
    rows = [R - 1, R - 1, R - 1, 0, 0, R - 1, 0]
    expect = tables[:, rows].transpose(0, 1)
    assert torch.equal(out, expect)
    assert torch.equal(ref_embedding_bag(tables, ids), expect)


def test_bag_kernel_takes_strided_views(cuda):
    """Row-sliced, column-sliced and transposed tables, and strided ids: the
    same sums as on contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randn(3, 400, 16, generator=gen, device=cuda)
    ids_big = torch.randint(0, 200, (6, 3, 10), generator=gen, device=cuda)
    ids = ids_big[:, :, ::2]  # (6, 3, 5), last stride 2
    views = [
        big[:, :, :13],  # 16-byte rows, ragged E: vector loads and a scalar tail
        big[:, ::2, :],  # every other row
        big.transpose(1, 2).contiguous().transpose(1, 2),  # element stride R: scalar kernel
        big[:, :, 1:9],  # rows not 16-byte aligned: scalar kernel
    ]
    for tables in views:
        out = embedding_bag(tables, ids)
        expect = embedding_bag(tables.contiguous(), ids.contiguous())
        assert torch.equal(out, expect)
        _assert_bag_close(out, ref_embedding_bag(tables, ids), tables, 5)
    sparse = ids_big[:, :, 0].t().contiguous().t()  # (6, 3) transposed, as a view
    out = embedding_bag(big, sparse[:, :, None])
    assert torch.equal(out, embedding_bag(big, sparse.contiguous()[:, :, None]))


def test_bag_kernel_offsets_past_int32(cuda):
    """Table 2 of (3, 9e6, 128) starts 2.3e9 elements in, past INT_MAX."""
    T, R, E = 3, 9_000_000, 128
    tables = torch.randn(T, R, E, device=cuda, dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(R - 1000, R, (64, T, 4), generator=gen, device=cuda)
    out = embedding_bag(tables, ids)
    _assert_bag_close(out, ref_embedding_bag(tables, ids), tables, 4)
    one = embedding_bag(tables, ids[:, :, :1])
    assert torch.equal(one, tables[torch.arange(T, device=cuda)[None, :], ids[:, :, 0]])


def test_ops_counts_bag_launches_and_rejects_bad_inputs(cuda, monkeypatch):
    monkeypatch.setattr(ops, "bag_lookup_launches", 0)
    tables, ids = _bag_inputs(cuda, 2, 100, 16, 3, 2, torch.float32, torch.int32)
    ops.bag_lookup(tables, ids)
    ops.bag_lookup(tables.bfloat16(), ids.long())
    assert ops.bag_lookup_launches == 2
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.bag_lookup(tables, ids.cpu())
    with pytest.raises(ValueError, match="tables must be"):
        ops.bag_lookup(tables.double(), ids)
    with pytest.raises(ValueError, match="indices must be"):
        ops.bag_lookup(tables, ids.short())
    with pytest.raises(ValueError, match="indices"):
        ops.bag_lookup(tables, ids[:, :1])
    assert ops.bag_lookup_launches == 2


def test_dlrm_on_card_matches_plain_dlrm_on_cpu(cuda, monkeypatch):
    cfg = dlrm.DLRMConfig(n_tables=4, rows_per_table=1000, embed_dim=16,
                          bottom_mlp=(32, 32), top_mlp=(32, 32, 1))
    model_cpu = dlrm.init(0, cfg, device="cpu")
    model_gpu = dlrm.init(0, cfg, device=cuda)
    model_gpu.load_state_dict(model_cpu.state_dict())
    gen = torch.Generator().manual_seed(0)
    batch = {"dense": torch.randn(64, cfg.dense_features, generator=gen),
             "sparse": torch.randint(0, cfg.rows_per_table, (64, cfg.n_tables), generator=gen)}
    batch["label"] = batch["sparse"][:, 0] % 2
    monkeypatch.setattr(ops, "bag_lookup_launches", 0)
    lc, _ = dlrm.loss_fn(model_cpu, batch, cfg)
    lg, _ = dlrm.loss_fn(model_gpu, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    fc = dlrm.forward(model_cpu, batch["dense"], batch["sparse"], cfg)
    fg = dlrm.forward(model_gpu, batch["dense"].to(cuda), batch["sparse"].to(cuda), cfg)
    assert ops.bag_lookup_launches == 2
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training: the forward's lse, the backward kernel, the raises under grad
# ---------------------------------------------------------------------------

BWD_CASES = [  # (B, H, KV, Sq, Sk, causal, window)
    (2, 4, 4, 200, 200, True, 0),
    (1, 8, 2, 130, 130, True, 0),      # GQA 4:1, ragged tiles
    (1, 4, 1, 257, 257, True, 64),     # MQA, sliding window
    (1, 4, 2, 300, 300, False, 0),     # full
    (1, 4, 2, 300, 300, False, 48),    # window, not causal
    (1, 4, 4, 100, 300, False, 0),     # Sq < Sk
    (1, 4, 2, 127, 65, True, 0),       # causal, Sq > Sk
    (1, 2, 2, 1, 1, True, 0),          # one token
    (1, 32, 8, 100, 1601, False, 0),   # llama-3.2-vision-11b's cross-attention to its image
]


def _plain_grads(q, k, v, do, causal, window):
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    out = ref_flash_attention(qf, kf, vf, causal=causal, window=window)
    return torch.autograd.grad(out, (qf, kf, vf), do.float())


BWD_TILINGS = [("wgmma", torch.bfloat16), ("wgmma", torch.float16), ("fma", torch.float32),
               ("fma", torch.float16), ("fma", torch.bfloat16)]
BWD_COUNTERS = ("attention_launches", "attention_wgmma_launches", "attention_fma_launches",
                "attention_bwd_launches", "attention_bwd_wgmma_launches",
                "attention_bwd_fma_launches")


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", BWD_CASES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("tiling,dtype", BWD_TILINGS)
def test_bwd_kernel_matches_autograd_of_plain(cuda, tiling, dtype, D, B, H, KV, Sq, Sk, causal,
                                              window):
    """dq, dk, dv within TOL max(max|ref|, 1) of autograd of the plain version
    (fp32), on either tiling: relative to the largest gradient, and absolute
    where the gradient cancels to 0 (one key: dS = dP - delta = 0 but for
    rounding)."""
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=4)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).to(dtype)
    lse = torch.empty(B, H, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, tiling=tiling)
    torch.cuda.synchronize()
    for g, want, t in zip(got, _plain_grads(q, k, v, do, causal, window), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        err = float((g.float() - want).abs().max())
        assert err <= TOL[dtype] * max(float(want.abs().max()), 1.0), err


@pytest.mark.parametrize("tiling", ["wgmma", "fma"])
@pytest.mark.parametrize("D", [64, 128])
def test_bwd_kernel_is_deterministic(cuda, tiling, D):
    """No atomics: every sum runs in a fixed order, so repeated launches give
    the same bits (GQA 4:1, so dk and dv sum over 4 heads)."""
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 300, D, torch.bfloat16, seed=6)
    do = torch.randn_like(q)
    lse = torch.empty(2, 8, 300, device=cuda)
    o = flash_attention(q, k, v, lse=lse)
    first = flash_attention_bwd(q, k, v, o, lse, do, tiling=tiling)
    for _ in range(3):
        again = flash_attention_bwd(q, k, v, o, lse, do, tiling=tiling)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("D", [80, 256])
def test_bwd_kernel_refuses_head_dims_it_does_not_take(cuda, D):
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, D, torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match=f"head dim {D}"):
        flash_attention_bwd(q, k, v, q, lse, q)


def test_bwd_wgmma_tiling_refuses_fp32(cuda):
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, 64, torch.float32)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        flash_attention_bwd(q, k, v, q, lse, q, tiling="wgmma")


@pytest.mark.parametrize("tiling,dtype", [("wgmma", torch.bfloat16), ("wgmma", torch.float16),
                                          ("fma", torch.bfloat16), ("fma", torch.float32)])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window", [(200, 200, True, 0), (129, 300, False, 0),
                                                 (256, 256, True, 64)])
def test_forward_lse_on_both_tilings(cuda, tiling, dtype, D, Sq, Sk, causal, window):
    """The lse either tiling writes (natural log) against the plain one; the
    output is the same with and without it."""
    q, k, v = _qkv(cuda, 2, 4, 2, Sq, Sk, D, dtype, seed=7)
    lse = torch.full((2, 4, Sq), float("nan"), device=cuda)
    out = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling, lse=lse)
    plain = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    want = ref_flash_attention_lse(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


def test_flash_attention_fn_counts_and_matches_plain(cuda, monkeypatch):
    """Under grad, ``ops.attention`` goes through FlashAttentionFn: one
    forward launch with lse, one backward launch, the plain gradients."""
    for name in BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v = (t.requires_grad_(True) for t in _qkv(cuda, 1, 4, 2, 100, 100, 64, torch.float32))
    do = torch.randn_like(q)
    out = ops.attention(q, k, v, causal=True, window=0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    assert {n: getattr(ops, n) for n in BWD_COUNTERS} == dict(
        attention_launches=1, attention_wgmma_launches=0, attention_fma_launches=1,
        attention_bwd_launches=1, attention_bwd_wgmma_launches=0, attention_bwd_fma_launches=1)
    for g, want in zip(got, _plain_grads(q.detach(), k.detach(), v.detach(), do, True, 0)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():  # serving: the plain launch, no lse, no graph
        assert ops.attention(q, k, v).grad_fn is None
    assert ops.attention_launches == 2 and ops.attention_bwd_launches == 1


def test_bwd_wrapper_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 256, 200, 64, torch.bfloat16)
    lse = torch.empty(1, 4, 256, device=cuda)
    with pytest.raises(ValueError, match="see no key"):
        flash_attention_bwd(q, k, v, q, lse, q, True, 16)
    with pytest.raises(ValueError, match="see no key"):
        FlashAttentionFn.apply(q.requires_grad_(True), k, v, True, 16, "wgmma")
    q80, k80, v80 = _qkv(cuda, 1, 4, 2, 64, 64, 80, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 80"):
        flash_attention_bwd(q80, k80, v80, q80, torch.empty(1, 4, 64, device=cuda), q80)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q[:, :, :200], k, v, q[:, :, :200], lse.half()[:, :, :200],
                            q[:, :, :200])


def test_kernels_without_a_backward_raise_under_grad(cuda):
    """moe_gmm, mamba_scan, rglru_scan and embedding_bag have no backward
    kernel yet: on a CUDA input that requires grad they raise, naming the
    ROADMAP item, rather than hand autograd a constant; under no_grad, or
    with inputs that need no grad, they launch as in serving."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(4, 8, 64, generator=gen, device=cuda)
    w = torch.randn(4, 64, 32, generator=gen, device=cuda)
    a = torch.rand(2, 10, 64, generator=gen, device=cuda)
    b = torch.randn(2, 10, 64, generator=gen, device=cuda)
    xc, dt, am, bm, cm, ds = _mamba_inputs(cuda, 2, 10, 64, 16, torch.float32)
    tables, ids = _bag_inputs(cuda, 2, 100, 16, 3, 2, torch.float32, torch.int32)
    calls = {
        "moe_gmm.*C2": (ops.grouped_matmul, (x, w), 1),
        "mamba_scan.*C3": (ops.selective_scan, (xc, dt, am, bm, cm, ds), 0),
        "rglru_scan.*C4": (ops.lru_scan, (a, b), 1),
        "embedding_bag.*C5": (ops.bag_lookup, (tables, ids), 0),
    }
    for match, (fn, args, i) in calls.items():
        fn(*args)  # no input needs grad: the kernel launches
        args = list(args)
        args[i] = args[i].detach().clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match=match):
            fn(*args)
        with torch.no_grad():
            fn(*args)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_train_step_on_card_matches_cpu(cuda, remat, monkeypatch):
    """One narrow fp32 train step (head dim 64, 2 layers, GQA): loss, grad
    norm and every updated parameter within 1e-4 of the same step on the
    CPU, and the attention launches remat implies.  SGD: its update is
    linear in the gradient (AdamW's sign-like first step is held in
    test_torch_train.py on the CPU)."""
    for name in ("attention_launches", "attention_bwd_launches"):
        monkeypatch.setattr(ops, name, 0)
    cfg = dataclasses.replace(
        get_config("minicpm-2b").smoke(), d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, n_layers=2, param_dtype="float32", activation_dtype="float32")
    m_cpu = lm.init(0, cfg, device="cpu")
    m_gpu = lm.init(0, cfg, device=cuda)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(3))
    opt = optim.sgd_momentum(optim.constant(0.1))
    step = make_train_step(cfg, opt, remat=remat, loss_chunk=32)
    _, _, mc = step(m_cpu, opt.init(dict(m_cpu.named_parameters())), {"tokens": toks}, 0)
    _, _, mg = step(m_gpu, opt.init(dict(m_gpu.named_parameters())), {"tokens": toks.to(cuda)}, 0)
    forward = cfg.n_layers * (1 if remat == "none" else 2)  # remat recomputes the forward
    assert (ops.attention_launches, ops.attention_bwd_launches) == (forward, cfg.n_layers)
    for key in ("loss", "xent", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-4, atol=1e-6)
    for (name, pg), pc in zip(m_gpu.named_parameters(), m_cpu.parameters()):
        bar = 1e-4 * float(pc.abs().max())
        assert float((pg.detach().cpu() - pc.detach()).abs().max()) <= bar, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_fn_counts_one_wgmma_backward_in_half(cuda, monkeypatch, dtype):
    """In bf16 and fp16 both passes run on the tensor cores: one wgmma forward
    and one wgmma backward, with the gradients of the plain version."""
    for name in BWD_COUNTERS:
        monkeypatch.setattr(ops, name, 0)
    q, k, v = (t.requires_grad_(True) for t in _qkv(cuda, 1, 8, 2, 200, 200, 128, dtype, seed=8))
    do = torch.randn_like(q)
    got = torch.autograd.grad(ops.attention(q, k, v, causal=True, window=0), (q, k, v), do)
    assert {n: getattr(ops, n) for n in BWD_COUNTERS} == dict(
        attention_launches=1, attention_wgmma_launches=1, attention_fma_launches=0,
        attention_bwd_launches=1, attention_bwd_wgmma_launches=1, attention_bwd_fma_launches=0)
    for g, want in zip(got, _plain_grads(q.detach(), k.detach(), v.detach(), do, True, 0)):
        assert g.dtype == dtype
        err = float((g.float() - want).abs().max())
        assert err <= TOL[dtype] * float(want.abs().max()), err


# ---------------------------------------------------------------------------
# The planner's device path: pricing and chains against the NumPy oracles
# ---------------------------------------------------------------------------

PLAN_HW = HardwareSpec(link_bandwidth=12.5e9, degree=4)


@pytest.mark.parametrize("n,degraded", [(16, False), (16, True), (64, False)])
def test_planner_pricing_on_card(cuda, n, degraded):
    """Within TORCH_EQUIV_RTOL of the NumPy evaluator and bitwise repeatable."""
    topo = topology_finder(default_strategy(wl.DLRM).demand(wl.DLRM, n), PLAN_HW.degree)
    if degraded:
        topo = remove_pair(topo, (0, 1))
    demands = []
    for j, job in enumerate(wl.PAPER_JOBS.values()):
        demands += [s.demand(job, n) for s in pt.strategy_pool(job, n, 6, seed=j)]
    tev = pt.TorchPlanEvaluator(topo, PLAN_HW, cuda)
    got = tev.comm_times(demands)
    want = np.array([plan_evaluator(topo, PLAN_HW).comm_time(d) for d in demands])
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert float(rel.max()) <= pt.TORCH_EQUIV_RTOL
    assert np.array_equal(tev.comm_times(demands), got)


@pytest.mark.parametrize("objective", ["union", "decomposed"])
@pytest.mark.parametrize("latency", [0.0, 3e-3])
def test_planner_flat_chains_on_card(cuda, objective, latency):
    rs = np.random.RandomState(7)
    T, S, L, K, iters = 4, 16, 96, 8, 100
    V = rs.rand(T, S, L) * 1e9
    V[V < 0.4e9] = 0.0
    caps, comps, w = rs.rand(L) * 12.5e9 + 1e9, rs.rand(T) * 0.01, rs.rand(T) * 2 + 0.25
    steps = rs.randint(1, 9, size=(T, S)).astype(np.float64)
    kw = dict(steps=steps, alpha=latency)
    t_idx, s_idx, u = pt.draw_proposal_streams(3, K, iters, T, S)
    temps, init = np.linspace(0.05, 0.5, K), np.zeros(T, dtype=np.int64)
    kern = pt.TorchChainKernel(V, caps, comps, w, overlap=0.3, objective=objective,
                               device=cuda, **kw)
    got = kern.run(init, temps, t_idx, s_idx, u)
    ref = pt.run_chains_reference(V, caps, comps, w, 0.3, objective, init, temps,
                                  t_idx, s_idx, u, **kw)
    assert np.array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-12)
    again = kern.run(init, temps, t_idx, s_idx, u)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("objective", ["union", "decomposed"])
@pytest.mark.parametrize("ladder", [(0.1,), (0.05, 0.1, 0.3), (0.05, 0.1, 0.2, 0.4)])
def test_planner_grid_chains_on_card(cuda, objective, ladder):
    rs = np.random.RandomState(11)
    C, T, S, L, K, iters = 3, 3, 16, 64, 4, 60
    V = rs.rand(C, T, S, L) * 1e9
    V[V < 0.4e9] = 0.0
    V[..., L - 8:] = 0.0  # dummy padded links
    caps = rs.rand(C, L) * 12.5e9 + 1e9
    comps, w = rs.rand(T) * 0.01, rs.rand(T) * 2 + 0.25
    M = len(ladder)
    t_idx, s_idx, u = pt.draw_grid_streams(5, C, K, M, iters, T, S)
    su = pt.draw_swap_streams(5, C, K, M, iters)
    init = rs.randint(0, S, size=(C, T))
    kern = pt.TorchChainKernel(V, caps, comps, w, overlap=0.2, objective=objective,
                               device=cuda)
    got = kern.run_grid(init, np.array(ladder), t_idx, s_idx, u, su)
    ref = pt.run_grid_reference(V, caps, comps, w, 0.2, objective, init, np.array(ladder),
                                t_idx, s_idx, u, su)
    assert np.array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-12)
    again = kern.run_grid(init, np.array(ladder), t_idx, s_idx, u, su)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


def test_planner_first_argmin_ties_on_card(cuda):
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5] * 4, [2.0, 2.0, 1.0, 1.0]],
                     dtype=torch.float64, device=cuda)
    assert pt.first_argmin(x, dim=1).tolist() == [1, 0, 2]
